"""The padded composites' autograd on the CPU and the padded backend's CLI
(moved from ``test_torch_padded_composite.py``, whose helpers they
use)."""

import numpy as np
import torch
from test_torch_padded import TILES_X, tables

from mvs_gaussian_splatting_tpu_torch.ops import composite as tcomp

torch.set_num_threads(1)


class TestPaddedComposite:
    def test_autograd_takes_plain_versions_on_cpu(self):
        planes, rgb, valid, counts = tables(4)
        tp = torch.from_numpy(np.stack(planes)).requires_grad_()
        trgb = torch.from_numpy(rgb).requires_grad_()
        before = (tcomp.launches, tcomp.bwd_launches)
        out, tfin = tcomp.composite_padded(
            tp, trgb, torch.from_numpy(valid), torch.from_numpy(counts),
            torch.tensor([0.1, 0.2, 0.3]), TILES_X, 16, 16)
        (out.sum() + tfin.sum()).backward()
        assert (tcomp.launches, tcomp.bwd_launches) == before
        assert float(tp.grad[0].abs().max()) > 0
        assert float(trgb.grad.abs().max()) > 0


def test_cli_train_and_render_pallas_backend(tmp_path):
    """A short ``cli/train.py --backend pallas --device cpu`` run (finite
    losses and parameters), then ``cli/render.py --backend pallas`` of its
    test view, equal to the stream backend's render of the same model."""
    from PIL import Image

    from mvs_gaussian_splatting_tpu_torch.cli.render import \
        main as render_main
    from mvs_gaussian_splatting_tpu_torch.cli.train import main
    from test_torch_train import write_synthetic_scene

    scene = write_synthetic_scene(tmp_path)
    model = tmp_path / "model"
    params, aux, _, hist = main([
        "-s", scene, "-m", str(model), "--eval",
        "--backend", "pallas", "--device", "cpu", "--iterations", "6",
        "--test_iterations", "6", "--save_iterations", "6",
        "--log_every", "2", "--max_tiles_per_gaussian", "32",
        "--tile_capacity", "128"])
    losses = [v for _, v in hist["loss"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(bool(torch.isfinite(a).all()) for a in params
               if a is not None)
    assert "6" in {str(k) for k in hist["psnr_test"]}
    pngs = {}
    for backend in ("pallas", "stream"):
        clipped = render_main(["-m", str(model), "-s", scene, "--skip_train",
                               "--device", "cpu", "--backend", backend,
                               "--tile_capacity", "256"])
        assert clipped == {"test": {"views": 2, "overflow_tiles": 0,
                                    "overflow_capacity": 0}}
        out = model / "test" / "ours_6" / "renders" / "00000.png"
        pngs[backend] = np.asarray(Image.open(out), np.int16)
    assert np.abs(pngs["pallas"] - pngs["stream"]).max() <= 1
