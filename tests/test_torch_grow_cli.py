"""The training CLI with grow flags (moved from
``test_torch_grow_augment.py``)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("flags", [
    ["--grow_dir"],
    ["--continous_dir", "--grow_distance", "--learn_split_distance",
     "--learn_split_scale"],
], ids=["discrete", "continuous_learned_split"])
def test_cli_trains_grow_mode(tmp_path, flags):
    """``cli/train.py`` trains in grow mode on the CPU: speculative steps
    from past the first opacity reset (10), grow rounds at 20, parameters
    and losses finite, the research extras in the checkpoint."""
    from test_torch_train import write_synthetic_scene

    from mvs_gaussian_splatting_tpu_torch.cli.train import main
    from mvs_gaussian_splatting_tpu_torch.train import checkpoint as tckpt
    scene = write_synthetic_scene(tmp_path, 60)
    model = tmp_path / "model"
    params, aux, _, hist = main([
        "-s", scene, "-m", str(model), "--device", "cpu", "--iterations",
        "22", "--densify_from_iter", "5", "--densification_interval", "10",
        "--opacity_reset_interval", "10", "--test_iterations", "0",
        "--checkpoint_iterations", "22", "--log_every", "2", "--tile_w", "32",
        "--tile_h", "16", "--spec_capacity", "32", *flags])
    losses = [v for _, v in hist["loss"]]
    assert len(losses) == 11 and all(np.isfinite(losses))
    rounds = {d["iteration"]: d for d in hist["densify"]}
    assert rounds[20]["n_cloned"] > 0           # a grow round committed
    assert all(bool(torch.isfinite(a).all()) for a in params if a is not None)
    loaded = tckpt.load_checkpoint(str(model / "chkpnt22.npz"), "cpu")[0]
    extras = {"--grow_dir": "dirs_prob", "--continous_dir": "conti_dirs",
              "--grow_distance": "grow_dist",
              "--learn_split_distance": "split_distance",
              "--learn_split_scale": "split_scale"}
    for flag, name in extras.items():
        assert (getattr(loaded, name) is not None) == (flag in flags), name
