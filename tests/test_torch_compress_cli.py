"""The compression CLI and its files crossing packages (moved from
``test_torch_compress_files.py``, whose helpers they use)."""

import filecmp
import math
import os

import numpy as np
import torch
from test_torch_compress import ATTRS, _model_dir, _render

from mvs_gaussian_splatting_tpu.cli import compress as jcli
from mvs_gaussian_splatting_tpu_torch.cli import compress as tcli
from mvs_gaussian_splatting_tpu_torch.models.ply import load_gaussian_ply

torch.set_num_threads(1)


def test_cli_round_trip(tmp_path):
    """PLY → codebook npz → dequantized PLY through the port's CLI on the
    CPU: uint16 codes, exact raw attributes, and a render of the
    dequantized model above 25 dB against the original's."""
    model, g = _model_dir(str(tmp_path / "model"))
    npz = tcli.main(["-m", model, "--num_codes", "64", "--sh_degree", "1",
                     "--device", "cpu"])
    assert npz == os.path.join(model, "point_cloud", "iteration_50",
                               "point_cloud_compressed.npz")
    data = np.load(npz)
    assert data["codes/f_rest"].dtype == np.uint16
    assert data["codebooks/scaling"].shape == (64, 3)
    assert data["shape/f_rest"].dtype == np.int64
    np.testing.assert_array_equal(data["raw/xyz"], g["xyz"])
    dq_path = tcli.main(["-m", model, "--decompress", "--sh_degree", "1"])
    dq = load_gaussian_ply(dq_path, max_sh_degree=1)
    for k in ("xyz", "f_dc", "opacity"):
        np.testing.assert_array_equal(dq[k], g[k])
    for attr in ATTRS:
        np.testing.assert_array_equal(
            dq[attr], data[f"codebooks/{attr}"][data[f"codes/{attr}"]
                                                .astype(np.int64)].reshape(
                g[attr].shape))
    assert np.abs(dq["scaling"] - g["scaling"]).mean() < 0.25
    mse = float(np.mean((_render(g) - _render(dq)) ** 2))
    assert -10 * math.log10(mse + 1e-12) > 25.0


def test_npz_crosses_packages(tmp_path):
    """Each package decompresses the other's ``.npz`` into a PLY
    byte-equal to the one its author writes from the same file."""
    for author, other in ((jcli, tcli), (tcli, jcli)):
        name = "j" if author is jcli else "t"
        model, _ = _model_dir(str(tmp_path / name), seed=1)
        argv = ["-m", model, "--num_codes", "32", "--sh_degree", "1"]
        author.main(argv + (["--device", "cpu"] if author is tcli else []))
        npz = os.path.join(model, "point_cloud", "iteration_50",
                           "point_cloud_compressed.npz")
        own = author.decompress(npz)
        kept = own + ".own"
        os.replace(own, kept)
        cross = other.decompress(npz)
        assert filecmp.cmp(kept, cross, shallow=False), name
