"""The port's flagship dataset builder held against the JAX package's
script (``scripts/ref_scale_validation.py``).

The ground truth and the orbit cameras are numpy in both and must be
equal; the dataset written at the script's ``--smoke`` size (160×120,
3,000 GT points, 500 init points; the specular style) with 16×16 tiles on
the CPU, where the script takes the JAX package's ``jnp`` backend, through
the port's ``write_dataset`` on the same backend: the COLMAP binaries
byte-equal, the PNGs within 1 LSB (the images are truncated to uint8, so a
value within float rounding of an integer may land on either side). The
orbit has 6 views, not the smoke run's 12: the port's ``jnp`` backend
composites every one of a tile's 1,024 slots, about 1.7 s a view on one
CPU thread, and 12 views would take the file past 30 s.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mvs_gaussian_splatting_tpu_torch import ref_scale_validation as tval

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jval():
    spec = importlib.util.spec_from_file_location(
        "jax_ref_scale_validation",
        os.path.join(ROOT, "scripts", "ref_scale_validation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("style", ["speckle", "clean", "specular"])
def test_gt_scene_and_cameras_equal(jval, style):
    want = jval.build_gt_scene(4000, seed=3, style=style)
    got = tval.build_gt_scene(4000, seed=3, style=style)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for jc, tc in zip(jval.orbit_cameras(24, 1237, 822, 65.0, seed=1),
                      tval.orbit_cameras(24, 1237, 822, 65.0, seed=1)):
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)


def test_write_dataset_matches_jax(jval, tmp_path):
    kw = dict(width=160, height=120, n_views=6, n_gt=3000, n_init=500,
              seed=0, log=lambda s: None, style="specular")
    jval.write_dataset(str(tmp_path / "jax"), **kw)
    out = tval.write_dataset(str(tmp_path / "port"), **kw, tile_w=16,
                             tile_h=16, backend="jnp", device="cpu")
    assert out["seconds"] > 0
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        want = (tmp_path / "jax" / "sparse" / "0" / name).read_bytes()
        got = (tmp_path / "port" / "sparse" / "0" / name).read_bytes()
        assert got == want, name
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images"))
    assert len(names) == 6
    worst = 0
    for name in names:
        want = np.asarray(Image.open(tmp_path / "jax" / "images" / name),
                          np.int16)
        got = np.asarray(Image.open(tmp_path / "port" / "images" / name),
                         np.int16)
        assert got.shape == want.shape == (120, 160, 3)
        worst = max(worst, int(np.abs(got - want).max()))
    assert worst <= 1, worst
