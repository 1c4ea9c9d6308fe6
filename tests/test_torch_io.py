"""The port's loaders, cameras and render CLI held against the JAX package.

The PLY loader reads the retained ``runs/specfinal`` model exactly as the
JAX package's does; the two render CLIs, run on one tiny synthetic COLMAP
scene and one random-Gaussian PLY, write PNGs within 1/255 of each other
(the JAX CLI composites on its padded CPU backend, the port on its stream
path's plain version).
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mvs_gaussian_splatting_tpu.data import cameras as jcams
from mvs_gaussian_splatting_tpu.data import colmap as jcolmap
from mvs_gaussian_splatting_tpu.models import ply as jply
from mvs_gaussian_splatting_tpu.train import config as jconfig
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu_torch.cli import render as tcli
from mvs_gaussian_splatting_tpu_torch.data import cameras as tcams
from mvs_gaussian_splatting_tpu_torch.models import ply as tply
from mvs_gaussian_splatting_tpu_torch.train import config as tconfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECFINAL = os.path.join(ROOT, "runs", "specfinal", "model")
W, H = 64, 48


class TestLoaders:
    def test_specfinal_ply_matches_jax_loader(self):
        path = os.path.join(SPECFINAL, "point_cloud_final.ply.gz")
        a = tply.load_gaussian_ply(path, max_sh_degree=3)
        b = jply.load_gaussian_ply(path, max_sh_degree=3)
        assert sorted(a) == sorted(b)
        assert a["xyz"].shape == (115_320, 3)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        p = tcli.params_from_ply(path, 3, device="cpu")
        assert p.f_rest.shape == (115_320, 15, 3)
        np.testing.assert_array_equal(p.opacity.numpy(), b["opacity"])

    @pytest.mark.parametrize("suffix", [".ply", ".ply.gz"])
    def test_ply_round_trip_exact(self, tmp_path, suffix):
        rng = np.random.RandomState(0)
        n = 57
        g = {"xyz": rng.randn(n, 3), "f_dc": rng.randn(n, 1, 3),
             "f_rest": rng.randn(n, 15, 3), "opacity": rng.randn(n, 1),
             "scaling": rng.randn(n, 3), "rotation": rng.randn(n, 4)}
        g = {k: v.astype(np.float32) for k, v in g.items()}
        path = str(tmp_path / f"m{suffix}")
        tply.save_gaussian_ply(path, g)
        back = tply.load_gaussian_ply(path)
        ref = jply.load_gaussian_ply(path)
        for k in g:
            np.testing.assert_array_equal(back[k], g[k], err_msg=k)
            np.testing.assert_array_equal(ref[k], g[k], err_msg=k)

    def test_cameras_json_inverts(self):
        with open(os.path.join(SPECFINAL, "cameras.json")) as f:
            entries = json.load(f)
        for e in entries[:5]:
            cam = tcams.camera_from_json(e)
            again = tcams.camera_to_json(e["id"], cam)
            for k in ("width", "height", "img_name"):
                assert again[k] == e[k]
            for k in ("position", "rotation", "fx", "fy"):
                np.testing.assert_allclose(again[k], e[k], rtol=1e-9,
                                           atol=1e-9, err_msg=k)
            jcam = jcams.Camera(uid=0, colmap_id=0, R=cam.R, T=cam.T,
                                fovx=cam.fovx, fovy=cam.fovy, image=None,
                                image_name="", width=cam.width,
                                height=cam.height)
            np.testing.assert_array_equal(cam.full_proj, jcam.full_proj)
            v = cam.view("cpu")
            np.testing.assert_array_equal(v.viewmatrix.numpy(),
                                          np.asarray(jcam.view().viewmatrix))
            assert float(v.tanfovx) == float(jcam.view().tanfovx)

    def test_config_copies_agree(self, tmp_path):
        cfg = tconfig.ModelConfig(sh_degree=2, source_path="s",
                                  model_path=str(tmp_path), eval=True)
        tconfig.save_cfg_args(str(tmp_path), cfg)
        assert jconfig.load_cfg_args(str(tmp_path)).__dict__ == cfg.__dict__
        assert (tconfig.PipelineConfig().__dict__
                == jconfig.PipelineConfig().__dict__)


def _look_at(eye):
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """A 9-view synthetic COLMAP scene and a random 60-Gaussian model dir
    (cfg_args.json + point_cloud/iteration_7/point_cloud.ply)."""
    d = tmp_path_factory.mktemp("torch_cli")
    scene = d / "scene"
    os.makedirs(scene / "sparse/0")
    os.makedirs(scene / "images")
    rng = np.random.RandomState(11)
    fovx = math.radians(60.0)
    focal = graphics.fov2focal(fovx, W)
    cams = {1: jcolmap.CameraIntrinsics(
        1, "PINHOLE", W, H, np.array([focal, focal, W / 2, H / 2]))}
    images = {}
    for v in range(9):
        ang = 2 * math.pi * v / 9
        eye = np.array([4.0 * math.sin(ang), 0.0, -4.0 * math.cos(ang)])
        R = _look_at(eye)
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(scene / "images" / f"r_{v}.png")
        images[v + 1] = jcolmap.ImageExtrinsics(
            v + 1, jcolmap.rotmat2qvec(R), -R @ eye, 1, f"r_{v}.png")
    jcolmap.write_cameras_binary(cams, str(scene / "sparse/0/cameras.bin"))
    jcolmap.write_images_binary(images, str(scene / "sparse/0/images.bin"))
    pts = rng.uniform(-1, 1, (20, 3))
    jcolmap.write_points3d_binary(pts, (rng.rand(20, 3) * 255).astype(
        np.uint8), str(scene / "sparse/0/points3D.bin"))

    model = d / "model"
    n = 60
    g = {"xyz": rng.uniform(-0.9, 0.9, (n, 3)),
         "f_dc": (rng.rand(n, 1, 3) - 0.5) / 0.28209479,
         "f_rest": rng.randn(n, 15, 3) * 0.15,
         "opacity": rng.uniform(-1, 3, (n, 1)),
         "scaling": np.log(rng.uniform(0.05, 0.35, (n, 3))),
         "rotation": rng.randn(n, 4)}
    jply.save_gaussian_ply(
        str(model / "point_cloud/iteration_7/point_cloud.ply"),
        {k: v.astype(np.float32) for k, v in g.items()})
    jconfig.save_cfg_args(str(model), jconfig.ModelConfig(
        sh_degree=3, source_path=str(scene), model_path=str(model),
        eval=True))
    return model
