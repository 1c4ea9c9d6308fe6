"""The port's training loop held against the JAX package's loop, step by
step, on one small scene.

A synthetic COLMAP scene (64×48, 9 views; 7 train and 2 test under
``--eval``) and a checkpoint at iteration 24,988 go through both packages'
``train/loop.py:train`` for 12 iterations. The checkpoint holds the scene's
own Gaussians moved by seeded noise, with alive holes, SH degree 3 active,
and zero Adam moments: the state the on-card resume run of
``chip_smoke.py`` starts from, cut to size. The run renders the 1024-row
prefix of a 2048-row capacity and takes the late position learning rate,
and densifies nothing (past ``densify_until_iter``). Both loops draw their
cameras from Python's ``random`` seeded alike, so they see the same views
in the same order; the losses of every step, the test PSNR of two evals
and the final state are compared. The JAX loop takes its stream path
through the Pallas kernels in interpret mode.
"""

import functools
import importlib
import math

import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.train import config as jconfig
from mvs_gaussian_splatting_tpu.train import loop as jloop
from mvs_gaussian_splatting_tpu_torch.data.cameras import Camera
from mvs_gaussian_splatting_tpu_torch.data.colmap import write_pinhole_scene
from mvs_gaussian_splatting_tpu_torch.models.gaussians import (GaussianAux,
                                                               GaussianParams)
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
    rasterize_reference
from mvs_gaussian_splatting_tpu_torch.train import config as tconfig
from mvs_gaussian_splatting_tpu_torch.train import loop as tloop
from mvs_gaussian_splatting_tpu_torch.train.checkpoint import save_checkpoint
from mvs_gaussian_splatting_tpu_torch.train.optim import adam_init
from mvs_gaussian_splatting_tpu_torch.utils import graphics

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")

W, H = 64, 48
START, STEPS = 24_988, 12
EVALS = [START + 4, START + STEPS]
N_TRUE, CAPACITY = 150, 2048


def _pose(angle, radius=4.0):
    eye = np.array([radius * math.sin(angle), 0.0, -radius * math.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd])
    return r_w2c.T, -r_w2c @ eye


@pytest.fixture(scope="module")
def resume_inputs(tmp_path_factory):
    """The scene on disk and the checkpoint the two loops resume."""
    tmp = tmp_path_factory.mktemp("loop")
    rng = np.random.RandomState(21)
    means = rng.uniform(-0.8, 0.8, (N_TRUE, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.2, (N_TRUE, 3)).astype(np.float32)
    quats = rng.randn(N_TRUE, 4).astype(np.float32)
    opac = rng.uniform(0.5, 0.95, N_TRUE).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (N_TRUE, 3)).astype(np.float32)
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    cams, imgs = [], []
    for v in range(9):
        R, T = _pose(2 * math.pi * v / 9)
        cam = Camera(uid=v, colmap_id=v, R=R, T=T, fovx=fovx, fovy=fovy,
                     image=None, image_name=f"v{v:02d}", width=W, height=H)
        with torch.no_grad():
            pre = preprocess(torch.tensor(means), torch.tensor(opac),
                             cam.view("cpu"), W, H,
                             scales=torch.tensor(scales),
                             rotations=torch.tensor(quats),
                             colors_precomp=torch.tensor(cols))
            img = rasterize_reference(pre, W, H, torch.zeros(3)).numpy()
        cams.append(cam)
        imgs.append((np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(
            np.uint8))
    write_pinhole_scene(str(tmp / "scene"), cams, imgs, means,
                        np.full((N_TRUE, 3), 128, np.uint8))

    # the truth moved by noise, scattered over the first 600 of 2048 slots
    slots = np.sort(rng.choice(600, N_TRUE, replace=False))
    p = {"xyz": np.zeros((CAPACITY, 3)), "f_dc": np.zeros((CAPACITY, 1, 3)),
         "f_rest": np.zeros((CAPACITY, 15, 3)),
         "scaling": np.full((CAPACITY, 3), -5.0),
         "rotation": np.tile([1.0, 0, 0, 0], (CAPACITY, 1)),
         "opacity": np.full((CAPACITY, 1), -5.0)}
    p["xyz"][slots] = means + rng.randn(N_TRUE, 3) * 0.03
    p["f_dc"][slots, 0] = (cols - 0.5) / 0.28209479177387814 \
        + rng.randn(N_TRUE, 3) * 0.2
    p["f_rest"][slots] = rng.randn(N_TRUE, 15, 3) * 0.05
    p["scaling"][slots] = np.log(scales) + rng.randn(N_TRUE, 3) * 0.1
    p["rotation"][slots] = quats
    p["opacity"][slots, 0] = np.log(opac / (1 - opac))
    params = GaussianParams(**{k: torch.tensor(v, dtype=torch.float32)
                               for k, v in p.items()})
    alive = torch.zeros(CAPACITY, dtype=torch.bool)
    alive[torch.from_numpy(slots)] = True
    z = torch.zeros(CAPACITY)
    aux = GaussianAux(alive=alive, max_radii2d=z, xyz_grad_accum=z, denom=z)
    ckpt = str(tmp / f"chkpnt{START}.npz")
    save_checkpoint(ckpt, params, adam_init(params), aux, START, 3)
    return str(tmp / "scene"), ckpt


def _configs(pkg, scene, ckpt):
    return (pkg.ModelConfig(source_path=scene, eval=True),
            pkg.OptimizationConfig(iterations=START + STEPS),
            pkg.PipelineConfig(backend="stream", fast_math=False, tile_w=32,
                               tile_h=16),
            pkg.TrainRunConfig(test_iterations=list(EVALS),
                               save_iterations=[], start_checkpoint=ckpt,
                               log_every=1, seed=4))


def test_resume_trajectory_matches_jax(resume_inputs, monkeypatch):
    scene, ckpt = resume_inputs
    monkeypatch.setattr(jrast, "_rasterize_stream", functools.partial(
        jrast._rasterize_stream, interpret=True))
    jparams, jaux, _, jhist = jloop.train(
        *_configs(jconfig, scene, ckpt), log_fn=lambda s: None)
    tparams, taux, _, thist = tloop.train(
        *_configs(tconfig, scene, ckpt), log_fn=lambda s: None, device="cpu")

    jloss = np.array([v for _, v in jhist["loss"]])
    tloss = np.array([v for _, v in thist["loss"]])
    assert [i for i, _ in thist["loss"]] == [i for i, _ in jhist["loss"]]
    assert len(tloss) == STEPS and np.all(np.isfinite(tloss))
    # every step's loss within 1e-6 (measured: ≤ 2.3e-7): the two states
    # drift apart only by float rounding through Adam
    gaps = np.abs(tloss - jloss)
    assert np.all(gaps <= 1e-6), gaps
    # the test PSNR of each eval within 1e-4 dB (measured: ≤ 2e-6)
    assert sorted(thist["psnr_test"]) == sorted(jhist["psnr_test"]) == EVALS
    for it in EVALS:
        assert abs(thist["psnr_test"][it] - jhist["psnr_test"][it]) <= 1e-4
    # the final state: the same alive rows, parameters within 2e-5 of each
    # leaf's scale (measured: ≤ 2.4e-6, opacity)
    np.testing.assert_array_equal(taux.alive.numpy(), np.asarray(jaux.alive))
    alive = taux.alive.numpy()
    for k in ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"):
        want = np.asarray(getattr(jparams, k))[alive]
        got = getattr(tparams, k).numpy()[alive]
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert gap <= 2e-5, (k, gap)
