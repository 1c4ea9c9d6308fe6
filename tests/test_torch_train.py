"""The port's training path held against the JAX package: losses,
schedules, Adam, model state, densification, checkpoints, one train step,
and a short training run through ``cli/train.py`` on the CPU.

Inputs and random draws are made with numpy (or drawn once by JAX) and
handed to both packages. The JAX step takes its stream path through the
Pallas kernels in interpret mode, jitted whole. Tolerances are stated
where they are used.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models import gaussians as jgauss
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView as JCamera
from mvs_gaussian_splatting_tpu.train import optim as joptim
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu.utils import losses as jlosses
from mvs_gaussian_splatting_tpu.utils import schedules as jsched
from mvs_gaussian_splatting_tpu_torch.data.cameras import Camera
from mvs_gaussian_splatting_tpu_torch.data.colmap import write_pinhole_scene
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgauss
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import (CameraView,
                                                             preprocess)
from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
    rasterize_reference
from mvs_gaussian_splatting_tpu_torch.train import optim as toptim
from mvs_gaussian_splatting_tpu_torch.utils import losses as tlosses
from mvs_gaussian_splatting_tpu_torch.utils import schedules as tsched

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def to_np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()
            if v is not None}


def rel_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale if scale else float(
        np.abs(got).max())


@pytest.fixture
def jax_stream_interpret(monkeypatch):
    """The JAX package's rasterize() taking its stream path through the
    Pallas kernels in interpret mode."""
    monkeypatch.setattr(jrast, "_rasterize_stream", functools.partial(
        jrast._rasterize_stream, interpret=True))


class TestLosses:
    def test_ssim_value_and_grad(self):
        rng = np.random.RandomState(0)
        a = rng.rand(3, 40, 52).astype(np.float32)
        b = np.clip(a + 0.1 * rng.randn(3, 40, 52), 0, 1).astype(np.float32)
        val_j, g_j = jax.jit(jax.value_and_grad(jlosses.ssim))(
            jnp.asarray(a), jnp.asarray(b))
        ta = torch.tensor(a, requires_grad=True)
        val_t = tlosses.ssim(ta, torch.tensor(b))
        val_t.backward()
        # the same operator; the blur sums in another order (1e-6 abs)
        assert abs(val_t.item() - float(val_j)) <= 1e-6
        assert float(np.abs(ta.grad.numpy() - np.asarray(g_j)).max()) <= 1e-6
        assert tlosses.psnr(ta, torch.tensor(b))[0].item() == pytest.approx(
            float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))[0]),
            abs=1e-4)

    @pytest.mark.parametrize("step", [-1, 0, 1, 500, 7000, 30000, 40000])
    def test_expon_lr(self, step):
        kw = dict(lr_init=1.6e-4 * 4.2, lr_final=1.6e-6 * 4.2,
                  lr_delay_mult=0.01, max_steps=30000)
        want = float(jsched.expon_lr(step, **kw))
        got = tsched.expon_lr(step, **kw)
        # both evaluate in f32; exp/log may differ in the last bit
        assert got == pytest.approx(want, rel=1e-6)
        assert tsched.expon_lr(step, 0.0, 0.0) == 0.0
        delayed = dict(kw, lr_delay_steps=100)
        assert tsched.expon_lr(step, **delayed) == pytest.approx(
            float(jsched.expon_lr(step, **delayed)), rel=1e-6)


def random_state(n, capacity, seed):
    """numpy (params, mu, nu, aux) dicts: n alive rows in ``capacity``."""
    rng = np.random.RandomState(seed)
    f = np.float32
    p = {"xyz": rng.randn(capacity, 3).astype(f) * 2,
         "f_dc": rng.randn(capacity, 1, 3).astype(f),
         "f_rest": (rng.randn(capacity, 15, 3) * 0.1).astype(f),
         "scaling": rng.uniform(-4, 0, (capacity, 3)).astype(f),
         "rotation": rng.randn(capacity, 4).astype(f),
         "opacity": rng.uniform(-6, 3, (capacity, 1)).astype(f)}
    mu = {k: (rng.randn(*v.shape) * 1e-3).astype(f) for k, v in p.items()}
    nu = {k: (rng.rand(*v.shape) * 1e-5).astype(f) for k, v in p.items()}
    alive = np.zeros(capacity, bool)
    alive[rng.choice(capacity, n, replace=False)] = True
    aux = {"alive": alive,
           "max_radii2d": rng.randint(0, 30, capacity).astype(f),
           "xyz_grad_accum": (rng.rand(capacity) * 4e-3).astype(f),
           "denom": rng.randint(0, 10, capacity).astype(f)}
    return p, mu, nu, aux


def jax_state(p, mu, nu, aux, count=0):
    jp = jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    adam = joptim.AdamState(
        count=jnp.asarray(count, jnp.int32),
        mu=jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}))
    jaux = jgauss.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    return jp, adam, jaux


def torch_state(p, mu, nu, aux, count=0):
    return (tgauss.params_from_numpy(p, "cpu"),
            toptim.adam_from_numpy(count, mu, nu, "cpu"),
            tgauss.aux_from_numpy(aux, "cpu"))


W, H = 64, 48


def _camera(seed=0):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    V = np.eye(4, dtype=np.float32)
    V[:3, 3] = [0.05, -0.02, 0.1]
    full = (P @ V).astype(np.float32)
    c = np.linalg.inv(V)[:3, 3].astype(np.float32)
    tan = (np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))
    return (JCamera(jnp.asarray(V), jnp.asarray(full), jnp.asarray(c), *tan),
            CameraView(torch.tensor(V), torch.tensor(full), torch.tensor(c),
                       *(torch.tensor(v) for v in tan)))


def scene_state(n, capacity, seed):
    """A random state whose alive rows sit in front of the camera."""
    p, mu, nu, aux = random_state(n, capacity, seed)
    rng = np.random.RandomState(seed + 100)
    z = rng.uniform(2, 6, capacity)
    p["xyz"] = np.stack([rng.uniform(-0.8, 0.8, capacity) * z,
                         rng.uniform(-0.6, 0.6, capacity) * z, z],
                        -1).astype(np.float32)
    p["scaling"] = np.log(rng.uniform(0.04, 0.3, (capacity, 3))).astype(
        np.float32)
    p["opacity"] = rng.uniform(-2, 3, (capacity, 1)).astype(np.float32)
    aux["alive"] = np.arange(capacity) < n      # a prefix, as compacted
    return p, mu, nu, aux


def _pose(angle, radius=4.0):
    eye = np.array([radius * math.sin(angle), 0.0, -radius * math.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd])
    return r_w2c.T, -r_w2c @ eye


def write_synthetic_scene(tmp_path, n=120) -> str:
    """A COLMAP scene of ``n`` Gaussians seen from 9 views at 64×48, with
    noisy init points, under ``tmp_path/scene``; returns its path."""
    rng = np.random.RandomState(3)
    means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.2, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
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
    init = means + rng.randn(n, 3).astype(np.float32) * 0.05
    write_pinhole_scene(str(tmp_path / "scene"), cams, imgs, init,
                        np.full((n, 3), 128, np.uint8))
    return str(tmp_path / "scene")
