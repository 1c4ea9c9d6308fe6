"""The port's padded-table backends (``RasterConfig.backend`` ``"pallas"``
and ``"jnp"``) held against the JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
JAX package's padded kernels (B4 ``composite.py:_fwd_kernel``, B5
``_bwd_kernel``) run in interpret mode through ``composite_pallas`` /
``composite_tiles_pallas``, as its own ``tests/test_pallas_composite.py``
runs them: its ``rasterize(backend="pallas")`` cannot be reached on the CPU
(it passes no ``interpret``), so the end-to-end image and gradients are
held against ``rasterize(backend="jnp")``. JAX references are jitted whole.

Tolerances: images and final_T within 2e-4 max abs (the bound the JAX
package's kernels are held to against CPU f32); gradients within 2e-5 of
each leaf's largest magnitude (``tests/test_torch_grad.py``); padded and
invalid slots' gradients exactly zero.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.ops import binning as jbin
from mvs_gaussian_splatting_tpu.ops.pallas.composite import composite_pallas
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView as JCamera
from mvs_gaussian_splatting_tpu.ops.preprocess import \
    preprocess as jpreprocess
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu_torch.ops import binning as tbin
from mvs_gaussian_splatting_tpu_torch.ops import preprocess as tpre
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

W, H = 64, 48
TILES_X, TILES_Y = W // 16, H // 16
TOL = 2e-4
REL = 2e-5


def rel_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


def cameras():
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    a = 0.1
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                 [-math.sin(a), 0, math.cos(a)]]
    V[:3, 3] = [0.1, -0.05, 0.2]
    full = (P @ V).astype(np.float32)
    center = np.linalg.inv(V)[:3, 3].astype(np.float32)
    tan = (np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))
    return (JCamera(jnp.asarray(V), jnp.asarray(full), jnp.asarray(center),
                    *tan),
            CameraView(torch.tensor(V), torch.tensor(full),
                       torch.tensor(center), *(torch.tensor(v) for v in tan)))


def random_model(n, seed):
    rng = np.random.RandomState(seed)
    z = rng.uniform(2, 6, n)
    f = np.float32
    return {
        "xyz": np.stack([rng.uniform(-0.8, 0.8, n) * z,
                         rng.uniform(-0.6, 0.6, n) * z, z], -1).astype(f),
        "f_dc": ((rng.uniform(0, 1, (n, 1, 3)) - 0.5) / 0.28209479).astype(f),
        "f_rest": (rng.randn(n, 15, 3) * 0.2).astype(f),
        "scaling": np.log(rng.uniform(0.04, 0.3, (n, 3))).astype(f),
        "rotation": rng.randn(n, 4).astype(f),
        "opacity": rng.uniform(-2.0, 3.0, (n, 1)).astype(f),
    }


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_processed(means, w, h, opac, scales, quats, colors, jcam):
    return jpreprocess(means, opac, jcam, w, h, scales=scales,
                       rotations=quats, colors_precomp=colors)


def jax_processed(n, seed):
    """The JAX package's Processed of a random scene; the port bins the
    same (through numpy), so the two binnings see identical inputs."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(2, 6, n)
    means = np.stack([rng.uniform(-0.8, 0.8, n) * z,
                      rng.uniform(-0.6, 0.6, n) * z, z], -1)
    jcam, _ = cameras()
    pj = _jax_processed(
        jnp.asarray(means, jnp.float32), W, H,
        jnp.asarray(rng.uniform(0.3, 0.99, n), jnp.float32),
        jnp.asarray(rng.uniform(0.05, 0.6, (n, 3)), jnp.float32),
        jnp.asarray(rng.randn(n, 4), jnp.float32),
        jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32), jcam)
    pt = tpre.Processed(*(torch.from_numpy(np.array(v)) for v in pj))
    return pj, pt


_jax_bin = jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3, 4))


class TestBinGaussians:
    # block 96: the enumeration runs over blocks of 3 and 24 Gaussians
    @pytest.mark.parametrize("d,cap,block", [(32, 128, None), (4, 16, None),
                                             (32, 128, 96), (4, 16, 96)])
    def test_matches_jax(self, d, cap, block, monkeypatch):
        if block:
            monkeypatch.setattr(tbin, "ENUM_BLOCK", block)
        pj, pt = jax_processed(160, seed=1)
        bj = _jax_bin(pj, TILES_X, TILES_Y, d, cap)
        bt = tbin.bin_gaussians(pt, TILES_X, TILES_Y, d, cap)
        for name in bj._fields:
            np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                          np.asarray(getattr(bj, name)),
                                          err_msg=name)
        assert int(bt.valid.sum()) > 0
        if d == 4:       # the tight layout clips on both counts
            assert int(bt.overflow_tiles) > 0
            assert int(bt.overflow_capacity) > 0
        # padded slots point at Gaussian 0
        assert not bt.gauss_idx[~bt.valid].any()


def tables(seed, k=128, holes=False):
    """Padded tables of a random scene binned by the JAX package: (planes
    list, rgb, valid f32, counts) as numpy. ``holes`` marks every fifth
    slot below each count invalid (counts unchanged)."""
    pj, _ = jax_processed(120, seed)
    b = _jax_bin(pj, TILES_X, TILES_Y, 32, k)
    idx = np.asarray(b.gauss_idx)
    xy, conic = np.asarray(pj.xy)[idx], np.asarray(pj.conic)[idx]
    planes = [xy[..., 0], xy[..., 1], conic[..., 0], conic[..., 1],
              conic[..., 2], np.asarray(pj.opacity)[idx]]
    valid = np.asarray(b.valid).copy()
    counts = np.asarray(b.counts).clip(max=k).astype(np.int32)
    if holes:
        valid[:, ::5] = False
    return ([p.astype(np.float32) for p in planes],
            np.asarray(pj.rgb)[idx].astype(np.float32),
            valid.astype(np.float32), counts)


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_padded_vjp(planes, rgb, valid, counts, bg, k, cts):
    def f(pl, c, b):
        return composite_pallas(pl, c, valid, counts, b, TILES_X, 16, 16, k,
                                True)
    out, pull = jax.vjp(f, tuple(planes), rgb, bg)
    return out, pull(cts)


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def _jax_padded_vjp_tiles(planes, rgb, valid, counts, bg, cts, tiles_x,
                          tile_w, tile_h, k):
    def f(pl, c, b):
        return composite_pallas(pl, c, valid, counts, b, tiles_x, tile_w,
                                tile_h, k, True)
    out, pull = jax.vjp(f, tuple(planes), rgb, bg)
    return out, pull(cts)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_render_grads(jp, ndc, jcam, bg, w_img, w_t, *, cfg):
    def loss(p, off):
        out = jrender_mod.render(jcam, W, H, p, bg, sh_degree=3,
                                 ndc_offset=off, raster_config=cfg)
        return ((out["render"] * w_img).sum() + (out["final_T"] * w_t).sum(),
                (out["render"], out["final_T"]))
    return jax.grad(loss, argnums=(0, 1), has_aux=True)(jp, ndc)
