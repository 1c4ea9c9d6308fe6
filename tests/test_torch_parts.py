"""Tiles of more than 1,024 pixels, which the port's kernels walk as parts
(``ops/stream.py:tile_parts``), held against the JAX package on the CPU.

The JAX package takes any tile shape; its ``backend="jnp"`` compositor is
the reference here (its Pallas kernels are not run at these shapes). A
random scene of 300 Gaussians, made from a numpy seed, is rendered at
128×96 with 64×32 tiles (two 32×32 parts a tile) and 48×48 tiles (four
parts, three cut at the edges) through the port's ``render`` on the CPU,
where the stream composite (exact and fast-math) and the padded composite
take their plain versions, and through the JAX package's ``render`` with
``backend="jnp"``, jitted whole. The budget is flat and wide enough that
neither clips.

The image depends on the tile shape in the JAX package itself: a splat's
tile footprint is its alpha >= 1/255 box cut to its 3-sigma square in
whole tiles, so larger tiles let it reach pixels past 3 sigma (the CUDA
rasterizer's getRect semantics). ``test_tile_shape_is_part_of_the_operator``
shows that difference in the reference and the port alike.

Tolerances: image and final_T within 2e-4 max abs (the bound the JAX
package's kernels are held to against CPU f32) and every parameter's
gradient within 1e-5 of its largest magnitude in exact mode (the two take
their sums over pixels and instances in other orders); in fast-math mode
the JAX package's fast-mode contract (``tests/test_fast_math.py``): 2e-3
max abs on the image and final_T, 5e-3 of each gradient's largest
magnitude.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models.gaussians import \
    GaussianParams as JParams
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView as JCamera
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
    params_from_numpy
from mvs_gaussian_splatting_tpu_torch.ops import composite as tcomp
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

W, H = 128, 96
N = 300
TOL, REL = 2e-4, 1e-5
FAST_TOL, FAST_REL = 2e-3, 5e-3


def config(tile_w: int, tile_h: int) -> dict:
    """A flat budget of every tile of the image (no splat is clipped), room
    for N entries in every tile and a stream slot for every instance
    (rounded up to the stream's 128-column chunks)."""
    tiles = -(-W // tile_w) * -(-H // tile_h)
    return dict(tile_w=tile_w, tile_h=tile_h, max_tiles_per_gaussian=tiles,
                tile_capacity=512, tile_batch=2, tier_budgets=(),
                tier_fracs=(), instance_cap=-(-N * tiles // 128) * 128)


def rel_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


def scene():
    """A random model seen by one camera (numpy, then each package's
    camera), and the loss weights."""
    rng = np.random.RandomState(12)
    z = rng.uniform(2, 6, N)
    f = np.float32
    model = {
        "xyz": np.stack([rng.uniform(-0.8, 0.8, N) * z,
                         rng.uniform(-0.6, 0.6, N) * z, z], -1).astype(f),
        "f_dc": ((rng.uniform(0, 1, (N, 1, 3)) - 0.5) / 0.28209479).astype(f),
        "f_rest": (rng.randn(N, 15, 3) * 0.2).astype(f),
        "scaling": np.log(rng.uniform(0.03, 0.25, (N, 3))).astype(f),
        "rotation": rng.randn(N, 4).astype(f),
        "opacity": rng.uniform(-2.0, 3.0, (N, 1)).astype(f),
    }
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.05, -0.05, 0.1]
    full = (proj @ view).astype(np.float32)
    center = np.linalg.inv(view)[:3, 3].astype(np.float32)
    tan = (np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))
    jcam = JCamera(jnp.asarray(view), jnp.asarray(full), jnp.asarray(center),
                   *tan)
    tcam = CameraView(torch.tensor(view), torch.tensor(full),
                      torch.tensor(center), *(torch.tensor(v) for v in tan))
    weights = (rng.randn(3, H, W).astype(f), rng.randn(H, W).astype(f))
    return model, jcam, tcam, weights


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_render_grads(jp, jcam, bg, w_img, w_t, *, cfg):
    def loss(p):
        out = jrender_mod.render(jcam, W, H, p, bg, sh_degree=3,
                                 raster_config=cfg)
        return ((out["render"] * w_img).sum() + (out["final_T"] * w_t).sum(),
                (out["render"], out["final_T"], out["overflow_tiles"],
                 out["overflow_capacity"]))
    return jax.grad(loss, has_aux=True)(jp)


@functools.lru_cache(maxsize=None)
def jax_reference(tile_w: int, tile_h: int):
    """The JAX package's jnp render at ``tile_w`` × ``tile_h``: (gradients
    by parameter, image, final_T) as numpy."""
    model, jcam, _, (w_img, w_t) = scene()
    cfg = jrast.RasterConfig(backend="jnp", **config(tile_w, tile_h))
    grads, (img, tfin, ov_t, ov_c) = _jax_render_grads(
        JParams(**{k: jnp.asarray(v) for k, v in model.items()}), jcam,
        jnp.asarray([0.1, 0.2, 0.3], jnp.float32), jnp.asarray(w_img),
        jnp.asarray(w_t), cfg=cfg)
    assert int(ov_t) == 0 and int(ov_c) == 0
    return ({k: np.asarray(getattr(grads, k)) for k in model},
            np.asarray(img), np.asarray(tfin))


# the tile shapes; the second, 48×48, runs in test_torch_parts_48.py
GEOMETRIES = [pytest.param((64, 32), id="geometry0"),
              pytest.param((48, 48), id="geometry1")]
MODES = ["stream", "stream_fast", "pallas"]


def check_large_tiles(geometry, mode):
    """Image, final_T and every parameter's gradient of a render through
    the port's composites at a tile of several parts against the JAX
    package's jnp render of the same tiles; the CPU launches no kernel."""
    tw, th = geometry
    assert tstream.tile_parts(tw, th)[2:] != (1, 1)
    grads_j, img_j, tfin_j = jax_reference(tw, th)
    model, _, tcam, (w_img, w_t) = scene()
    tp = params_from_numpy(model, "cpu")
    tp = type(tp)(*[None if a is None else a.requires_grad_() for a in tp])
    cfg = RasterConfig(backend="pallas" if mode == "pallas" else "stream",
                       fast_math=mode == "stream_fast", **config(tw, th))
    before = (tstream.launches, tstream.bwd_launches, tstream.fast_launches,
              tstream.fast_bwd_launches, tcomp.launches, tcomp.bwd_launches)
    out = render(tcam, W, H, tp, torch.tensor([0.1, 0.2, 0.3]), sh_degree=3,
                 raster_config=cfg)
    loss = ((out["render"] * torch.from_numpy(w_img)).sum()
            + (out["final_T"] * torch.from_numpy(w_t)).sum())
    loss.backward()
    assert (tstream.launches, tstream.bwd_launches, tstream.fast_launches,
            tstream.fast_bwd_launches, tcomp.launches,
            tcomp.bwd_launches) == before
    assert int(out["overflow_tiles"]) == 0
    assert int(out["overflow_capacity"]) == 0
    gap = max(float(np.abs(out["render"].detach().numpy() - img_j).max()),
              float(np.abs(out["final_T"].detach().numpy() - tfin_j).max()))
    gaps = {k: rel_gap(getattr(tp, k).grad.numpy(), grads_j[k])
            for k in model}
    print(f"{tw}x{th} {mode}: image {gap:.1e}; grads " + ", ".join(
        f"{k} {v:.1e}" for k, v in gaps.items()))
    tol, rel = ((FAST_TOL, FAST_REL) if mode == "stream_fast"
                else (TOL, REL))
    assert gap <= tol and max(gaps.values()) <= rel


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("geometry", GEOMETRIES[:1])
def test_render_at_large_tiles_matches_jax(geometry, mode):
    check_large_tiles(geometry, mode)
