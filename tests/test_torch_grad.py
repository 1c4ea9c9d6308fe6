"""Gradients of the port's render path held against the JAX package.

Inputs are made from a seed with numpy and handed to both packages. The JAX
package's stream path runs its Pallas kernels (B1 forward, B2 backward) in
interpret mode, as its own tests do, jitted whole; the port runs on the
CPU, where the composite and its backward take their plain versions.

Tolerance: gradients agree within 5e-6 of each leaf's largest magnitude.
The two backwards take their sums over pixels and instances in other
orders; measured, the composite's VJP alone 1.6-3.4e-6 apart (synthetic
streams of up to 300 entries), the render 0.37-1.4e-6. Both packages are
also held to a float64 evaluation of the same operator
(:func:`test_both_packages_near_f64`, ROADMAP C11): the port's plain path
in float64, autograd through ``composite_stream_plain`` for the composite,
through ``preprocess`` and ``ops/raster_ref.py``'s per-pixel oracle for
the render (the stream operator where no tile budget clips).
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
from mvs_gaussian_splatting_tpu.ops.pallas.stream import \
    composite_stream as jcomposite
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView as JCamera
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
    params_from_numpy
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import (CameraView,
                                                             preprocess)
from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
    rasterize_reference
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render
from mvs_gaussian_splatting_tpu_torch.utils import losses as tlosses
from mvs_gaussian_splatting_tpu_torch.utils.transforms import normalize

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

REL = 5e-6
# each package to float64: measured, the composite's VJP JAX 0.36-3.1e-6,
# the port 0.21-0.98e-6; the render JAX 0.48-2.2e-6, the port 0.48-1.8e-6
F64_REL = {"vjp": 3.5e-6, "render": 2.5e-6}
# ROADMAP C13: the port no farther from float64 than the JAX package, at
# each level and leaf, than max(1.25 × the JAX package's gap, 5e-7)
C13_FACTOR, C13_FLOOR = 1.25, 5e-7
W, H = 64, 48


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


@pytest.fixture
def jax_stream_interpret(monkeypatch):
    """The JAX package's rasterize() taking its stream path through the
    Pallas kernels in interpret mode (the CPU has no TPU to lower them)."""
    monkeypatch.setattr(jrast, "_rasterize_stream", functools.partial(
        jrast._rasterize_stream, interpret=True))


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def _jax_vjp(attrs, seg_start, counts, bg, tile_ids, cts, tiles_x, tile_w,
             tile_h):
    def f(a, b):
        return jcomposite(a, seg_start, counts, b, tile_ids, tiles_x, tile_w,
                          tile_h, True)
    _, pull = jax.vjp(f, attrs, bg)
    return pull(cts)


class TestStreamBackward:
    # 24×10 and 8×4: tiles of a part-filled and of a single 8×4 warp block,
    # which the kernel's compact warps take since B2's redesign
    @pytest.mark.parametrize("geometry", [(16, 16), (32, 16), (24, 10),
                                          (8, 4)])
    def test_plain_matches_jax_vjp(self, geometry):
        tw, th = geometry
        s = tstream.random_stream(7, tiles_x=3, tiles_y=2, tile_w=tw,
                                  tile_h=th, long_len=300)
        t, p = s["seg_start"].shape[0], tw * th
        rng = np.random.RandomState(8)
        g_out = rng.randn(t, p, 3).astype(np.float32)
        g_tfin = rng.randn(t, p).astype(np.float32)
        names = ("attrs", "seg_start", "counts", "bg", "tile_ids")
        ga_j, gbg_j = _jax_vjp(*(jnp.asarray(s[k]) for k in names),
                               (jnp.asarray(g_out), jnp.asarray(g_tfin)),
                               s["tiles_x"], tw, th)
        args = [torch.from_numpy(s[k]) for k in names] + [s["tiles_x"], tw,
                                                          th]
        out, tfin = tstream.composite_stream_plain(*args)
        ga_t, gbg_t = tstream.composite_stream_bwd_plain(
            *args, out, tfin, torch.from_numpy(g_out),
            torch.from_numpy(g_tfin))
        ga_j = np.asarray(ga_j)
        gaps = [rel_gap(ga_t[r].numpy(), ga_j[r]) for r in range(9)]
        print(f"{tw}x{th}: per-row gaps " + " ".join(f"{g:.1e}" for g in gaps))
        assert max(gaps) <= REL
        # zero outside the segments and in the padding rows, in both
        width = s["attrs"].shape[1]
        inside = np.zeros(width, bool)
        for st, c in zip(s["seg_start"], s["counts"]):
            inside[st:st + c] = True
        assert not ga_t[:, ~inside].any() and not ga_t[9:].any()
        assert not ga_j[:, ~inside].any()
        assert rel_gap(gbg_t.numpy(), np.asarray(gbg_j)) <= REL


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
    jcam = JCamera(jnp.asarray(V), jnp.asarray(full), jnp.asarray(center),
                   *tan)
    tcam = CameraView(torch.tensor(V), torch.tensor(full),
                      torch.tensor(center), *(torch.tensor(v) for v in tan))
    return jcam, tcam


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_render_grads(jp, ndc, jcam, bg, w_img, w_t, *, cfg):
    def loss(p, off):
        out = jrender_mod.render(jcam, W, H, p, bg, sh_degree=3,
                                 ndc_offset=off, raster_config=cfg)
        return (out["render"] * w_img).sum() + (out["final_T"] * w_t).sum()
    return jax.grad(loss, argnums=(0, 1))(jp, ndc)


# ---- float64 evaluations of the same operator (ROADMAP C11) ----

F64 = torch.float64


def ssim64(a, b):
    """``utils/losses.ssim`` with its window in float64."""
    taps = tlosses._gaussian_taps(11, 1.5, a.device).to(F64)
    c = a.shape[0]
    bl = tlosses._blur(torch.cat([a, b, a * a, b * b, a * b]), taps)
    mu1, mu2, m11, m22, m12 = (bl[i * c:(i + 1) * c] for i in range(5))
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * (m12 - mu1 * mu2) + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1)
               * ((m11 - mu1 * mu1) + (m22 - mu2 * mu2) + c2))).mean()


def loss64(img, gt, opt, opacity_logit, alive):
    """``train/step.py``'s loss in float64, opacity sparsity included."""
    loss = ((1 - opt.lambda_dssim) * (img - gt).abs().mean()
            + opt.lambda_dssim * (1 - ssim64(img, gt)))
    opac = torch.sigmoid(opacity_logit[:, 0])
    m = alive & (opac < 0.005)
    if opt.opacitysparse > 0 and bool(m.any()):
        loss = loss + (opt.opacitysparse * ((opac - 1).abs() * m).sum()
                       / m.sum())
    return loss


def render64(d, alive, tcam, bg, ndc=None, tile=(32, 16)):
    """The render of raw parameters ``d`` (float64 tensors keyed by field)
    in float64: ``preprocess`` and the per-pixel oracle. Returns (image,
    final_T)."""
    cam = CameraView(*[t.to(F64) for t in tcam])
    h, w = 48, 64
    pp = preprocess(d["xyz"], torch.sigmoid(d["opacity"][:, 0]), cam, w, h,
                    scales=torch.exp(d["scaling"]),
                    rotations=normalize(d["rotation"]),
                    shs=torch.cat([d["f_dc"], d["f_rest"]], 1), sh_degree=3,
                    ndc_offset=ndc, mask=alive, tile_w=tile[0],
                    tile_h=tile[1])
    img, aux = rasterize_reference(pp, w, h, torch.as_tensor(bg, dtype=F64),
                                   return_aux=True, tile_w=tile[0],
                                   tile_h=tile[1])
    return img, aux["final_T"]


def leaves64(p, rows):
    """numpy params → float64 leaves (the first ``rows``) needing grads."""
    return {k: torch.tensor(v[:rows], dtype=F64, requires_grad=True)
            for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _vjp_f64_gaps():
    gaps = []
    for tw, th in ((16, 16), (32, 16), (24, 10), (8, 4)):
        s = tstream.random_stream(7, tiles_x=3, tiles_y=2, tile_w=tw,
                                  tile_h=th, long_len=300)
        t, p = s["seg_start"].shape[0], tw * th
        rng = np.random.RandomState(8)
        g_out = rng.randn(t, p, 3).astype(np.float32)
        g_tfin = rng.randn(t, p).astype(np.float32)
        names = ("attrs", "seg_start", "counts", "bg", "tile_ids")
        ga_j, _ = _jax_vjp(*(jnp.asarray(s[k]) for k in names),
                           (jnp.asarray(g_out), jnp.asarray(g_tfin)),
                           s["tiles_x"], tw, th)
        args = [torch.from_numpy(s[k]) for k in names] + [s["tiles_x"], tw,
                                                          th]
        out, tfin = tstream.composite_stream_plain(*args)
        ga_t, _ = tstream.composite_stream_bwd_plain(
            *args, out, tfin, torch.from_numpy(g_out),
            torch.from_numpy(g_tfin))
        a64 = args[0].to(F64).requires_grad_()
        o64, t64 = tstream.composite_stream_plain(a64, *args[1:3],
                                                  args[3].to(F64), *args[4:])
        ((o64 * torch.from_numpy(g_out).to(F64)).sum()
         + (t64 * torch.from_numpy(g_tfin).to(F64)).sum()).backward()
        want = a64.grad.numpy()
        gaps.append((f"{tw}x{th}",
                     max(rel_gap(np.asarray(ga_j)[r], want[r])
                         for r in range(9)),
                     max(rel_gap(ga_t[r].numpy(), want[r])
                         for r in range(9))))
    return gaps


@functools.lru_cache(maxsize=None)
def _render_f64_gaps():
    """(Called under ``jax_stream_interpret``, whose results it keeps.)"""
    n = 200
    d = random_model(n, seed=11)
    jcam, tcam = cameras()
    rng = np.random.RandomState(12)
    w_img = rng.randn(3, H, W).astype(np.float32)
    w_t = rng.randn(H, W).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg_kw = dict(tile_w=32, tile_h=16, max_tiles_per_gaussian=64,
                  tier_budgets=(4, 12), tier_fracs=(0.25, 0.1))
    gp_j, gndc_j = _jax_render_grads(
        JParams(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.zeros((n, 2)), jcam, jnp.asarray(bg), jnp.asarray(w_img),
        jnp.asarray(w_t),
        cfg=jrast.RasterConfig(backend="stream", **cfg_kw))
    tp = params_from_numpy(d, "cpu")
    tp = type(tp)(*[None if a is None else a.requires_grad_() for a in tp])
    ndc = torch.zeros((n, 2), requires_grad=True)
    out = render(tcam, W, H, tp, torch.tensor(bg), sh_degree=3,
                 ndc_offset=ndc, raster_config=RasterConfig(**cfg_kw))
    ((out["render"] * torch.tensor(w_img)).sum()
     + (out["final_T"] * torch.tensor(w_t)).sum()).backward()
    assert int(out["overflow_tiles"]) == 0     # the oracle's operator
    l64 = leaves64(d, n)
    ndc64 = torch.zeros((n, 2), dtype=F64, requires_grad=True)
    img, tfin = render64(l64, None, tcam, bg, ndc64)
    ((img * torch.tensor(w_img).to(F64)).sum()
     + (tfin * torch.tensor(w_t).to(F64)).sum()).backward()
    gaps = [(k, rel_gap(np.asarray(getattr(gp_j, k)), l64[k].grad.numpy()),
             rel_gap(getattr(tp, k).grad.numpy(), l64[k].grad.numpy()))
            for k in d]
    gaps.append(("ndc", rel_gap(np.asarray(gndc_j), ndc64.grad.numpy()),
                 rel_gap(ndc.grad.numpy(), ndc64.grad.numpy())))
    return gaps


def _camera_at_origin(width=64, height=64):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    return CameraView(torch.eye(4), torch.tensor(P.astype(np.float32)),
                      torch.zeros(3), torch.tensor(math.tan(fovx / 2)),
                      torch.tensor(math.tan(fovy / 2)))


# positions that produce non-finite backward values unless preprocess
# sanitizes its divisors: on the w = -1e-7 singularity, at the camera
# centre, just behind the camera, on the near-cull boundary
BAD_POSITIONS = [[0.1, 0.1, -1e-7], [0.0, 0.0, 0.0], [0.05, -0.05, -0.01],
                 [0.0, 0.1, 0.2]]
