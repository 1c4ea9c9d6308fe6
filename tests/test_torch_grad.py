"""Gradients of the port's render path held against the JAX package.

Inputs are made from a seed with numpy and handed to both packages. The JAX
package's stream path runs its Pallas kernels (B1 forward, B2 backward) in
interpret mode, as its own tests do, jitted whole; the port runs on the
CPU, where the composite and its backward take their plain versions.

Tolerance: gradients agree within 2e-5 of each leaf's largest magnitude
(the bound ``tests/test_stream.py`` holds the JAX stream backward to
against its oracle): the two backwards take their sums over pixels and
instances in other orders.
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
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

REL = 2e-5
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


class TestRenderGradients:
    def test_render_grads_match_jax(self, jax_stream_interpret):
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
        tp = type(tp)(*[None if a is None else a.requires_grad_()
                        for a in tp])
        ndc = torch.zeros((n, 2), requires_grad=True)
        out = render(tcam, W, H, tp, torch.tensor(bg), sh_degree=3,
                     ndc_offset=ndc, raster_config=RasterConfig(**cfg_kw))
        loss = ((out["render"] * torch.tensor(w_img)).sum()
                + (out["final_T"] * torch.tensor(w_t)).sum())
        loss.backward()
        assert int(out["overflow_tiles"]) == 0
        gaps = {k: rel_gap(getattr(tp, k).grad.numpy(),
                           np.asarray(getattr(gp_j, k))) for k in d}
        gaps["ndc_offset"] = rel_gap(ndc.grad.numpy(), np.asarray(gndc_j))
        print("render grads vs JAX: " + ", ".join(
            f"{k} {v:.1e}" for k, v in gaps.items()))
        assert max(gaps.values()) <= REL


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


@pytest.mark.parametrize("bad", BAD_POSITIONS)
def test_preprocess_grads_finite_at_camera_plane(bad):
    cam = _camera_at_origin()
    means = torch.tensor([[0.0, 0.0, 5.0], bad], requires_grad=True)
    scales = torch.full((2, 3), 0.1, requires_grad=True)
    quats = torch.tensor([[1.0, 0, 0, 0]] * 2, requires_grad=True)
    opac = torch.tensor([0.9, 0.9], requires_grad=True)
    shs = torch.zeros((2, 16, 3))
    shs[:, 0] = 0.7
    shs.requires_grad_()
    p = preprocess(means, opac, cam, 64, 64, scales=scales, rotations=quats,
                   shs=shs, sh_degree=3)
    mask = p.mask[:, None]
    # touch every differentiable output the way the composite would
    loss = (torch.where(mask, p.xy, 0.0).sum()
            + torch.where(mask, p.conic, 0.0).sum()
            + torch.where(mask, p.rgb, 0.0).sum()
            + torch.where(p.mask, p.opacity, 0.0).sum()
            + torch.where(p.mask, p.depth, 0.0).sum())
    loss.backward()
    for t in (means, scales, quats, opac, shs):
        assert bool(torch.isfinite(t.grad).all()), t.grad
    assert bool(p.mask[0]) and not bool(p.mask[1])
