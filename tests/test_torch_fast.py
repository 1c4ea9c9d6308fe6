"""The port's fast-math mode (B3, ``RasterConfig.fast_math``) held against
the JAX package's fast mode on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
JAX package's stream kernels run with ``fast=True`` in interpret mode,
jitted whole, as its ``tests/test_fast_math.py`` runs them; there the MXU
products are f32, so the JAX fast mode differs from its exact mode only by
the log/exp round trip and the order of its sums, and the port's plain
fast versions (``composite_stream_fast_plain``,
``composite_stream_bwd_fast_plain``), which follow the same formulas in
f32, land far inside the fast-mode contract. Bounds:

- plain fast vs JAX fast, and whole-render images: 2e-4 max abs (the
  exact mode's bound; the contract allows 2e-3), gradients 2e-5 of each
  row's largest magnitude (the exact mode's; the contract allows 5e-3);
- plain fast vs plain exact: the contract itself
  (``tests/test_fast_math.py``): 2e-3 max abs on image and final_T, 5e-3
  of each row's largest magnitude on gradients.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models.gaussians import \
    GaussianParams as JParams
from mvs_gaussian_splatting_tpu.ops.pallas.stream import \
    composite_stream as jcomposite
from mvs_gaussian_splatting_tpu.train.config import \
    PipelineConfig as JPipelineConfig
from mvs_gaussian_splatting_tpu.train.loop import \
    raster_config_from_pipe as jraster_config_from_pipe
from mvs_gaussian_splatting_tpu.train.step import \
    make_train_step as jmake_train_step
from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
    params_from_numpy
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render
from mvs_gaussian_splatting_tpu_torch.train.config import PipelineConfig
from mvs_gaussian_splatting_tpu_torch.train.loop import \
    raster_config_from_pipe
from mvs_gaussian_splatting_tpu_torch.train.step import make_train_step
from test_torch_grad import cameras, random_model
from test_torch_train import (FIELDS, H, W, _camera, jax_state, rel_gap,
                              scene_state, torch_state)

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

TOL = 2e-4
REL = 2e-5
FAST_IMG = 2e-3      # the fast-mode contract, tests/test_fast_math.py
FAST_GRAD = 5e-3
NAMES = ("attrs", "seg_start", "counts", "bg", "tile_ids")


@pytest.fixture
def jax_stream_interpret(monkeypatch):
    """The JAX package's rasterize() taking its stream path through the
    Pallas kernels in interpret mode."""
    monkeypatch.setattr(jrast, "_rasterize_stream", functools.partial(
        jrast._rasterize_stream, interpret=True))


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def _jax_fast_vjp(attrs, seg_start, counts, bg, tile_ids, cts, tiles_x,
                  tile_w, tile_h):
    def f(a, b):
        return jcomposite(a, seg_start, counts, b, tile_ids, tiles_x, tile_w,
                          tile_h, True, False, True)
    out, pull = jax.vjp(f, attrs, bg)
    return out, pull(cts)


def _stream(geometry):
    tw, th = geometry
    # a fifth of the entries far-centred wide splats: the moment form's
    # cancellation case
    return tstream.random_stream(7, tiles_x=3, tiles_y=2, tile_w=tw,
                                 tile_h=th, long_len=300, far=0.2)


def _cotangents(s):
    t, p = s["seg_start"].shape[0], s["tile_w"] * s["tile_h"]
    rng = np.random.RandomState(8)
    return (rng.randn(t, p, 3).astype(np.float32),
            rng.randn(t, p).astype(np.float32))


def _row_gaps(got, want, rows=9):
    return [rel_gap(np.asarray(got[r]), np.asarray(want[r]))
            for r in range(rows)]


class TestStreamFast:
    @pytest.mark.parametrize("geometry", [(16, 16), (32, 16)])
    def test_plain_matches_jax_fast(self, geometry):
        s = _stream(geometry)
        g_out, g_tfin = _cotangents(s)
        (out_j, tfin_j), (ga_j, gbg_j) = _jax_fast_vjp(
            *(jnp.asarray(s[k]) for k in NAMES),
            (jnp.asarray(g_out), jnp.asarray(g_tfin)), s["tiles_x"],
            *geometry)
        args = [torch.from_numpy(s[k]) for k in NAMES] + [s["tiles_x"],
                                                          *geometry]
        out, tfin = tstream.composite_stream_fast_plain(*args)
        ga, gbg = tstream.composite_stream_bwd_fast_plain(
            *args, out, tfin, torch.from_numpy(g_out),
            torch.from_numpy(g_tfin))
        gap = max(float(np.abs(out.numpy() - np.asarray(out_j)).max()),
                  float(np.abs(tfin.numpy() - np.asarray(tfin_j)).max()))
        gaps = _row_gaps(ga.numpy(), np.asarray(ga_j))
        print(f"{geometry}: forward {gap:.2e}; per-row gaps "
              + " ".join(f"{g:.1e}" for g in gaps))
        assert gap <= TOL and max(gaps) <= REL
        assert rel_gap(gbg.numpy(), np.asarray(gbg_j)) <= REL
        # zero outside the segments and in the padding rows
        inside = np.zeros(s["attrs"].shape[1], bool)
        for st, c in zip(s["seg_start"], s["counts"]):
            inside[st:st + c] = True
        assert not ga.numpy()[:, ~inside].any() and not ga.numpy()[9:].any()

    @pytest.mark.parametrize("geometry", [(16, 16), (32, 16)])
    def test_fast_within_contract_of_exact(self, geometry):
        s = _stream(geometry)
        g_out, g_tfin = (torch.from_numpy(c) for c in _cotangents(s))
        args = [torch.from_numpy(s[k]) for k in NAMES] + [s["tiles_x"],
                                                          *geometry]
        out_e, tfin_e = tstream.composite_stream_plain(*args)
        out_f, tfin_f = tstream.composite_stream_fast_plain(*args)
        gap = max(float((out_f - out_e).abs().max()),
                  float((tfin_f - tfin_e).abs().max()))
        ga_e, _ = tstream.composite_stream_bwd_plain(*args, out_e, tfin_e,
                                                     g_out, g_tfin)
        ga_f, _ = tstream.composite_stream_bwd_fast_plain(
            *args, out_f, tfin_f, g_out, g_tfin)
        gaps = _row_gaps(ga_f.numpy(), ga_e.numpy())
        print(f"{geometry}: fast vs exact image {gap:.2e}; per-row "
              + " ".join(f"{g:.1e}" for g in gaps))
        assert gap <= FAST_IMG and max(gaps) <= FAST_GRAD

    def test_autograd_routes_fast_to_fast_plain(self, monkeypatch):
        s = _stream((32, 16))
        g_out, g_tfin = (torch.from_numpy(c) for c in _cotangents(s))
        args = [torch.from_numpy(s[k]) for k in NAMES] + [s["tiles_x"], 32,
                                                          16]

        def refuse(*a, **k):
            raise AssertionError("fast mode reached an exact plain version")

        monkeypatch.setattr(tstream, "composite_stream_plain", refuse)
        monkeypatch.setattr(tstream, "composite_stream_bwd_plain", refuse)
        attrs = args[0].clone().requires_grad_()
        out, tfin = tstream.composite_stream(attrs, *args[1:], fast=True)
        torch.autograd.backward((out, tfin), (g_out, g_tfin))
        want, _ = tstream.composite_stream_bwd_fast_plain(
            *args, out.detach(), tfin.detach(), g_out, g_tfin)
        torch.testing.assert_close(attrs.grad, want, rtol=0, atol=0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_render_grads(jp, ndc, jcam, bg, w_img, w_t, *, cfg):
    def loss(p, off):
        out = jrender_mod.render(jcam, W, H, p, bg, sh_degree=3,
                                 ndc_offset=off, raster_config=cfg)
        return ((out["render"] * w_img).sum() + (out["final_T"] * w_t).sum(),
                (out["render"], out["final_T"]))
    return jax.grad(loss, argnums=(0, 1), has_aux=True)(jp, ndc)


def test_render_fast_matches_jax(jax_stream_interpret):
    """The image and every parameter's gradient (and the viewspace
    statistic's) of ``render`` with ``fast_math=True`` against the JAX
    package's fast stream path, at its ``tests/test_fast_math.py`` scene
    size (150 Gaussians, 64×48)."""
    n = 150
    d = random_model(n, seed=13)
    jcam, tcam = cameras()
    rng = np.random.RandomState(14)
    w_img = rng.randn(3, H, W).astype(np.float32)
    w_t = rng.randn(H, W).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg_kw = dict(instance_cap=1 << 14, fast_math=True)
    (gp_j, gndc_j), (img_j, tfin_j) = _jax_render_grads(
        JParams(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.zeros((n, 2)), jcam, jnp.asarray(bg), jnp.asarray(w_img),
        jnp.asarray(w_t), cfg=jrast.RasterConfig(backend="stream", **cfg_kw))

    tp = params_from_numpy(d, "cpu")
    tp = type(tp)(*[None if a is None else a.requires_grad_() for a in tp])
    ndc = torch.zeros((n, 2), requires_grad=True)
    out = render(tcam, W, H, tp, torch.tensor(bg), sh_degree=3,
                 ndc_offset=ndc, raster_config=RasterConfig(**cfg_kw))
    loss = ((out["render"] * torch.tensor(w_img)).sum()
            + (out["final_T"] * torch.tensor(w_t)).sum())
    loss.backward()
    gap = max(float(np.abs(out["render"].detach().numpy()
                           - np.asarray(img_j)).max()),
              float(np.abs(out["final_T"].detach().numpy()
                           - np.asarray(tfin_j)).max()))
    gaps = {k: rel_gap(getattr(tp, k).grad.numpy(),
                       np.asarray(getattr(gp_j, k))) for k in d}
    gaps["ndc_offset"] = rel_gap(ndc.grad.numpy(), np.asarray(gndc_j))
    print(f"fast render vs JAX: image {gap:.1e}; grads " + ", ".join(
        f"{k} {v:.1e}" for k, v in gaps.items()))
    assert gap <= TOL and max(gaps.values()) <= REL


def test_train_step_default_config_matches_jax(jax_stream_interpret):
    """One training step under the default ``PipelineConfig`` (fast math,
    16×16 tiles, the default budgets) against the JAX package's step on its
    stream backend, with ``tests/test_torch_train.py::TestTrainStep``'s
    tolerances but one: a parameter's step, read as new − old parameter,
    may differ by one ulp of the new parameter beyond 1e-5 of the largest
    step (both packages round p − step to f32; on this scene the same step
    in exact mode differs by as much)."""
    from mvs_gaussian_splatting_tpu.train.config import \
        OptimizationConfig as JOptimizationConfig
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig

    p, mu, nu, aux = scene_state(180, 256, seed=15)
    jcam, tcam = _camera()
    gt = np.random.RandomState(16).rand(3, H, W).astype(np.float32)
    bg = np.array([0.2, 0.3, 0.1], np.float32)
    jcfg = jraster_config_from_pipe(JPipelineConfig())._replace(
        backend="stream")
    tcfg = raster_config_from_pipe(PipelineConfig())
    assert jcfg.fast_math and tcfg.fast_math
    jstep = jmake_train_step(JOptimizationConfig(), jcfg, 4.2)
    jp, jadam, jaux = jax_state(p, mu, nu, aux, count=20)
    jnew, jst, _, jm = jstep(jp, jadam, jaux, jcam, jnp.asarray(gt),
                             jnp.asarray(bg), jnp.int32(21),
                             jnp.asarray(True), width=W, height=H,
                             sh_degree=3, render_n=192)
    tstep = make_train_step(OptimizationConfig(), tcfg, 4.2)
    tp, tadam, taux = torch_state(p, mu, nu, aux, count=20)
    tnew, tst, _, tm = tstep(tp, tadam, taux, tcam, torch.tensor(gt),
                             torch.tensor(bg), 21, True, width=W, height=H,
                             sh_degree=3, render_n=192)
    assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5
    for k in ("n_visible", "overflow_tiles", "overflow_capacity",
              "instance_load", "nonfinite_grad_rows"):
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
    gaps, steps = {}, {}
    for k in FIELDS:
        gj = np.asarray(getattr(jst.mu, k)) - 0.9 * mu[k]
        gt_ = getattr(tst.mu, k).numpy() - 0.9 * mu[k]
        gaps[k] = rel_gap(gt_[:180], gj[:180])
        np.testing.assert_allclose(getattr(tst.nu, k).numpy(),
                                   np.asarray(getattr(jst.nu, k)),
                                   rtol=1e-4, atol=1e-12, err_msg=k)
        # the step read back as new − old parameter carries the rounding of
        # the new parameter: 1e-5 of the largest step plus one ulp of it
        new_j = np.asarray(getattr(jnew, k))
        step_j, step_t = new_j - p[k], getattr(tnew, k).numpy() - p[k]
        excess = (np.abs(step_t - step_j) - np.spacing(np.abs(new_j))
                  ) / np.abs(step_j).max()
        steps[k] = float(excess.max())
    print("default-config step: gradient gaps " + ", ".join(
        f"{k} {v:.1e}" for k, v in gaps.items()) + "; step gaps beyond an "
        "ulp " + ", ".join(f"{k} {v:.1e}" for k, v in steps.items()))
    assert max(steps.values()) <= 1e-5
    assert max(gaps.values()) <= 2e-5
