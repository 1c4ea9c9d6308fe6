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

from mvs_gaussian_splatting_tpu.ops.pallas.stream import \
    composite_stream as jcomposite
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream
from test_torch_train import H, W, rel_gap

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


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_render_grads(jp, ndc, jcam, bg, w_img, w_t, *, cfg):
    def loss(p, off):
        out = jrender_mod.render(jcam, W, H, p, bg, sh_degree=3,
                                 ndc_offset=off, raster_config=cfg)
        return ((out["render"] * w_img).sum() + (out["final_T"] * w_t).sum(),
                (out["render"], out["final_T"]))
    return jax.grad(loss, argnums=(0, 1), has_aux=True)(jp, ndc)
