"""The binning experiment (``tools/exp_binning.py``) held against the JAX
package's ``ops/binning.py:bin_instances_stream`` on the CPU.

The scene is ``tools/bench.py``'s (its draws are the JAX bench's) at 96×64
on 16×16 tiles; the JAX package preprocesses it, and its ``Processed``
arrays go through numpy to both packages' binning, so the inputs are the
same. Bound: integer-exact, every field (``exp_binning.FIELDS``), for the
stages composed, every variant, and the adaptive layout's binning; the
adaptive layout and its sort bound equal to the JAX package's. The level
ranking (C2) equals the area ranking unless a tier's demand exceeds its
cap; the ``tight`` layout makes it so, and there C2 clips more.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.ops import binning as jbin
from mvs_gaussian_splatting_tpu.utils.transforms import normalize
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import Processed
from mvs_gaussian_splatting_tpu_torch.tools import bench
from mvs_gaussian_splatting_tpu_torch.tools import exp_binning as eb

torch.set_num_threads(1)

jpre = importlib.import_module("mvs_gaussian_splatting_tpu.ops.preprocess")
W, H, TILE, D = 96, 64, 16, 32
TILES_X, TILES_Y = W // TILE, H // TILE
CASES = {
    "tiered": dict(n=800, tier_budgets=(4, 12), tier_fracs=(0.25, 0.1)),
    "flat": dict(n=800, tier_budgets=(), tier_fracs=()),
    # 888 rows need more than one tile against a cap of 512
    "tight": dict(n=1000, tier_budgets=(1, 2), tier_fracs=(0.25, 0.1)),
}


@functools.lru_cache(maxsize=None)
def processed(n):
    """The JAX package's preprocess of the bench scene, as numpy."""
    cam, arrays = bench.build_scene(n, W, H, device="cpu")
    jcam = jpre.CameraView(*(jnp.asarray(t.numpy()) for t in cam))
    means, log_scales, quats, opac_logit, shs = (jnp.asarray(a.numpy())
                                                 for a in arrays)

    @jax.jit
    def pre():
        return jpre.preprocess(
            means, jax.nn.sigmoid(opac_logit), jcam, W, H,
            scales=jnp.exp(log_scales), rotations=normalize(quats), shs=shs,
            sh_degree=3, tile_w=TILE, tile_h=TILE)
    return tuple(np.asarray(v) for v in pre())


@functools.partial(jax.jit, static_argnums=(1, 2, 3),
                   static_argnames=("tier_budgets", "tier_fracs"))
def jax_bin(p, d, cap, tile, **kw):
    return jbin.bin_instances_stream(p, TILES_X, TILES_Y, d, cap,
                                     tile_w=tile, tile_h=tile, **kw)


def jax_fields(p_np, lay):
    bins = jax_bin(jpre.Processed(*p_np), lay.d, lay.cap, TILE,
                   tier_budgets=lay.budgets, tier_fracs=lay.fracs)
    return {k: torch.tensor(np.asarray(getattr(bins, k)))
            for k in eb.FIELDS}


def assert_equal(got, want, what):
    for k in eb.FIELDS:
        assert got[k].shape == want[k].shape, (what, k)
        assert torch.equal(got[k], want[k]), (what, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_and_variants_match_jax(case):
    c = CASES[case]
    n = c["n"]
    p_np = processed(n)
    p = Processed(*(torch.tensor(a) for a in p_np))
    cap = jbin.auto_instance_cap(n, D, TILE, TILE, c["tier_budgets"],
                                 c["tier_fracs"])
    lay = eb.make_layout(n, TILES_X, TILES_Y, D, cap, TILE, TILE,
                         c["tier_budgets"], c["tier_fracs"])
    want = jax_fields(p_np, lay)
    assert int(want["counts"].sum()) > 0
    assert_equal(eb.shipped(p, lay), want, "shipped")
    assert_equal(eb.chain(p, lay), want, "A-F")
    for div in eb.DIVISIONS:
        for layout in ("T", "R"):
            for seg in ("search", "hist"):
                assert_equal(eb.chain(p, lay, "area", div, layout, seg),
                             want, (div, layout, seg))
    order = eb.stage_a(p)
    assert torch.equal(order, want["order"])
    rect_o = eb.stage_b(p, order)
    area, aorder, area_sorted = eb.stage_c(rect_o, lay)
    keys = eb.stage_d(rect_o, area, aorder, area_sorted, lay)[0]
    assert keys.numel() == jbin.stream_instance_bound(
        n, D, lay.budgets, lay.fracs)
    assert torch.equal(eb.f_hist(eb.stage_e(keys), lay)[0],
                       eb.f_search(eb.stage_e(keys), lay)[0])

    level = eb.chain(p, lay, rank="level")
    demand = eb.tier_counts(area, lay).tolist()
    assert eb.c2_check(level, want, demand, lay)
    if case == "tight":
        assert demand[0] > lay.caps[0]
        assert int(level["overflow_tiles"]) > int(want["overflow_tiles"])
    else:
        assert_equal(level, want, "C2")

    # E2: the layout sized from the areas, against the JAX package's
    needs = area.numpy()
    got = eb.adaptive_tier_layout(needs, D, lay.budgets, lay.fracs)
    ref = jbin.adaptive_tier_layout(needs, D, lay.budgets, lay.fracs)
    assert got[0] == ref[0] and tuple(got[1]) == tuple(ref[1])
    assert tuple(got[2]) == tuple(ref[2]) and got[3] == ref[3]
    assert (eb.stream_instance_bound(n, *got[:3])
            == jbin.stream_instance_bound(n, *ref[:3]))
    lay_a = eb.make_layout(n, TILES_X, TILES_Y, got[0], cap, TILE, TILE,
                           got[1], got[2])
    assert_equal(eb.chain(p, lay_a), jax_fields(p_np, lay_a), "E2")


def test_run_cpu():
    """The record at a toy size: every check true, every stage timed."""
    res = eb.run(iters=1, device="cpu", width=W, height=H, n=600)
    assert res["checks"] and all(res["checks"].values()), res["checks"]
    assert set(res["stages"]) >= {"A_depth_sort", "B_rect_gather",
                                  "C_area_rank", "D_enumerate", "E_sort",
                                  "F_segments", "whole", "C2_level_rank",
                                  "D2_enumerate_int", "E2_sort_adaptive",
                                  "grid_R_int_hist", "lane_gather"}
    for name, rec in res["stages"].items():
        assert np.isfinite(rec["ms"]) and rec["ms"] > 0, name
        assert rec["device_ms"] is None, name
    assert res["sum_a_f"]["ms"] > 0 and res["card"] is None
    assert res["keys"] == res["bound_static"]
    assert res["live_keys"] == res["load"] + res["overflow_capacity"]
