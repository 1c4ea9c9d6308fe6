"""The primitive-rate experiment (``tools/exp_perf.py``) held against the
JAX package on the CPU, and the experiments' entry points.

The tiers section's overflow counters and load at each of its four tier
settings equal the JAX package's ``bin_instances_stream`` on the same
``Processed`` arrays (the bench scene at 96×64 on 16×16 tiles, the JAX
package's preprocess handed to both through numpy), integer-exact, with a
capacity below the load so that the capacity overflow counts. A run on the
CPU at a toy size returns every key with finite times; without a card the
experiments' entry points exit non-zero unless given ``--device cpu``;
the stage times' attribution of device events to ranges is checked on a
made-up trace.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_tools_exp_binning import W, H, TILE, TILES_X, TILES_Y, \
    jpre, processed

from mvs_gaussian_splatting_tpu.ops import binning as jbin
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import Processed
from mvs_gaussian_splatting_tpu_torch.tools import (bench, exp_binning,
                                                    exp_perf, exp_scatter,
                                                    measure)

torch.set_num_threads(1)

N, CAP = 800, 2048


@functools.partial(jax.jit, static_argnums=(1, 2))
def jax_tiers(p, budgets, fracs):
    bins = jbin.bin_instances_stream(p, TILES_X, TILES_Y, 32, CAP,
                                     tile_w=TILE, tile_h=TILE,
                                     tier_budgets=budgets, tier_fracs=fracs)
    return bins.overflow_tiles, bins.overflow_capacity, bins.counts.sum()


def test_tiers_match_jax():
    p_np = processed(N)
    p = Processed(*(torch.tensor(a) for a in p_np))
    cfg = bench.raster_config(False)._replace(tile_w=TILE, tile_h=TILE)
    recs, checks = exp_perf.tiers(p, TILES_X, TILES_Y, cfg, CAP, 1,
                                  torch.device("cpu"))
    assert all(checks.values()), checks
    assert len(recs) == len(exp_perf.TIERS)
    for rec, (b, f) in zip(recs.values(), exp_perf.TIERS):
        assert (rec["budgets"], rec["fracs"]) == (list(b), list(f))
        want = [int(v) for v in jax_tiers(jpre.Processed(*p_np), b, f)]
        assert [rec["overflow_tiles"], rec["overflow_capacity"],
                rec["load"]] == want, (b, f)
        assert rec["overflow_capacity"] > 0


def test_run_cpu():
    res = exp_perf.run(iters=1, device="cpu", width=W, height=H, n=600,
                       cap=2048, sort_keys=(6000, 4800))
    assert res["checks"] and all(res["checks"].values()), res["checks"]
    assert set(res["rates"]) == {"row_gather", "row_gather_index_select",
                                 "column_gather", "row_scatter_add",
                                 "elem_gather", "sort_6000", "sort_4800"}
    assert set(res["kernels"]) == {"B3f_fwd", "B3f_B3b_fwd_bwd", "B1_fwd",
                                   "B1_B2_fwd_bwd"}
    assert set(res["unsort"]) == {"scatter_add", "sort_gather_cumsum",
                                  "rank_sort", "row_gather",
                                  "segsum_presorted"}
    for section in exp_perf.SECTIONS:
        for name, rec in res[section].items():
            assert np.isfinite(rec["ms"]) and rec["ms"] > 0, name
            assert rec["device_ms"] is None, name
    gather = res["rates"]["row_gather"]
    assert gather["bytes"] == 8 * 2048 + 64 * 600 + 64 * 2048
    assert gather["bound_ms"] == pytest.approx(gather["bytes"] / 3.35e9)
    assert "TILE_BATCH" in res["tile_batch"] and res["card"] is None
    assert exp_perf.run(sections=("tiers",), iters=1, device="cpu", width=W,
                        height=H, n=300, cap=1024).keys() >= {"tiers",
                                                              "checks"}


def test_entry_points_need_a_card():
    """With no card and no ``--device cpu``, each experiment exits
    non-zero before it measures."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would measure")
    for mod in (exp_binning, exp_scatter, exp_perf):
        with pytest.raises(SystemExit) as e:
            mod.main([])
        assert e.value.code not in (0, None), mod.__name__


def test_device_time_by_range():
    """Device events credited to the range whose host call launched them,
    matched by correlation id; events of other ranges or none dropped; a
    range with a launch whose device record is missing is None, a call
    that launches nothing is not counted."""
    def host(ts, c, name="cudaLaunchKernel", cat="cuda_runtime"):
        return {"cat": cat, "name": name, "ts": ts, "dur": 5,
                "args": {"correlation": c}}

    def dev(c, dur, cat="kernel"):
        return {"cat": cat, "ts": 1000 + c, "dur": dur,
                "args": {"correlation": c}}
    p = measure.RANGE_PREFIX
    events = [
        {"cat": "user_annotation", "name": p + "a", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": p + "b", "ts": 200, "dur": 100},
        {"cat": "user_annotation", "name": p + "c", "ts": 400, "dur": 100},
        {"cat": "user_annotation", "name": "other", "ts": 0, "dur": 1000},
        host(10, 1), host(20, 2, "cudaMemsetAsync"),
        host(30, 5, "cudaStreamSynchronize"),
        host(210, 3, "cuLaunchKernel", "cuda_driver"), host(150, 4),
        host(410, 6), host(420, 7),
        dev(1, 7), dev(2, 3, "gpu_memset"), dev(3, 11), dev(4, 13),
        dev(6, 19), dev(99, 17), {"cat": "cpu_op", "ts": 30, "dur": 1}]
    got = measure.device_ms_by_range(events)
    assert got.keys() == {"a", "b", "c"} and got["c"] is None
    assert (got["a"], got["b"]) == pytest.approx((0.010, 0.011))
