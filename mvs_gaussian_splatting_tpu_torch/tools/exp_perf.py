"""The card's primitive rates, the tier settings, the stream kernels and
the unsort, timed on the card.

Counterpart of the JAX repository's ``exp_perf.py``, whose numbers stand
behind ``PROFILE_FLOOR.md`` (the TPU's): the rates of the primitives the
binning, the pack and its backward are made of, each beside the least time
the card's memory allows, on ``tools/bench.py``'s synthetic scene at 32×16
tiles, printed as one JSON line::

    python -m mvs_gaussian_splatting_tpu_torch.tools.exp_perf
        [--workload 1080p|bicycle] [--section rates|tiers|kernels|unsort ...]
        [--iters N] [--device cpu]

Workloads: 1080p (1920×1088, 200,000 Gaussians, CAP 851,968, the JAX
script's) and bicycle (1237×822, 500,000, CAP 2,146,432, the JAX scatter
scripts'). Sections (the JAX lines they answer):

- rates (``:52-79``): a row gather of CAP ids into ``[N, 16]`` f32 rows (by
  advanced indexing, by ``index_select``, and as the pack gathers: the
  columns of the attribute-major ``[16, N]``), the row scatter-add back
  (``index_add_``), ``torch.sort`` of 1.6M and 1.28M int32 keys, and an
  element gather of CAP floats; each beside its byte
  bound (every input read once and every output written once, at 3.35
  TB/s, the H100 SXM's HBM rate).
- tiers (``:81-95``): ``bin_instances_stream`` at four tier settings, with
  its tile and capacity overflow and its load.
- kernels (``:97-122``, the ``batch`` section): the JAX script swept the
  Pallas grid's ``TILE_BATCH``; the CUDA kernels take no such parameter
  (one CTA a tile, heaviest tiles first), so this section times them as
  they are on the workload's stream through ``ops/stream.py``'s wrappers:
  B3f alone and B3f + B3b (fast math, the training default), B1 alone and
  B1 + B2 (exact).
- unsort (``:128-187``): the CAP-row scatter-add of the pack backward
  against a rank sort with a row gather and a cumsum-difference segment
  sum, the rank sort alone, the CAP-row gather alone, and the segment sum
  of rows already in rank order.

Checks: the scatter-adds within ``exp_scatter.REL`` of scale of their
float64 sums, the cumsum-difference sums within ``exp_scatter.CUMSUM_REL``;
the sorts ascending; the kernels' outputs finite; every tier setting's
counts consistent (the load and the capacity overflow add up to the raw
count). Timing as ``tools/exp_binning.py``'s.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.binning import bin_instances_stream
from ..ops.rasterize import bin_and_pack_stream
from ..ops.stream import composite_stream
from . import exp_scatter, measure
from .bench import HEIGHT, WIDTH, build_scene, project, raster_config
from .train_bench import WORKLOADS

SIZES = {"1080p": (WIDTH, HEIGHT),
         "bicycle": (WORKLOADS["bicycle"]["width"],
                     WORKLOADS["bicycle"]["height"])}
SECTIONS = ("rates", "tiers", "kernels", "unsort")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
SORT_KEYS = (1_600_000, 1_280_000)
TIERS = (((4, 12), (0.25, 0.1)), ((4, 10), (0.18, 0.06)),
         ((3, 8), (0.25, 0.08)), ((4, 12), (0.18, 0.05)))


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def with_bound(rec: dict, nbytes: int, rows: int = 0) -> dict:
    rec = dict(rec, bytes=nbytes, bound_ms=bound_ms(nbytes))
    if rows:
        rec["ns_per_row"] = rec["ms"] * 1e6 / rows
        rec["device_ns_per_row"] = (None if rec["device_ms"] is None
                                    else rec["device_ms"] * 1e6 / rows)
    return rec


def rates(n: int, cap: int, iters: int, device, sort_keys=SORT_KEYS):
    """(records, checks) of the primitive rates; the draws are the JAX
    script's, from ``RandomState(0)``."""
    rng = np.random.RandomState(0)

    def t(a):
        return torch.as_tensor(a, device=device)
    idx = t(rng.randint(0, n, cap).astype(np.int64))
    table16 = t(rng.rand(n, 16).astype(np.float32))
    grows = t(rng.rand(cap, 16).astype(np.float32))
    keys = t(rng.randint(0, 1 << 30, max(sort_keys)).astype(np.int32))
    eidx = t(rng.randint(0, cap, cap).astype(np.int64))
    flat = t(rng.rand(cap).astype(np.float32))
    table16_t = table16.T.contiguous()
    stages = {"row_gather": lambda: table16[idx],
              "row_gather_index_select": lambda: table16.index_select(0,
                                                                      idx),
              "column_gather": lambda: table16_t[:, idx],
              "row_scatter_add": lambda: exp_scatter.colliding(grows, idx,
                                                               n),
              "elem_gather": lambda: flat[eidx]}
    for k in sort_keys:
        stages[f"sort_{k}"] = lambda k=k: torch.sort(keys[:k]).values
    times = measure.stage_times(stages, iters, device)
    recs = {
        **{name: with_bound(times[name], 8 * cap + 64 * n + 64 * cap, cap)
           for name in ("row_gather", "row_gather_index_select",
                        "column_gather")},
        "row_scatter_add": with_bound(times["row_scatter_add"],
                                      8 * cap + 64 * cap + 64 * n, cap),
        "elem_gather": with_bound(times["elem_gather"], 8 * cap + 4 * cap
                                  + 4 * cap, cap),
    }
    for k in sort_keys:
        recs[f"sort_{k}"] = with_bound(times[f"sort_{k}"], 8 * k, k)
    err = exp_scatter.rel_err(exp_scatter.colliding(grows, idx, n),
                              exp_scatter.colliding(grows.double(), idx, n))
    recs["row_scatter_add"]["rel_err"] = err
    rows = table16[idx]
    checks = {"rates_scatter_add": err <= exp_scatter.REL,
              "rates_gathers": bool(torch.equal(
                  table16.index_select(0, idx), rows)) and bool(
                  torch.equal(table16_t[:, idx], rows.T))}
    for k in sort_keys:
        s = torch.sort(keys[:k]).values
        checks[f"rates_sort_{k}"] = bool((s[1:] >= s[:-1]).all())
    return recs, checks


def tiers(p, tiles_x: int, tiles_y: int, cfg, cap: int, iters: int, device):
    """(records, checks) of ``bin_instances_stream`` at each of ``TIERS``."""
    def binning(budgets, fracs):
        return bin_instances_stream(
            p, tiles_x, tiles_y, cfg.max_tiles_per_gaussian, cap,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h, tier_budgets=budgets,
            tier_fracs=fracs)
    names = ["/".join(map(str, b)) + "@" + "/".join(map(str, f))
             for b, f in TIERS]
    times = measure.stage_times(
        {name: (lambda b=b, f=f: binning(b, f))
         for name, (b, f) in zip(names, TIERS)}, iters, device)
    recs, checks = {}, {}
    for name, (b, f) in zip(names, TIERS):
        bins = binning(b, f)
        load = int(bins.counts.sum())
        recs[name] = dict(times[name], budgets=list(b), fracs=list(f),
                          overflow_tiles=int(bins.overflow_tiles),
                          overflow_capacity=int(bins.overflow_capacity),
                          load=load)
        checks[f"tiers_{name}"] = (load + int(bins.overflow_capacity)
                                   == int(bins.counts_raw.sum()))
    return recs, checks


def kernels(p, tiles_x: int, tiles_y: int, cfg, cap: int, iters: int,
            device):
    """(records, checks) of the stream kernels through their wrappers on
    the workload's stream at capacity ``cap``."""
    with torch.no_grad():
        bins, attrs = bin_and_pack_stream(
            p, tiles_x, tiles_y, cfg._replace(instance_cap=cap))
    bg = torch.zeros(3, device=device)
    tile_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32,
                            device=device)

    def fwd(fast):
        with torch.no_grad():
            return composite_stream(attrs, bins.seg_start, bins.counts, bg,
                                    tile_ids, tiles_x, cfg.tile_w,
                                    cfg.tile_h, fast)

    def fwd_bwd(fast):
        a = attrs.detach().requires_grad_(True)
        out, _ = composite_stream(a, bins.seg_start, bins.counts, bg,
                                  tile_ids, tiles_x, cfg.tile_w, cfg.tile_h,
                                  fast)
        return torch.autograd.grad(out.mean(), a)[0]

    stages = {"B3f_fwd": lambda: fwd(True),
              "B3f_B3b_fwd_bwd": lambda: fwd_bwd(True),
              "B1_fwd": lambda: fwd(False),
              "B1_B2_fwd_bwd": lambda: fwd_bwd(False)}
    recs = measure.stage_times(stages, iters, device)
    for rec in recs.values():
        rec["instances"] = int(bins.counts.sum())
        rec["overflow_capacity"] = int(bins.overflow_capacity)
    checks = {}
    for name, fn in stages.items():
        out = fn()
        out = out[0] if isinstance(out, tuple) else out
        checks[f"kernels_{name}_finite"] = bool(torch.isfinite(out).all())
    return recs, checks


def unsort(n: int, cap: int, iters: int, device):
    """(records, checks) of the unsort candidates; the draws are the JAX
    script's (``RandomState(0)``: rank ids, then normal rows)."""
    rng = np.random.RandomState(0)
    ranks = torch.as_tensor(rng.randint(0, n, cap).astype(np.int64),
                            device=device)
    g = torch.as_tensor(rng.randn(cap, 16).astype(np.float32),
                        device=device)
    sr, pos = torch.sort(ranks)
    g_sorted = g[pos]
    es = exp_scatter
    stages = {"scatter_add": lambda: es.colliding(g, ranks, n),
              "sort_gather_cumsum": lambda: es.sort_segment_sum(g, ranks,
                                                                n),
              "rank_sort": lambda: torch.sort(ranks),
              "row_gather": lambda: g[ranks],
              "segsum_presorted": lambda: es.segment_sum_presorted(
                  g_sorted, sr, n)}
    times = measure.stage_times(stages, iters, device)
    ref = es.colliding(g.double(), ranks, n)
    recs, checks = {}, {}
    for name, tol in (("scatter_add", es.REL),
                      ("sort_gather_cumsum", es.CUMSUM_REL),
                      ("segsum_presorted", es.CUMSUM_REL)):
        err = es.rel_err(stages[name](), ref)
        recs[name] = dict(times[name], rel_err=err)
        checks[f"unsort_{name}"] = err <= tol
    for name in ("rank_sort", "row_gather"):
        recs[name] = times[name]
    return recs, checks


def run(workload: str = "1080p", sections=SECTIONS, iters: int = 10,
        device="cuda", width: int = 0, height: int = 0, n: int = 0,
        cap: int = 0, sort_keys=SORT_KEYS) -> dict:
    """The experiment's JSON record. ``width``/``height``/``n``/``cap``
    (0: the workload's) and ``sort_keys`` shrink it for tests."""
    device = torch.device(device)
    n0, cap0 = exp_scatter.SHAPES[workload]
    w0, h0 = SIZES[workload]
    width, height, n, cap = width or w0, height or h0, n or n0, cap or cap0
    cfg = raster_config(False)
    tiles_x, tiles_y = -(-width // cfg.tile_w), -(-height // cfg.tile_h)
    result = {
        "experiment": "exp_perf",
        "workload": f"{width}x{height}, {n} gaussians, CAP={cap}",
        "device": measure.device_name(device),
        "card": measure.card() if device.type == "cuda" else None,
        "clock": (("CUDA events" if device.type == "cuda" else "host")
                  + f", mean of {iters} after a warm-up; device_ms from "
                  "torch.profiler over as many calls"),
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "tile_batch": "none: the CUDA kernels take one CTA a tile; "
                      "TILE_BATCH was the Pallas grid's",
    }
    checks = {}
    if "rates" in sections:
        result["rates"], c = rates(n, cap, iters, device, sort_keys)
        checks.update(c)
    if "tiers" in sections or "kernels" in sections:
        cam, arrays = build_scene(n, width, height, device=device)
        with torch.no_grad():
            p = project(arrays, cam, width, height, cfg)
        for name, fn in (("tiers", tiers), ("kernels", kernels)):
            if name in sections:
                result[name], c = fn(p, tiles_x, tiles_y, cfg, cap, iters,
                                     device)
                checks.update(c)
    if "unsort" in sections:
        result["unsort"], c = unsort(n, cap, iters, device)
        checks.update(c)
    result["checks"] = checks
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=sorted(SIZES), default="1080p")
    ap.add_argument("--section", action="append", choices=SECTIONS,
                    help="a section to run (repeatable; default all)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    result = run(args.workload, tuple(args.section or SECTIONS), args.iters,
                 measure.checked_device(args.device))
    print(json.dumps(result), flush=True)
    if not all(result["checks"].values()):
        sys.exit(f"exp_perf: checks failed: {result['checks']}")
    return result


if __name__ == "__main__":
    main()
