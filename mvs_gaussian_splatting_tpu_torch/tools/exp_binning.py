"""The stages of tile binning and their variants, timed on the card.

Counterpart of the JAX repository's ``exp_binning.py``,
``exp_binning2.py``, ``exp_binning3.py`` and ``exp_binning4.py``: the
port's ``ops/binning.py:bin_instances_stream`` cut into its stages, each
stage and each variant a plain function on tensors, on ``tools/bench.py``'s
synthetic scene at 32×16 tiles, 32 tiles a Gaussian, tiers (4, 12) at
(0.25, 0.1) and the ``auto_instance_cap`` capacity, printed as one JSON
line::

    python -m mvs_gaussian_splatting_tpu_torch.tools.exp_binning
        [--workload fern|bicycle] [--iters N] [--device cpu]

Sections (line ranges of the JAX scripts they answer; stage line numbers
are ``ops/binning.py``'s):

- stages (``exp_binning.py:66-231``): A the depth sort (``:336-338``), B
  the ``rect_table`` gather and its transpose (``:339-341``), C the area
  ranking (areas ``:342-347``, the packed-key sort ``:385-396``), D the
  tier enumeration (``enumerate_tier`` ``:357-380`` and its tier loop
  ``:397-418``), E the packed-key sort (``:421-431``), F the
  ``searchsorted`` segment starts and the ``inst_rank`` tail
  (``:437-466``); their sum beside the whole call. Variants: D2, integer
  ``div``/``mod`` (``int``) or the reciprocal product (``recip``, the JAX
  script's D2) in place of the shipped f32 division; C2, the tier ranking
  by a tier-level key in place of the area key; E2 (and its enumeration
  D3), the layout ``adaptive_tier_layout`` (``:206``) sizes from this
  frame's tile needs.
- layout (``exp_binning2.py:72-165``): the row-major ``[M, w]``
  enumeration against the shipped ``[w, M]`` one, the enumeration and the
  sort in one span, and F split into its ``searchsorted`` calls, the
  ``bincount`` + ``cumsum`` alternative, and the tail.
- regress (``exp_binning3.py:47-88``): the whole call with and without a
  given depth order, the ``[N, 8] → [8, N]`` transpose, a 50,000-row tier
  gather along the lane dimension of ``[8, N]`` and along the rows of
  ``[N, 8]`` (and transposed after), the eight column slices.
- grid (``exp_binning4.py:55-180``): the whole binning for enumeration
  layout (``R`` row-major, ``T`` transposed) × segment starts
  (``search``, ``hist``) × division (``int``, ``f32``).

Every variant is composed into a whole binning and held integer for
integer to the shipped call (``checks``): ``inst_rank``, ``inst_valid``,
``order``, ``seg_start``, ``counts``, ``counts_raw``, both overflow
counters and ``tier_counts``. E2 is held to the shipped call at the
adaptive layout. C2 selects a tier's rows by tier level and then index,
the shipped ranking by area: the two agree whenever no tier's demand
exceeds its row cap, and are held equal then; where a tier is
over-demanded C2 keeps other rows (not the largest) and is held to clip
at least as many tile slots as the shipped ranking.

Timing (``tools/measure.py:stage_times``): each item's CUDA-event span a
call over ``--iters`` calls after a warm-up, and its device time, the
summed kernels of ``--iters`` more calls under ``torch.profiler``. The
event span holds the host's gaps where the host enqueues slower than the
card runs; the device time does not.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import torch

from ..ops.binning import (_tier_layout, _tile_in_level_set,
                           adaptive_tier_layout, auto_instance_cap,
                           bin_instances_stream, rect_table,
                           stream_instance_bound)
from ..ops.stream import CHUNK
from . import measure
from .bench import HEIGHT, N, WIDTH, build_scene, project, raster_config
from .train_bench import WORKLOADS

I32 = torch.int32
FIELDS = ("inst_rank", "inst_valid", "order", "seg_start", "counts",
          "counts_raw", "overflow_tiles", "overflow_capacity", "tier_counts")
DIVISIONS = ("f32", "int", "recip")
LANE_ROWS = 50_000        # the tier gathers of the regress section


class Layout(NamedTuple):
    """The static shape of one binning: sizes, tier ladder, key bits."""
    n: int
    tiles_x: int
    tiles_y: int
    d: int
    cap: int
    tile_w: int
    tile_h: int
    budgets: tuple
    fracs: tuple
    caps: tuple
    rank_bits: int
    chunk: int = CHUNK

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def sentinel(self) -> int:
        return self.num_tiles << self.rank_bits


def make_layout(n: int, tiles_x: int, tiles_y: int, d: int, cap: int,
                tile_w: int, tile_h: int, tier_budgets=(4, 12),
                tier_fracs=(0.25, 0.1)) -> Layout:
    """The layout ``bin_instances_stream`` derives from its arguments; the
    stages cover its packed-key path (rank and tile bits within 31)."""
    budgets, caps = _tier_layout(n, d, tier_budgets, tier_fracs)
    rank_bits = max((n - 1).bit_length(), 1)
    if rank_bits + (tiles_x * tiles_y).bit_length() > 31:
        raise ValueError("the stages take the packed 31-bit key only")
    if d > 4096:
        raise ValueError("the f32 tile division needs budgets <= 4096")
    return Layout(n, tiles_x, tiles_y, d, cap, tile_w, tile_h,
                  tuple(budgets), tuple(tier_fracs)[:len(budgets)],
                  tuple(caps), rank_bits)


def shipped(p, lay: Layout, **kw) -> dict:
    """The whole call, ``ops/binning.py:bin_instances_stream``."""
    bins = bin_instances_stream(
        p, lay.tiles_x, lay.tiles_y, lay.d, lay.cap, chunk=lay.chunk,
        tile_w=lay.tile_w, tile_h=lay.tile_h, tier_budgets=lay.budgets,
        tier_fracs=lay.fracs, **kw)
    return {k: getattr(bins, k) for k in FIELDS}


# --- A, B, C ---------------------------------------------------------------

def stage_a(p):
    """A, the depth sort."""
    depth_key = torch.where(p.mask, p.depth, torch.inf)
    return torch.sort(depth_key, stable=True).indices.to(I32)


def stage_b(p, order):
    """B, the depth-ordered ``[N, 8]`` rect table; the ``[8, N]`` layout
    the enumeration reads is its transposed view."""
    return rect_table(p)[order]


def area_of(rect_o):
    """Tile-rect areas of the depth-ordered rows (0 where masked)."""
    rect_min = rect_o[:, 0:2].to(I32)
    rect_max = rect_o[:, 2:4].to(I32)
    span_x = torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=0)
    span_y = torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0)
    return torch.where(rect_o[:, 4] > 0, span_x * span_y, 0)


def stage_c(rect_o, lay: Layout):
    """C, the area ranking: (area, aorder, area_sorted), the rows by
    descending area with index tiebreak as one packed-key sort (the area
    fits the tile bits, so the key fits 31 bits); None, None for the flat
    layout."""
    area = area_of(rect_o)
    if not lay.budgets:
        return area, None, None
    rows0 = torch.arange(lay.n, dtype=I32, device=area.device)
    akey = ((lay.num_tiles - area) << lay.rank_bits) | rows0
    asorted = torch.sort(akey).values
    aorder = asorted & ((1 << lay.rank_bits) - 1)
    return area, aorder, lay.num_tiles - (asorted >> lay.rank_bits)


def stage_c2(rect_o, lay: Layout):
    """C2, the tier ranking by tier level (the number of budgets a row's
    area exceeds), descending, index tiebreak, as one packed-key sort; the
    ranked areas then take an element gather."""
    area = area_of(rect_o)
    if not lay.budgets:
        return area, None, None
    rows0 = torch.arange(lay.n, dtype=I32, device=area.device)
    level = torch.zeros_like(area)
    for b in lay.budgets:
        level += (area > b).to(I32)
    key = ((len(lay.budgets) - level) << lay.rank_bits) | rows0
    aorder = torch.sort(key).values & ((1 << lay.rank_bits) - 1)
    return area, aorder, area[aorder]


# --- D ---------------------------------------------------------------------

def divide(j, sx, div: str):
    """(j // sx, j mod sx) for 0 <= j < 2^12, 1 <= sx: the shipped f32
    division, integer div/mod, or the product by an f32 reciprocal."""
    if div == "int":
        return torch.div(j, sx, rounding_mode="floor"), j % sx
    jf = j.to(torch.float32) + 0.5
    if div == "f32":
        q = torch.floor(jf / sx.to(torch.float32)).to(I32)
    elif div == "recip":
        q = torch.floor(jf * (1.0 / sx.to(torch.float32))).to(I32)
    else:
        raise ValueError(f"unknown division {div!r}")
    return q, j - q * sx


def enumerate_tier(rows, lo: int, hi: int, row_area, row_rect, lay: Layout,
                   div: str = "f32", layout: str = "T"):
    """Packed keys of tile slots j in [lo, hi) of the depth ranks ``rows``,
    flat. ``layout`` "T" (shipped): ``row_rect`` is ``[8, M]`` and the keys
    ``[hi - lo, M]``; "R": ``row_rect`` is ``[M, 8]`` and the keys
    ``[M, hi - lo]``."""
    dev = rows.device
    j = lo + torch.arange(hi - lo, dtype=I32, device=dev)
    if layout == "T":
        j = j[:, None]
        rminx, rminy, rmaxx = (row_rect[k:k + 1, :].to(I32)
                               for k in (0, 1, 2))
        row_area, rk = row_area[None, :], rows[None, :]
    elif layout == "R":
        j = j[None, :]
        rminx, rminy, rmaxx = (row_rect[:, k:k + 1].to(I32)
                               for k in (0, 1, 2))
        row_area, rk = row_area[:, None], rows[:, None]
    else:
        raise ValueError(f"unknown layout {layout!r}")
    sx = torch.clamp(torch.clamp(rmaxx - rminx, min=0), min=1)
    q, r = divide(j, sx, div)
    ty = rminy + q
    tx = rminx + r
    valid = j < torch.clamp(row_area, max=hi)
    if layout == "T":
        valid &= _tile_in_level_set(row_rect[5:7].T, row_rect[7], tx.T,
                                    ty.T, lay.tile_w, lay.tile_h).T
    else:
        valid &= _tile_in_level_set(row_rect[:, 5:7], row_rect[:, 7], tx, ty,
                                    lay.tile_w, lay.tile_h)
    tid = torch.where(valid, ty * lay.tiles_x + tx, lay.num_tiles).to(I32)
    key = torch.where(valid, (tid << lay.rank_bits) | rk.expand(tid.shape),
                      lay.sentinel)
    return key.reshape(-1)


def stage_d(rect_o, area, aorder, area_sorted, lay: Layout,
            div: str = "f32", layout: str = "T"):
    """D, the tier enumeration: (keys, overflow_tiles). Tier 0 enumerates
    every row, tier t the first ``caps[t-1]`` rows of the ranking."""
    rect = rect_o.T if layout == "T" else rect_o
    rows0 = torch.arange(lay.n, dtype=I32, device=rect_o.device)
    if not lay.budgets:
        keys = enumerate_tier(rows0, 0, lay.d, area, rect, lay, div, layout)
        return keys, torch.clamp(area - lay.d, min=0).sum().to(I32)
    bounds = [0, *lay.budgets, lay.d]
    keys = []
    for t, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if t == 0:
            keys.append(enumerate_tier(rows0, lo, hi, area, rect, lay, div,
                                       layout))
            continue
        m = lay.caps[t - 1]
        rows = aorder[:m]
        sub = rect[:, rows] if layout == "T" else rect[rows]
        keys.append(enumerate_tier(rows, lo, hi, area_sorted[:m], sub, lay,
                                   div, layout))
    bud = torch.full((lay.n,), lay.budgets[0], dtype=I32,
                     device=rect_o.device)
    for t in range(1, len(bounds) - 1):
        bud[:lay.caps[t - 1]] = bounds[t + 1]
    overflow_tiles = torch.clamp(area_sorted - bud, min=0).sum().to(I32)
    return torch.cat(keys), overflow_tiles


# --- E, F ------------------------------------------------------------------

def stage_e(keys):
    """E, the packed-key sort (keys are unique: one unstable sort)."""
    return torch.sort(keys).values


def f_search(sorted_key, lay: Layout):
    """F's segment starts by ``searchsorted``: (seg_start [T], n_valid
    [1])."""
    dev = sorted_key.device
    probes = torch.arange(lay.num_tiles, dtype=I32, device=dev) \
        << lay.rank_bits
    seg_start = torch.searchsorted(sorted_key, probes, side="left",
                                   out_int32=True)
    end = torch.tensor([lay.sentinel], dtype=I32, device=dev)
    return seg_start, torch.searchsorted(sorted_key, end, side="left",
                                         out_int32=True)


def f_hist(sorted_key, lay: Layout):
    """F's segment starts by ``bincount`` of the tile ids and a
    ``cumsum``: (seg_start [T], n_valid [1])."""
    counts = torch.bincount(sorted_key >> lay.rank_bits,
                            minlength=lay.num_tiles + 1)
    seg = torch.cumsum(counts, 0).to(I32)
    n_valid = seg[lay.num_tiles - 1:lay.num_tiles]
    return torch.cat([seg.new_zeros(1), seg[:lay.num_tiles - 1]]), n_valid


def f_tail(sorted_key, seg_start, n_valid, lay: Layout) -> dict:
    """F's tail: counts clipped at the capacity, the overflow, and the
    ``[CAP + CHUNK]`` instance slots."""
    counts_raw = torch.cat([seg_start[1:], n_valid]) - seg_start
    counts = torch.minimum(torch.clamp(lay.cap - seg_start, min=0),
                           counts_raw)
    overflow_capacity = (counts_raw.sum() - counts.sum()).to(I32)
    seg_start = torch.clamp(seg_start, max=lay.cap)
    total = lay.cap + lay.chunk
    m = sorted_key.shape[0]
    sk = (sorted_key[:total] if m >= total else torch.cat([
        sorted_key, torch.full((total - m,), lay.sentinel, dtype=I32,
                               device=sorted_key.device)]))
    q = torch.arange(total, dtype=I32, device=sorted_key.device)
    valid_q = q < torch.clamp(n_valid, max=lay.cap)
    inst_rank = torch.where(valid_q, sk & ((1 << lay.rank_bits) - 1), 0)
    return {"inst_rank": inst_rank, "inst_valid": valid_q,
            "seg_start": seg_start, "counts": counts,
            "counts_raw": counts_raw,
            "overflow_capacity": overflow_capacity}


def stage_f(sorted_key, lay: Layout, seg: str = "search") -> dict:
    """F, the segment starts (``search`` shipped, or ``hist``) and the
    tail."""
    starts = {"search": f_search, "hist": f_hist}[seg]
    return f_tail(sorted_key, *starts(sorted_key, lay), lay)


def tier_counts(area, lay: Layout):
    """Per budget, the rows whose area exceeds it (the tier demand)."""
    if not lay.budgets:
        return torch.zeros((0,), dtype=I32, device=area.device)
    return torch.stack([(area > b).sum() for b in lay.budgets]).to(I32)


def chain(p, lay: Layout, rank: str = "area", div: str = "f32",
          layout: str = "T", seg: str = "search") -> dict:
    """The whole binning composed of stages A-F, with the named variant of
    a stage in place of the shipped one (the defaults are the shipped
    stages)."""
    order = stage_a(p)
    rect_o = stage_b(p, order)
    area, aorder, area_sorted = {"area": stage_c,
                                 "level": stage_c2}[rank](rect_o, lay)
    keys, overflow_tiles = stage_d(rect_o, area, aorder, area_sorted, lay,
                                   div, layout)
    out = stage_f(stage_e(keys), lay, seg)
    return dict(out, order=order, overflow_tiles=overflow_tiles,
                tier_counts=tier_counts(area, lay))


def equal(a: dict, b: dict) -> bool:
    """Whether two binnings agree integer for integer on every field."""
    return all(a[k].shape == b[k].shape and bool(torch.equal(a[k], b[k]))
               for k in FIELDS)


def c2_check(level: dict, whole: dict, demand, lay: Layout) -> bool:
    """C2 against the shipped binning: equal where every tier's demand fits
    its cap; else clipping no fewer tile slots."""
    if all(int(c) <= cap for c, cap in zip(demand, lay.caps)):
        return equal(level, whole)
    return int(level["overflow_tiles"]) >= int(whole["overflow_tiles"])


def size_of(workload: str):
    if workload == "1080p":
        return WIDTH, HEIGHT, N
    wl = WORKLOADS[workload]
    return wl["width"], wl["height"], wl["n"]


def run(workload: str = "1080p", iters: int = 10, device="cuda",
        width: int = 0, height: int = 0, n: int = 0) -> dict:
    """The experiment's JSON record. ``width``/``height``/``n`` (0: the
    workload's) shrink it for tests."""
    device = torch.device(device)
    w0, h0, n0 = size_of(workload)
    width, height, n = width or w0, height or h0, n or n0
    cfg = raster_config(False)
    tiles_x, tiles_y = -(-width // cfg.tile_w), -(-height // cfg.tile_h)
    d = cfg.max_tiles_per_gaussian
    cap = auto_instance_cap(n, d, cfg.tile_w, cfg.tile_h, cfg.tier_budgets,
                            cfg.tier_fracs)
    lay = make_layout(n, tiles_x, tiles_y, d, cap, cfg.tile_w, cfg.tile_h,
                      cfg.tier_budgets, cfg.tier_fracs)
    cam, arrays = build_scene(n, width, height, device=device)
    with torch.no_grad():
        return _run(project(arrays, cam, width, height, cfg), lay, iters,
                    device, f"{width}x{height}, {n} gaussians")


def _run(p, lay: Layout, iters: int, device, label: str) -> dict:
    order = stage_a(p)
    rect_o = stage_b(p, order)
    area, aorder, area_sorted = stage_c(rect_o, lay)
    keys, _ = stage_d(rect_o, area, aorder, area_sorted, lay)
    sorted_key = stage_e(keys)
    seg_start, n_valid = f_search(sorted_key, lay)
    whole = shipped(p, lay)
    demand = tier_counts(area, lay).tolist()

    # E2: the layout sized from this frame's needs (the areas)
    d_a, budgets_a, fracs_a, n_clip = adaptive_tier_layout(
        area.cpu().numpy(), lay.d, lay.budgets, lay.fracs)
    lay_a = make_layout(lay.n, lay.tiles_x, lay.tiles_y, d_a, lay.cap,
                        lay.tile_w, lay.tile_h, budgets_a, fracs_a)
    keys_a, _ = stage_d(rect_o, area, aorder, area_sorted, lay_a)

    rect_oT = rect_o.T.contiguous()
    lane_rows = torch.arange(min(LANE_ROWS, lay.n), dtype=I32,
                             device=device)
    stages = {
        "A_depth_sort": lambda: stage_a(p),
        "B_rect_gather": lambda: stage_b(p, order).T,
        "C_area_rank": lambda: stage_c(rect_o, lay),
        "D_enumerate": lambda: stage_d(rect_o, area, aorder, area_sorted,
                                       lay),
        "E_sort": lambda: stage_e(keys),
        "F_segments": lambda: stage_f(sorted_key, lay),
        "whole": lambda: shipped(p, lay),
        "C2_level_rank": lambda: stage_c2(rect_o, lay),
        "D2_enumerate_int": lambda: stage_d(rect_o, area, aorder,
                                            area_sorted, lay, "int"),
        "D2_enumerate_recip": lambda: stage_d(rect_o, area, aorder,
                                              area_sorted, lay, "recip"),
        "D3_enumerate_adaptive": lambda: stage_d(rect_o, area, aorder,
                                                 area_sorted, lay_a),
        "E2_sort_adaptive": lambda: stage_e(keys_a),
        # exp_binning2
        "D_enumerate_rowmajor": lambda: stage_d(rect_o, area, aorder,
                                                area_sorted, lay, "f32",
                                                "R"),
        "DE_enumerate_sort": lambda: stage_e(stage_d(
            rect_o, area, aorder, area_sorted, lay)[0]),
        "F_search": lambda: f_search(sorted_key, lay),
        "F_hist": lambda: f_hist(sorted_key, lay),
        "F_tail": lambda: f_tail(sorted_key, seg_start, n_valid, lay),
        # exp_binning3
        "whole_order_given": lambda: shipped(p, lay, order=order,
                                             rect_ordered=rect_o),
        "transpose": lambda: rect_o.T.contiguous(),
        "lane_gather": lambda: rect_oT[:, lane_rows],
        "row_gather": lambda: rect_o[lane_rows],
        "row_gather_transposed": lambda: rect_o[lane_rows].T.contiguous(),
        "column_slices": lambda: [rect_o[:, k].contiguous()
                                  for k in range(8)],
    }
    grid = [(layout, div, seg) for layout in ("R", "T")
            for div in ("int", "f32") for seg in ("search", "hist")]
    for layout, div, seg in grid:
        stages[f"grid_{layout}_{div}_{seg}"] = (
            lambda v=(div, layout, seg): chain(p, lay, "area", *v))
    times = measure.stage_times(stages, iters, device)

    level = chain(p, lay, rank="level")
    checks = {"chain_equals_whole": equal(chain(p, lay), whole),
              "whole_order_given": equal(
                  shipped(p, lay, order=order, rect_ordered=rect_o), whole),
              "C2_level_rank": c2_check(level, whole, demand, lay),
              "E2_adaptive": equal(chain(p, lay_a), shipped(p, lay_a)),
              "F_hist_starts": all(bool(torch.equal(a, b)) for a, b in zip(
                  f_hist(sorted_key, lay), (seg_start, n_valid)))}
    for div in DIVISIONS[1:]:
        checks[f"D2_{div}_keys"] = bool(torch.equal(stage_d(
            rect_o, area, aorder, area_sorted, lay, div)[0], keys))
    for layout, div, seg in grid:
        checks[f"grid_{layout}_{div}_{seg}"] = equal(
            chain(p, lay, "area", div, layout, seg), whole)
    a_f = [times[k] for k in ("A_depth_sort", "B_rect_gather",
                              "C_area_rank", "D_enumerate", "E_sort",
                              "F_segments")]
    sum_a_f = {"ms": sum(t["ms"] for t in a_f),
               "device_ms": (None if any(t["device_ms"] is None
                                         for t in a_f)
                             else sum(t["device_ms"] for t in a_f))}
    return {
        "experiment": "exp_binning",
        "workload": label,
        "device": measure.device_name(device),
        "card": measure.card() if device.type == "cuda" else None,
        "clock": (("CUDA events" if device.type == "cuda" else "host")
                  + f", mean of {iters} after a warm-up; device_ms from "
                  "torch.profiler over as many calls"),
        "tiles": lay.num_tiles,
        "instance_cap": lay.cap,
        "bound_static": stream_instance_bound(lay.n, lay.d, lay.budgets,
                                              lay.fracs),
        "keys": int(keys.numel()),
        "live_keys": int((keys != lay.sentinel).sum()),
        "load": int(whole["counts"].sum()),
        "tier_demand": demand,
        "tier_caps": list(lay.caps),
        "overflow_tiles": int(whole["overflow_tiles"]),
        "overflow_capacity": int(whole["overflow_capacity"]),
        "c2_overflow_tiles": int(level["overflow_tiles"]),
        "adaptive": {"d": d_a, "budgets": list(budgets_a),
                     "fracs": list(fracs_a), "clipped": n_clip,
                     "bound": stream_instance_bound(lay.n, d_a, budgets_a,
                                                    fracs_a),
                     "keys": int(keys_a.numel())},
        "stages": times,
        "sum_a_f": sum_a_f,
        "checks": checks,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=["1080p", *sorted(WORKLOADS)],
                    default="1080p",
                    help="1080p (1920x1088, 200K) or a train_bench "
                         "workload's size")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    result = run(args.workload, args.iters,
                 measure.checked_device(args.device))
    print(json.dumps(result), flush=True)
    if not all(result["checks"].values()):
        sys.exit(f"exp_binning: checks failed: {result['checks']}")
    return result


if __name__ == "__main__":
    main()
