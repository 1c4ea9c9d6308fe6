"""Tile binning: the tile-sorted instance stream and the padded per-tile
tables.

Port of the JAX package's ``ops/binning.py``:

- :func:`bin_instances_stream` and the host-side layout helpers (the stream
  backend). Gaussians are depth-sorted once, each emits its tile instances
  under tiered per-Gaussian budgets, and one sort on a packed ``(tile <<
  rank_bits) | rank`` int32 key yields contiguous, depth-ordered per-tile
  segments that the stream composite reads in place.
- :func:`bin_gaussians` (the padded ``"jnp"`` / ``"pallas"`` backends):
  every Gaussian emits a flat budget of ``max_tiles_per_gaussian`` tile
  instances, enumerated in blocks of Gaussians; one sort orders the valid
  ones by (tile, depth), and each tile takes its ``tile_capacity``
  front-most entries into a ``[T, K]`` table.

Every truncation is counted (``overflow_tiles``, ``overflow_capacity``),
never silent.

The layout helpers (:func:`_tier_layout`, :func:`stream_instance_bound`,
:func:`auto_instance_cap`, :func:`adaptive_tier_layout`) are host-side
Python and numpy, as in the JAX package. :func:`bin_instances_stream` runs
on the device with static shapes and no host synchronisation; every index
it gathers with is in range by construction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .preprocess import Processed


def _tile_in_level_set(xy, cull_r2, tx, ty, tile_w: int, tile_h: int):
    """True if the tile's pixel rect intersects the splat's alpha >= 1/255
    level-set disc (squared max radius ``cull_r2``). Exactly conservative:
    pixels of culled tiles fail the compositing alpha test anyway.

    xy [N, 2] f32; cull_r2 [N] f32; tx, ty [N, d] int32.
    """
    x = xy[:, 0:1]
    y = xy[:, 1:2]
    tx_px = tx.to(torch.float32) * tile_w
    ty_px = ty.to(torch.float32) * tile_h
    dx = torch.clamp(torch.maximum(tx_px - x, x - (tx_px + tile_w - 1)), min=0.0)
    dy = torch.clamp(torch.maximum(ty_px - y, y - (ty_px + tile_h - 1)), min=0.0)
    return dx * dx + dy * dy <= cull_r2[:, None]


class TileBins(NamedTuple):
    gauss_idx: torch.Tensor          # [T, K] int32 Gaussian index (0 if padded)
    valid: torch.Tensor              # [T, K] bool
    counts: torch.Tensor             # [T] int32 intersections (pre-cap)
    overflow_tiles: torch.Tensor     # int32: tiles dropped by the budget
    overflow_capacity: torch.Tensor  # int32: entries dropped by the capacity


# bin_gaussians enumerates about this many instances at a time
ENUM_BLOCK = 1 << 24


def bin_gaussians(processed: Processed, tiles_x: int, tiles_y: int,
                  max_tiles_per_gaussian: int, tile_capacity: int,
                  tile_w: int = 16, tile_h: int = 16) -> TileBins:
    """Padded per-tile tables: up to ``max_tiles_per_gaussian`` tile
    instances per visible Gaussian in row-major rect order (culled to the
    alpha >= 1/255 level set), ordered by (tile, depth) with ties by
    Gaussian index, the first ``tile_capacity`` of each tile kept.

    The JAX package sorts (tile, depth, index) triples stably; here one
    int64 key ``tile · N + depth_rank`` (depth rank from a stable depth sort,
    so ties keep index order) gives the same order. The ``[N, d]``
    enumeration runs over blocks of Gaussians of about ``ENUM_BLOCK``
    instances each, and each block keeps only its valid keys, so peak
    memory follows the instances that exist, not N·d (one host
    synchronisation per block); the kept keys are sorted at once."""
    n = processed.xy.shape[0]
    d = max_tiles_per_gaussian
    num_tiles = tiles_x * tiles_y
    dev = processed.xy.device
    i32 = torch.int32

    rect_min, rect_max = processed.rect_min, processed.rect_max
    span_x = torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=0)
    span_y = torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0)
    area = torch.where(processed.mask, span_x * span_y, 0)
    overflow_tiles = torch.clamp(area - d, min=0).sum().to(i32)

    depth_key = torch.where(processed.mask, processed.depth.detach(),
                            torch.inf)
    order = torch.sort(depth_key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)

    j = torch.arange(d, dtype=i32, device=dev)[None, :]         # [1, d]
    xy, cull_r2 = processed.xy.detach(), processed.cull_r2.detach()
    rows = max(1, ENUM_BLOCK // max(d, 1))
    parts = [torch.zeros(0, dtype=torch.int64, device=dev)]
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        span_x_safe = torch.clamp(span_x[sl], min=1)[:, None]
        ty = rect_min[sl, 1, None] + torch.div(j, span_x_safe,
                                               rounding_mode="floor")
        tx = rect_min[sl, 0, None] + j % span_x_safe
        live = j < torch.clamp(area[sl], max=d)[:, None]         # [rows, d]
        live &= _tile_in_level_set(xy[sl], cull_r2[sl], tx, ty, tile_w,
                                   tile_h)
        keys = (ty * tiles_x + tx).long() * n + rank[sl, None]
        parts.append(keys[live])
        del tx, ty, live, keys
    keys = torch.sort(torch.cat(parts)).values
    del parts

    bounds = torch.arange(num_tiles + 1, device=dev) * n
    edges = torch.searchsorted(keys, bounds)                      # [T + 1]
    starts = edges[:-1]
    counts = (edges[1:] - starts).to(i32)

    k = torch.arange(tile_capacity, device=dev)[None, :]
    valid = k < torch.clamp(counts, max=tile_capacity)[:, None]   # [T, K]
    take = torch.clamp(starts[:, None] + k, max=max(keys.numel() - 1, 0))
    gauss_idx = (torch.where(valid, order[keys[take] % n], 0).to(i32)
                 if keys.numel() else torch.zeros(valid.shape, dtype=i32,
                                                  device=dev))
    overflow_capacity = torch.clamp(counts - tile_capacity,
                                    min=0).sum().to(i32)
    return TileBins(gauss_idx=gauss_idx, valid=valid, counts=counts,
                    overflow_tiles=overflow_tiles,
                    overflow_capacity=overflow_capacity)


class StreamBins(NamedTuple):
    """Instance-stream layout: the tile-sorted instance list itself.

    Instances are identified by their DEPTH RANK (row into the depth-sorted
    Gaussian order); ``order[inst_rank]`` recovers Gaussian indices."""

    inst_rank: torch.Tensor      # [CAP + CHUNK] int32 depth rank per slot
    inst_valid: torch.Tensor     # [CAP + CHUNK] bool
    order: torch.Tensor          # [N] int32 depth-ascending Gaussian order
    seg_start: torch.Tensor      # [T] int32 segment offsets (unaligned)
    counts: torch.Tensor         # [T] int32 valid instances per tile (clipped)
    counts_raw: torch.Tensor     # [T] int32 pre-clip intersection counts
    overflow_tiles: torch.Tensor
    overflow_capacity: torch.Tensor
    # visible Gaussians dropped by RasterConfig.visible_cap truncation
    overflow_visible: torch.Tensor = torch.zeros((), dtype=torch.int32)
    # per-frame tier demand: count of rows with rect area > tier_budgets[i]
    tier_counts: torch.Tensor = torch.zeros((0,), dtype=torch.int32)


def _tier_layout(n: int, max_tiles_per_gaussian: int, tier_budgets,
                 tier_fracs):
    """(budgets, caps) for the tiered enumeration; validates nesting.

    caps are the area-rank prefix lengths per upgraded tier,
    min(n, max(512, n·frac)); fracs must be non-increasing (nested
    prefixes), or a Gaussian's high tile slots would be enumerated without
    its middle ones."""
    d = max_tiles_per_gaussian
    budgets = [int(b) for b in tier_budgets if int(b) < d]
    fracs = tuple(tier_fracs)[:len(budgets)]
    if any(f2 > f1 for f1, f2 in zip(fracs, fracs[1:])):
        raise ValueError(f"tier_fracs must be non-increasing (nested "
                         f"prefixes), got {tier_fracs}")
    caps = [min(n, max(512, int(n * f))) for f in fracs]
    return budgets, caps


def stream_instance_bound(n: int, max_tiles_per_gaussian: int,
                          tier_budgets=(4, 12),
                          tier_fracs=(0.25, 0.1)) -> int:
    """Exact worst-case instance-slot count of :func:`bin_instances_stream`
    for ``n`` Gaussians (every Gaussian filling its tier budget)."""
    d = max_tiles_per_gaussian
    budgets, caps = _tier_layout(n, d, tier_budgets, tier_fracs)
    if not budgets:
        return n * d
    bounds = [0] + budgets + [d]
    total = n * budgets[0]
    for t in range(1, len(bounds) - 1):
        total += caps[t - 1] * (bounds[t + 1] - bounds[t])
    return total


def auto_instance_cap(n: int, max_tiles_per_gaussian: int, tile_w: int,
                      tile_h: int, tier_budgets=(4, 12),
                      tier_fracs=(0.25, 0.1)) -> int:
    """Default stream instance capacity (CHUNK-aligned): ~1.5× the expected
    tiles per Gaussian for a typical footprint, clipped to the exact tier
    bound; shortfall is counted in overflow_capacity."""
    bound = stream_instance_bound(n, max_tiles_per_gaussian, tier_budgets,
                                  tier_fracs)
    k = 1.5 * (1.0 + 21.0 / tile_w) * (1.0 + 21.0 / tile_h)
    cap = min(max(int(k * n), 1024), bound)
    return cap + (-cap) % 128


_FRAC_GRID = (0.0, 1 / 256, 1 / 128, 1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4,
              1 / 2, 1.0)


def adaptive_tier_layout(needs, max_tiles_per_gaussian: int, tier_budgets,
                         tier_fracs, margin: float = 1.1,
                         slot_limit: int = 16_000_000,
                         quantize: bool = False):
    """Size a tier layout from MEASURED per-Gaussian tile needs so that no
    splat is clipped to a partial tile patch (offline-eval use).

    ``needs``: per-Gaussian worst-case tile count over the eval cameras.
    Returns ``(d, budgets, fracs, n_clipped)``: the (possibly escalated) top
    budget, the filtered budget ladder, per-tier fracs (elementwise max of
    the measured counts and the caller's ``tier_fracs``), and the number of
    rows whose need still exceeds their budget after the ``slot_limit``
    memory guard (callers must surface a nonzero count). ``quantize`` rounds
    fracs up to a coarse grid before the guard, as every eval surface does.
    """
    needs = np.asarray(needs)
    n = int(needs.shape[0])
    need_max = int(needs.max()) if n else 0
    d = int(max_tiles_per_gaussian)
    while d < need_max:
        d *= 2
    budgets = tuple(int(b) for b in tier_budgets if int(b) < d)
    if not budgets:                       # flat layout: every row gets d
        bound = n * d
        n_clipped = 0
        if bound > slot_limit:
            d = max(1, slot_limit // max(n, 1))
            n_clipped = int((needs > d).sum())
        return d, (), (), n_clipped

    counts = [int((needs > b).sum()) for b in budgets]
    base = tuple(tier_fracs)[:len(budgets)] + (0.0,) * (len(budgets)
                                                        - len(tier_fracs))
    fracs = [min(1.0, max(f, margin * c / max(n, 1)))
             for f, c in zip(base, counts)]
    if quantize:
        fracs = [next(q for q in _FRAC_GRID if f <= q) for f in fracs]

    def caps_of(fr):
        return [min(n, max(512, int(n * f))) for f in fr]

    bound = stream_instance_bound(n, d, budgets, fracs)
    if bound > slot_limit:
        # Scale the adaptive surplus back toward the caller's fracs until the
        # bound fits; count what that clips.
        lo, hi = 0.0, 1.0
        for _ in range(30):
            mid = (lo + hi) / 2
            trial = [b + mid * (a - b) for a, b in zip(fracs, base)]
            if stream_instance_bound(n, d, budgets, trial) <= slot_limit:
                lo = mid
            else:
                hi = mid
        fracs = [b + lo * (a - b) for a, b in zip(fracs, base)]
        if stream_instance_bound(n, d, budgets, fracs) > slot_limit:
            # Even the caller's fracs exceed the limit: shrink the ladder.
            s_lo, s_hi = 0.0, 1.0
            for _ in range(30):
                mid = (s_lo + s_hi) / 2
                trial = [f * mid for f in fracs]
                if stream_instance_bound(n, d, budgets, trial) <= slot_limit:
                    s_lo = mid
                else:
                    s_hi = mid
            fracs = [f * s_lo for f in fracs]
            if stream_instance_bound(n, d, budgets, fracs) > slot_limit:
                # the floor term n·budgets[0] alone exceeds the limit
                d_flat = max(1, slot_limit // max(n, 1))
                n_clipped = int((needs > d_flat).sum())
                return d_flat, (), (), n_clipped
        caps = caps_of(fracs)
        order = np.argsort(-needs, kind="stable")
        assigned = np.full(n, budgets[0], np.int64)
        ladder = list(budgets[1:]) + [d]
        for cap, b in zip(caps, ladder):
            assigned[order[:cap]] = b
        n_clipped = int((needs > assigned).sum())
    else:
        n_clipped = 0
    return d, budgets, tuple(fracs), n_clipped


def rect_table(processed: Processed) -> torch.Tensor:
    """[N, 8] f32 rect/cull row per Gaussian (rect_min, rect_max, mask, xy,
    cull_r2); rect coords as f32 are exact below 2^24."""
    return torch.cat(
        [processed.rect_min.to(torch.float32),
         processed.rect_max.to(torch.float32),
         processed.mask[:, None].to(torch.float32),
         processed.xy, processed.cull_r2[:, None]], dim=1)


def bin_instances_stream(processed: Processed, tiles_x: int, tiles_y: int,
                         max_tiles_per_gaussian: int, cap: int,
                         chunk: int = 128, tile_w: int = 16,
                         tile_h: int = 16,
                         tier_budgets=(4, 12),
                         tier_fracs=(0.25, 0.1),
                         round_robin: int = 0,
                         order: Optional[torch.Tensor] = None,
                         rect_ordered: Optional[torch.Tensor] = None
                         ) -> StreamBins:
    """Depth-presorted, single-key tile sort consumed in segment layout.

    Tiered budgets: every Gaussian gets ``tier_budgets[0]`` tile slots, the
    largest ``tier_fracs[0]·N`` by rect area get ``tier_budgets[1]``, …, the
    largest ``tier_fracs[-1]·N`` the full ``max_tiles_per_gaussian``
    (nested area-rank prefixes, each floored at min(N, 512)). Shortfall is
    counted in ``overflow_tiles``. ``tier_budgets=()`` is the flat layout.

    ``round_robin=D`` (D > 0) sorts tile ids destination-major: tile ``t``
    sorts under ``(t mod D)·⌈T/D⌉ + t div D``, so the tiles of round-robin
    shard d (t ≡ d mod D) form one contiguous span of the stream, ready for
    a fixed-quota exchange (``parallel/gauss_stream.py``). ``seg_start`` and
    ``counts`` then have length ``D·⌈T/D⌉``; position k is tile
    ``(k mod ⌈T/D⌉)·D + k div ⌈T/D⌉`` (pad positions are empty).

    ``order``/``rect_ordered``: optional precomputed depth order
    (``argsort(where(mask, depth, inf))``, or a prefix of it) and the
    matching rows of :func:`rect_table`; ``inst_rank`` indexes ``order``.
    ``chunk`` slack slots at the tail keep the JAX package's layout.
    """
    n = order.shape[0] if order is not None else processed.xy.shape[0]
    dev = processed.xy.device
    d = max_tiles_per_gaussian
    num_tiles = tiles_x * tiles_y
    t_per_rr = -(-num_tiles // round_robin) if round_robin else 0
    t_out = round_robin * t_per_rr if round_robin else num_tiles
    i32 = torch.int32

    if order is None:
        depth_key = torch.where(processed.mask, processed.depth, torch.inf)
        order = torch.sort(depth_key, stable=True).indices.to(i32)
    if rect_ordered is None:
        rect_ordered = rect_table(processed)[order]              # [N, 8]
    rect_oT = rect_ordered.T                                     # [8, N]
    rect_min = rect_ordered[:, 0:2].to(i32)
    rect_max = rect_ordered[:, 2:4].to(i32)
    mask_o = rect_ordered[:, 4] > 0
    span_x = torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=0)
    span_y = torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0)
    area = torch.where(mask_o, span_x * span_y, 0)

    rank_bits = max((n - 1).bit_length(), 1)
    tile_bits = t_out.bit_length()
    packed = rank_bits + tile_bits <= 31
    sentinel = (t_out << rank_bits) if packed else t_out
    # floor((j + 0.5)·(1/sx)) in f32 equals j // sx exactly for j, sx < 2^12
    if d > 4096:
        raise ValueError("the f32 tile division needs budgets <= 4096")

    def enumerate_tier(rows, lo: int, hi: int, row_area, row_rectT):
        """Keys for tile slots j in [lo, hi) of the Gaussians ``rows``
        (depth ranks); row_rectT [8, M]. Returns flat [(hi-lo)·M] packed
        keys, or (tile, rank) pairs when the key does not fit 31 bits."""
        j = (lo + torch.arange(hi - lo, dtype=i32, device=dev))[:, None]
        rminx = row_rectT[0:1, :].to(i32)
        rminy = row_rectT[1:2, :].to(i32)
        rmaxx = row_rectT[2:3, :].to(i32)
        sx = torch.clamp(torch.clamp(rmaxx - rminx, min=0), min=1)
        q = torch.floor((j.to(torch.float32) + 0.5)
                        / sx.to(torch.float32)).to(i32)
        ty = rminy + q
        tx = rminx + (j - q * sx)
        valid = j < torch.clamp(row_area, max=hi)[None, :]
        valid &= _tile_in_level_set(row_rectT[5:7].T, row_rectT[7], tx.T,
                                    ty.T, tile_w, tile_h).T
        tid = ty * tiles_x + tx
        if round_robin:
            tid = (tid % round_robin) * t_per_rr + tid // round_robin
        tid = torch.where(valid, tid, t_out).to(i32)
        rk = rows[None, :].expand(tid.shape)
        if packed:
            key = torch.where(valid, (tid << rank_bits) | rk, sentinel)
            return key.reshape(-1), None
        return tid.reshape(-1), rk.reshape(-1)

    budgets, caps = _tier_layout(n, d, tier_budgets, tier_fracs)
    rows0 = torch.arange(n, dtype=i32, device=dev)
    if budgets:
        # Area ranking, descending with index tiebreak (= stable argsort of
        # -area), as one packed-key sort when it fits 31 bits.
        area_bits = num_tiles.bit_length()
        if rank_bits + area_bits <= 31:
            akey = ((num_tiles - area) << rank_bits) | rows0
            asorted = torch.sort(akey).values
            aorder = asorted & ((1 << rank_bits) - 1)
            area_sorted = num_tiles - (asorted >> rank_bits)
        else:
            aorder = torch.sort(-area, stable=True).indices.to(i32)
            area_sorted = area[aorder]
        bounds = [0] + budgets + [d]
        keys, ranks = [], []
        for t, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            if t == 0:
                k, r = enumerate_tier(rows0, lo, hi, area, rect_oT)
            else:
                m = caps[t - 1]
                rows = aorder[:m]
                k, r = enumerate_tier(rows, lo, hi, area_sorted[:m],
                                      rect_oT[:, rows])
            keys.append(k)
            ranks.append(r)
        tile_or_key = torch.cat(keys)
        rank_flat = None if packed else torch.cat(ranks)
        # budget granted per area-rank position (static prefixes)
        bud = torch.full((n,), budgets[0], dtype=i32, device=dev)
        for t in range(1, len(bounds) - 1):
            bud[:caps[t - 1]] = bounds[t + 1]
        overflow_tiles = torch.clamp(area_sorted - bud, min=0).sum().to(i32)
    else:
        tile_or_key, rank_flat = enumerate_tier(rows0, 0, d, area, rect_oT)
        overflow_tiles = torch.clamp(area - d, min=0).sum().to(i32)

    tile_range = torch.arange(t_out, dtype=i32, device=dev)
    if packed:
        # Rank low bits make every key unique: one unstable single-key sort
        # gives the stable (tile, depth) order.
        sorted_key = torch.sort(tile_or_key).values
        sorted_for_search = sorted_key
        probes = tile_range << rank_bits
        end_probe = t_out << rank_bits
    else:
        # (tile, rank) pairs are unique too; rank is the second sort key.
        by_rank = torch.sort(rank_flat, stable=True)
        by_tile = torch.sort(tile_or_key[by_rank.indices], stable=True)
        sorted_for_search = by_tile.values
        sorted_rank = by_rank.values[by_tile.indices]
        probes = tile_range
        end_probe = t_out

    seg_start = torch.searchsorted(sorted_for_search, probes, side="left",
                                   out_int32=True)
    end = torch.tensor([end_probe], dtype=i32, device=dev)
    n_valid = torch.searchsorted(sorted_for_search, end, side="left",
                                 out_int32=True)
    counts_raw = torch.cat([seg_start[1:], n_valid]) - seg_start

    # Segments past `cap` are truncated depth-last per tile, and counted; a
    # tile whose segment starts past `cap` gets count 0 and start `cap`.
    counts = torch.minimum(torch.clamp(cap - seg_start, min=0), counts_raw)
    overflow_capacity = (counts_raw.sum() - counts.sum()).to(i32)
    seg_start = torch.clamp(seg_start, max=cap)

    total = cap + chunk
    if packed:
        m = sorted_key.shape[0]
        sk = (sorted_key[:total] if m >= total else torch.cat([
            sorted_key, torch.full((total - m,), sentinel, dtype=i32,
                                   device=dev)]))
        sr = sk & ((1 << rank_bits) - 1)
    else:
        m = sorted_rank.shape[0]
        sr = (sorted_rank[:total] if m >= total else torch.cat([
            sorted_rank, torch.zeros(total - m, dtype=i32, device=dev)]))
    q = torch.arange(total, dtype=i32, device=dev)
    valid_q = q < torch.clamp(n_valid, max=cap)
    inst_rank = torch.where(valid_q, sr, 0)

    if budgets:
        tier_counts = torch.stack([(area > b).sum() for b in budgets]).to(i32)
    else:
        tier_counts = torch.zeros((0,), dtype=i32, device=dev)

    return StreamBins(inst_rank=inst_rank, inst_valid=valid_q, order=order,
                      seg_start=seg_start, counts=counts,
                      counts_raw=counts_raw,
                      overflow_tiles=overflow_tiles,
                      overflow_capacity=overflow_capacity,
                      tier_counts=tier_counts)
