"""Tiled rasterizer, stream path: preprocess → bin → pack → composite →
assemble.

Port of the stream path of the JAX package's ``ops/rasterize.py``. The
packed attribute stream ``[16, CAP + 128]`` is built by one depth-order
gather of a per-Gaussian table and one per-instance gather; the composite
is :func:`ops.stream.composite_stream` (the CUDA kernel on a card, its plain
version on the CPU).

Not ported yet: the padded ``"jnp"`` and ``"pallas"`` backends, and the
gather's backward (the training slice).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .binning import auto_instance_cap, bin_instances_stream, rect_table
from .preprocess import Processed
from .stream import CHUNK, ROWS, composite_stream


class RasterConfig(NamedTuple):
    tile_w: int = 16
    tile_h: int = 16
    max_tiles_per_gaussian: int = 32
    tile_capacity: int = 512
    tile_batch: int = 64
    backend: str = "auto"  # "stream" | "auto" (= "stream" on every device)
    # Stream backend: packed instance slots. None = auto-size (see
    # binning.auto_instance_cap); shortfall is counted in overflow_capacity.
    instance_cap: Optional[int] = None
    # Tiered per-Gaussian tile budgets: every Gaussian gets tier_budgets[0]
    # slots; the largest tier_fracs[i]·N by rect area get tier_budgets[i+1]
    # (nested prefixes, max_tiles_per_gaussian last). () = flat budget.
    tier_budgets: tuple = (4, 12)
    tier_fracs: tuple = (0.25, 0.1)
    # Fast-math compositing is a training-time trade; the port composites
    # in exact mode only so far.
    fast_math: bool = False
    # Visible-prefix compaction: a static bound on the visible Gaussian
    # count. The order is truncated to it; dropped visible rows (the
    # farthest) are counted in overflow_visible. None = off.
    visible_cap: Optional[int] = None


def widen_eval_budgets(cfg: RasterConfig) -> RasterConfig:
    """Generous per-Gaussian tile budgets for EVAL surfaces: d >= 512 and a
    wide tier ladder, so reported images come from the full-footprint
    operator. Residual clipping is still counted in overflow_tiles."""
    if cfg.max_tiles_per_gaussian < 512:
        cfg = cfg._replace(max_tiles_per_gaussian=512)
    # () is the flat layout and already the most generous one.
    if len(cfg.tier_budgets) in (1, 2):
        cfg = cfg._replace(tier_budgets=(4, 12, 64),
                           tier_fracs=(0.25, 0.1, 0.01))
    return cfg


def _gather_inst_rows(table, inst_rank, inst_valid):
    """attrs[:, i] = table[inst_rank[i]] where valid, else 0: the packed
    stream [W, CAP + CHUNK], attribute-major. ``inst_rank`` is in range by
    construction (binning zeroes invalid slots)."""
    attrs = table.T.contiguous()[:, inst_rank]
    return attrs.masked_fill_(~inst_valid[None, :], 0.0)


def bin_and_pack_stream(processed: Processed, tiles_x: int, tiles_y: int,
                        config: RasterConfig):
    """Stream front half: tile binning + packed attribute rows.

    Returns (bins, attrs [16, CAP + CHUNK]). Per-Gaussian attributes and the
    [N, 8] rect table ride one [N, 24] table permuted into depth order, so
    instance slots index it by depth rank."""
    n = processed.xy.shape[0]
    cap = config.instance_cap
    if cap is None:
        cap = auto_instance_cap(n, config.max_tiles_per_gaussian,
                                config.tile_w, config.tile_h,
                                config.tier_budgets, config.tier_fracs)
    if cap % CHUNK:
        raise ValueError(f"instance_cap {cap} must be a multiple of {CHUNK}")
    dev = processed.xy.device
    depth_key = torch.where(processed.mask, processed.depth.detach(),
                            torch.inf)
    order = torch.sort(depth_key, stable=True).indices.to(torch.int32)
    overflow_visible = torch.zeros((), dtype=torch.int32, device=dev)
    if config.visible_cap and config.visible_cap < n:
        v = config.visible_cap
        n_vis = processed.mask.sum().to(torch.int32)
        overflow_visible = torch.clamp(n_vis - v, min=0)
        order = order[:v]
    table = torch.cat([
        processed.xy,                                   # 0, 1
        processed.conic,                                # 2, 3, 4
        processed.opacity[:, None],                     # 5
        processed.rgb,                                  # 6, 7, 8
        torch.zeros((n, ROWS - 9), dtype=torch.float32, device=dev),
        rect_table(processed).detach(),                 # 16..23
    ], dim=1)[order]                                    # [V, 24] by depth
    bins = bin_instances_stream(processed, tiles_x, tiles_y,
                                config.max_tiles_per_gaussian, cap,
                                tile_w=config.tile_w, tile_h=config.tile_h,
                                tier_budgets=config.tier_budgets,
                                tier_fracs=config.tier_fracs, order=order,
                                rect_ordered=table[:, ROWS:].detach())
    bins = bins._replace(overflow_visible=overflow_visible)
    attrs = _gather_inst_rows(table[:, :ROWS], bins.inst_rank,
                              bins.inst_valid)          # [16, CAP + CHUNK]
    return bins, attrs


def _assemble_image(tiles: torch.Tensor, tiles_x: int, tiles_y: int,
                    tile_w: int, tile_h: int, width: int, height: int):
    """[T, C, P] per-tile images → [C, H, W]."""
    c = tiles.shape[1]
    img = tiles.reshape(tiles_y, tiles_x, c, tile_h, tile_w)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, tiles_y * tile_h,
                                             tiles_x * tile_w)
    return img[:, :height, :width]


def assemble_stream_output(tiles_out, final_T, bins, processed,
                           tiles_x: int, tiles_y: int, tile_w: int,
                           tile_h: int, image_width: int, image_height: int):
    """Stream back half: [T, P, 3] tiles → (image [3, H, W], aux)."""
    image = _assemble_image(tiles_out.permute(0, 2, 1), tiles_x, tiles_y,
                            tile_w, tile_h, image_width, image_height)
    final_T_img = _assemble_image(final_T[:, None, :], tiles_x, tiles_y,
                                  tile_w, tile_h, image_width,
                                  image_height)[0]
    aux = {
        "radii": processed.radius,
        "final_T": final_T_img,
        "overflow_tiles": bins.overflow_tiles,
        "overflow_capacity": bins.overflow_capacity,
        "overflow_visible": bins.overflow_visible,
        "tile_counts": bins.counts_raw,
        "n_mask_visible": processed.mask.sum(),
        "tier_need_counts": bins.tier_counts,
    }
    return image, aux


def rasterize(processed: Processed, image_width: int, image_height: int,
              bg_color: torch.Tensor, config: RasterConfig = RasterConfig()):
    """Full tiled rasterization. Returns (image [3, H, W], aux dict)."""
    if config.backend not in ("auto", "stream"):
        raise ValueError(f"backend {config.backend!r} is not ported; the "
                         "port has the stream backend only")
    if config.fast_math:
        raise ValueError("fast_math compositing is not ported; use exact mode")
    tile_w, tile_h = config.tile_w, config.tile_h
    tiles_x = -(-image_width // tile_w)
    tiles_y = -(-image_height // tile_h)
    num_tiles = tiles_x * tiles_y
    bins, attrs = bin_and_pack_stream(processed, tiles_x, tiles_y, config)
    tile_ids = torch.arange(num_tiles, dtype=torch.int32,
                            device=attrs.device)
    tiles_out, final_T = composite_stream(
        attrs, bins.seg_start, bins.counts, bg_color.to(torch.float32),
        tile_ids, tiles_x, tile_w, tile_h)
    return assemble_stream_output(tiles_out, final_T, bins, processed,
                                  tiles_x, tiles_y, tile_w, tile_h,
                                  image_width, image_height)
