"""Gaussian-sharded stream rendering: each rank bins its N/D Gaussians and
sends every instance to its tile's owner with one ``all_to_all``.

Counterpart of the JAX package's ``parallel/gauss_stream.py``. On each
rank, which owns the tiles ≡ rank (mod D) (round-robin, the default) or a
contiguous strip:

1. local ``bin_instances_stream`` over the rank's Gaussians, with the
   destination-major ``round_robin=D`` remap, so that each owner's tiles
   are one contiguous span of the local stream; the packed rows carry the
   depth (row 9) as the merge key;
2. D slices of a fixed quota Q each (the shortfall counted in
   ``overflow_quota``);
3. one ``all_to_all`` of the rows [D, Q, 16] (its backward is the reverse
   exchange) and one of the per-tile counts;
4. the merge: one (tile, depth) sort of the D·Q received rows, depth ties
   broken by source order;
5. :func:`ops.stream.composite_stream` on the rank's tiles.

The tile outputs are gathered with a backward that slices
(``mesh.gather_shards``), so every rank assembles the image and takes the
same loss while each rank's backward carries only its own tiles; the
reverse exchange returns every row's gradient to the rank that owns its
Gaussian, so the parameter gradients are born sharded.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.binning import auto_instance_cap, bin_instances_stream
from ..ops.preprocess import Processed
from ..ops.rasterize import RasterConfig, _assemble_image, _gather_inst_rows
from ..ops.stream import CHUNK, ROWS, composite_stream
from .mesh import Mesh, all_reduce, gather_shards
from .tile_stream import tile_layout, unshard_order


class _AllToAll(torch.autograd.Function):
    """Equal-split ``all_to_all`` along dim 0; its backward is the reverse
    exchange."""

    @staticmethod
    def forward(ctx, x, group, mesh):
        ctx.group, ctx.mesh = group, mesh
        return exchange(x, group, mesh)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group, ctx.mesh), None, None


def exchange(x: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """Chunk d of dim 0 to rank d, no autograd, counted on ``mesh``; the
    identity without a group."""
    if group is None:
        return x
    mesh.note("all_to_all", x)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def make_gauss_sharded_stream(mesh: Mesh, axis: str, image_width: int,
                              image_height: int,
                              config: RasterConfig = RasterConfig(),
                              quota: Optional[int] = None,
                              round_robin: bool = True):
    """Returns fn(processed, bg) → (image [3, H, W], aux): ``processed``
    is this rank's shard of the Gaussians (its rows of a [N, ...] set),
    ``config.instance_cap`` a per-rank cap (None: the auto cap of the
    shard). ``quota``: the per-(source, destination) instance budget,
    default 2·cap/D, CHUNK-aligned. aux: ``radii`` of the shard's rows,
    ``final_T``, and the counters summed over the ranks
    (``overflow_tiles``, ``overflow_capacity``, ``overflow_quota``,
    ``instance_load``)."""
    n_dev = mesh.shape[axis]
    group = mesh.axis_group(axis)
    tile_w, tile_h = config.tile_w, config.tile_h
    tiles_x = -(-image_width // tile_w)
    tiles_y = -(-image_height // tile_h)
    num_tiles = tiles_x * tiles_y
    t_padded, t_per = tile_layout(num_tiles, n_dev)

    def fn(processed: Processed, bg):
        d_idx = mesh.coords[axis]
        n_loc = processed.xy.shape[0]
        dev = processed.xy.device
        cap = config.instance_cap
        if cap is None:
            cap = auto_instance_cap(n_loc, config.max_tiles_per_gaussian,
                                    tile_w, tile_h, config.tier_budgets,
                                    config.tier_fracs)
        q = quota if quota is not None else 2 * cap // n_dev
        q += (-q) % CHUNK

        # 1. local binning, destination-major under round-robin
        bins = bin_instances_stream(
            Processed(*[t.detach() for t in processed]), tiles_x, tiles_y,
            config.max_tiles_per_gaussian, cap, tile_w=tile_w,
            tile_h=tile_h, tier_budgets=config.tier_budgets,
            tier_fracs=config.tier_fracs,
            round_robin=n_dev if round_robin else 0)
        table = torch.cat([
            processed.xy, processed.conic, processed.opacity[:, None],
            processed.rgb, processed.depth.detach()[:, None],
            processed.xy.new_zeros((n_loc, ROWS - 10))], dim=1)
        rows = _gather_inst_rows(table[bins.order.long()], bins.inst_rank,
                                 bins.inst_valid)          # [16, CAP+CHUNK]

        # 2. contiguous destination slices at a fixed quota
        seg_start, counts = bins.seg_start, bins.counts
        if not round_robin:
            pad = t_padded - num_tiles
            seg_end0 = seg_start[-1:] + counts[-1:]
            seg_start = torch.cat([seg_start, seg_end0.expand(pad)])
            counts = torch.cat([counts, counts.new_zeros(pad)])
        seg_end = seg_start[-1:] + counts[-1:]
        strip_lo = seg_start[::t_per]                       # [D]
        strip_count = torch.cat([strip_lo[1:], seg_end]) - strip_lo
        overflow_quota = torch.clamp(strip_count - q, min=0).sum()
        rows = torch.cat([rows, rows.new_zeros((ROWS, q))], dim=1)
        take = (strip_lo.long()[:, None]
                + torch.arange(q, device=dev)[None, :])      # [D, Q]
        send = rows[:, take].permute(1, 2, 0)               # [D, Q, 16]
        send_meta = torch.cat([counts.reshape(n_dev, t_per),
                               torch.minimum(strip_count, torch.full_like(
                                   strip_count, q))[:, None]], dim=1)

        # 3. the exchange: rank j receives chunk j of every source
        recv = _AllToAll.apply(send.contiguous(), group, mesh)  # [D, Q, 16]
        recv_meta = exchange(send_meta.contiguous(), group, mesh)
        recv_tile_counts = recv_meta[:, :t_per].long()
        recv_count = recv_meta[:, t_per].long()

        # 4. merge the D (tile, depth)-sorted chunks: per-instance local
        # tiles from the per-source counts, then one (tile, depth) sort
        cum = torch.cumsum(recv_tile_counts, dim=1)         # [D, t_per]
        j = torch.arange(q, device=dev)
        tile_local = torch.searchsorted(
            cum, j.expand(n_dev, q).contiguous(), right=True)
        valid = j[None, :] < recv_count[:, None]
        tile_key = torch.where(valid, tile_local, t_per).reshape(-1)
        depth_key = torch.where(valid, recv.detach()[:, :, 9],
                                torch.inf).reshape(-1)
        by_depth = torch.sort(depth_key, stable=True).indices
        by_tile = torch.sort(tile_key[by_depth], stable=True).indices
        idx_sorted = by_depth[by_tile]
        tile_sorted = tile_key[idx_sorted]
        merged = torch.where((tile_sorted < t_per)[:, None],
                             recv.reshape(n_dev * q, ROWS)[idx_sorted], 0.0)
        attrs = torch.cat([merged, merged.new_zeros((CHUNK, ROWS))]).T
        tile_range = torch.arange(t_per, device=dev)
        seg_l = torch.searchsorted(tile_sorted, tile_range, out_int32=True)
        n_valid = torch.searchsorted(
            tile_sorted, torch.full((1,), t_per, device=dev),
            out_int32=True)
        counts_l = torch.cat([seg_l[1:], n_valid]) - seg_l

        # 5. composite the owned tiles (global ids; pad positions past
        # num_tiles have count 0 and are dropped at assembly)
        if round_robin:
            tile_ids = (tile_range * n_dev + d_idx).to(torch.int32)
        else:
            tile_ids = (d_idx * t_per + tile_range).to(torch.int32)
        out, final_t = composite_stream(
            attrs.contiguous(), seg_l, counts_l.to(torch.int32),
            bg.to(torch.float32), tile_ids, tiles_x, tile_w, tile_h,
            config.fast_math)
        stats = torch.stack([bins.overflow_tiles.to(torch.int64),
                             bins.overflow_capacity.to(torch.int64),
                             overflow_quota.to(torch.int64),
                             bins.counts_raw.sum().to(torch.int64)])
        all_reduce(stats, mesh, axis)

        order = unshard_order(num_tiles, n_dev, round_robin, dev)
        tiles_out = gather_shards(out, mesh, axis)[order]
        final_t = gather_shards(final_t, mesh, axis)[order]
        image = _assemble_image(tiles_out.permute(0, 2, 1), tiles_x,
                                tiles_y, tile_w, tile_h, image_width,
                                image_height)
        ft_img = _assemble_image(final_t[:, None, :], tiles_x, tiles_y,
                                 tile_w, tile_h, image_width,
                                 image_height)[0]
        aux = {"radii": processed.radius, "final_T": ft_img,
               "overflow_tiles": stats[0].to(torch.int32),
               "overflow_capacity": stats[1].to(torch.int32),
               "overflow_quota": stats[2].to(torch.int32),
               "instance_load": stats[3].to(torch.int32)}
        return image, aux

    return fn
