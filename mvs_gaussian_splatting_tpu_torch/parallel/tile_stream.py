"""Tile-sharded stream rendering: each rank composites its share of the
tile grid through the instance-stream kernels.

Counterpart of the JAX package's ``parallel/tile_stream.py``. Preprocess,
binning and attribute packing run replicated (every rank holds the same
stream); each rank composites its tiles with
:func:`ops.stream.composite_stream` (B1 / B2, or B3f / B3b in fast-math
mode), as contiguous strips or round-robin (rank d takes tiles d, d+D,
…: dense foreground and empty sky spread evenly). The tile outputs are
gathered without autograd and the image assembled on every rank.

Gradients: the gather hands each rank's composite only its own tiles'
cotangent (``mesh.gather_shards``). The composite's backward writes zeros
outside the rank's segments, and every instance slot belongs to exactly
one tile, so one SUM all-reduce of the packed ``attrs`` gradient
``[16, CAP + 128]`` (``mesh.sum_grad``) reassembles the whole stream's
gradient on every rank. That is the JAX module's one collective: the
psum that ``shard_map``'s transpose inserts for the replicated ``attrs``.
"""

from __future__ import annotations

import torch

from ..ops.preprocess import Processed
from ..ops.rasterize import (RasterConfig, assemble_stream_output,
                             bin_and_pack_stream)
from ..ops.stream import composite_stream
from .mesh import Mesh, gather_shards, sum_grad


def tile_layout(num_tiles: int, n_dev: int):
    """(t_padded, t_per): the tile axis padded to a multiple of the shard
    count, and each shard's tile count."""
    t_padded = num_tiles + (-num_tiles) % n_dev
    return t_padded, t_padded // n_dev


def shard_tiles(bins, n_dev: int, index: int, num_tiles: int,
                round_robin: bool):
    """The ``index``-th shard's (seg_start, counts, tile_ids) of a stream's
    segments: pad tiles (count 0, ``seg_start`` at the stream's end)
    extend the axis to a multiple of ``n_dev``. A strip is contiguous; a
    round-robin shard takes tiles index, index + n_dev, … whose seg_start
    stays ascending (a strided subsequence of an ascending sequence)."""
    t_padded, t_per = tile_layout(num_tiles, n_dev)
    dev = bins.seg_start.device
    pad = t_padded - num_tiles
    seg_end = bins.seg_start[-1:] + bins.counts[-1:]
    seg_start = torch.cat([bins.seg_start, seg_end.expand(pad)])
    counts = torch.cat([bins.counts, bins.counts.new_zeros(pad)])
    if round_robin:
        ids = (torch.arange(t_per, dtype=torch.int32, device=dev) * n_dev
               + index)
    else:
        ids = torch.arange(index * t_per, (index + 1) * t_per,
                           dtype=torch.int32, device=dev)
    sel = ids.long()
    return seg_start[sel].contiguous(), counts[sel].contiguous(), ids


def unshard_order(num_tiles: int, n_dev: int, round_robin: bool,
                  device) -> torch.Tensor:
    """Indices into the rank-major concatenation of the shards' outputs
    that put the first ``num_tiles`` in tile order: under round-robin,
    position d·t_per + l holds tile l·D + d."""
    t_idx = torch.arange(num_tiles, device=device)
    if not round_robin:
        return t_idx
    _, t_per = tile_layout(num_tiles, n_dev)
    return (t_idx % n_dev) * t_per + t_idx // n_dev


def make_tile_sharded_stream(mesh: Mesh, axis: str, image_width: int,
                             image_height: int,
                             config: RasterConfig = RasterConfig(),
                             round_robin: bool = False):
    """Returns fn(processed, bg) → (image [3, H, W], aux), the aux of
    ``ops.rasterize``'s stream backend. The tile axis is sharded over the
    mesh's ``axis``; every rank of the mesh calls fn on the same inputs
    and gets the same image."""
    n_dev = mesh.shape[axis]
    tile_w, tile_h = config.tile_w, config.tile_h
    tiles_x = -(-image_width // tile_w)
    tiles_y = -(-image_height // tile_h)
    num_tiles = tiles_x * tiles_y

    def fn(processed: Processed, bg):
        bins, attrs = bin_and_pack_stream(processed, tiles_x, tiles_y, config)
        seg_start, counts, ids = shard_tiles(bins, n_dev, mesh.coords[axis],
                                             num_tiles, round_robin)
        out, final_t = composite_stream(
            sum_grad(attrs, mesh, axis), seg_start, counts,
            sum_grad(bg.to(torch.float32), mesh, axis), ids, tiles_x,
            tile_w, tile_h, config.fast_math)
        order = unshard_order(num_tiles, n_dev, round_robin, out.device)
        tiles_out = gather_shards(out, mesh, axis)[order]
        final_t = gather_shards(final_t, mesh, axis)[order]
        return assemble_stream_output(tiles_out, final_t, bins, processed,
                                      tiles_x, tiles_y, tile_w, tile_h,
                                      image_width, image_height)

    return fn
