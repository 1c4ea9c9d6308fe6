"""Tile-sharded padded-table compositing: each rank composites a
contiguous strip of the tile grid with the non-kernel tile compositor.

Counterpart of the JAX package's ``parallel/tile_parallel.py``, which runs
``composite_tiles_jnp`` under ``shard_map``; the port runs
:func:`ops.composite.composite_tiles_jnp_batched` (the ``--backend jnp``
operator: no kernel is on this path). Preprocess and ``bin_gaussians`` run
replicated. The per-tile tables' gradient is SUM-reduced once over the
axis (each rank's backward fills only its strip's rows), and the tile
outputs are gathered with a backward that slices (``mesh.gather_shards``).
"""

from __future__ import annotations

import torch

from ..ops.binning import bin_gaussians
from ..ops.composite import composite_tiles_jnp_batched
from ..ops.preprocess import Processed
from ..ops.rasterize import RasterConfig, gather_tables
from .mesh import Mesh, gather_shards, sum_grad
from .tile_stream import tile_layout


def make_tile_sharded_composite(mesh: Mesh, axis: str, image_width: int,
                                image_height: int,
                                config: RasterConfig = RasterConfig()):
    """Returns fn(processed, bg) → (tiles_out [T, 3, P], final_T [T, P],
    aux), T = tiles_x · tiles_y, the same on every rank of the mesh."""
    n_dev = mesh.shape[axis]
    tile_w, tile_h = config.tile_w, config.tile_h
    tiles_x = -(-image_width // tile_w)
    tiles_y = -(-image_height // tile_h)
    num_tiles = tiles_x * tiles_y
    t_padded, t_per = tile_layout(num_tiles, n_dev)

    def fn(processed: Processed, bg):
        bins = bin_gaussians(processed, tiles_x, tiles_y,
                             config.max_tiles_per_gaussian,
                             config.tile_capacity, tile_w=tile_w,
                             tile_h=tile_h)
        cols = sum_grad(gather_tables(processed, bins), mesh, axis)
        k = cols.shape[2]
        pad = t_padded - num_tiles
        cols = torch.cat([cols, cols.new_zeros((9, pad, k))], dim=1)
        valid = torch.cat([bins.valid,
                           bins.valid.new_zeros((pad, k))])
        lo = mesh.coords[axis] * t_per
        rows = cols[:, lo:lo + t_per].permute(1, 2, 0)       # [t_per, K, 9]
        ids = torch.arange(lo, lo + t_per, device=rows.device)
        out, final_t = composite_tiles_jnp_batched(
            rows[..., 0:2], rows[..., 2:5], rows[..., 6:9], rows[..., 5],
            valid[lo:lo + t_per], tiles_x, tile_w, tile_h,
            bg.to(torch.float32), config.tile_batch, tile_ids=ids)
        tiles_out = gather_shards(out, mesh, axis)[:num_tiles]
        final_t = gather_shards(final_t, mesh, axis)[:num_tiles]
        aux = {"overflow_tiles": bins.overflow_tiles,
               "overflow_capacity": bins.overflow_capacity,
               "radii": processed.radius}
        return tiles_out, final_t, aux

    return fn
