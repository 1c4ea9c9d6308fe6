"""Training-loop helpers that the eval surfaces share.

Port of ``raster_config_from_pipe`` and ``eval_config`` from the JAX
package's ``train/loop.py``; the loop itself comes with the training slice.
"""

from __future__ import annotations

from ..ops.rasterize import RasterConfig, widen_eval_budgets
from .config import PipelineConfig


def raster_config_from_pipe(pipe: PipelineConfig) -> RasterConfig:
    return RasterConfig(backend=pipe.backend,
                        tile_w=pipe.tile_w, tile_h=pipe.tile_h,
                        tile_capacity=pipe.tile_capacity,
                        max_tiles_per_gaussian=pipe.max_tiles_per_gaussian,
                        tile_batch=pipe.tile_batch,
                        fast_math=pipe.fast_math,
                        tier_budgets=tuple(pipe.tier_budgets),
                        tier_fracs=tuple(pipe.tier_fracs))


def eval_config(raster_cfg: RasterConfig) -> RasterConfig:
    """The eval invariants: every surface that produces user-visible images
    or reported metrics composites in EXACT mode with the generous
    full-footprint tile budgets (ops.rasterize.widen_eval_budgets)."""
    return widen_eval_budgets(raster_cfg._replace(fast_math=False))
