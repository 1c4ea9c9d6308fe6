"""2-D mesh training: cameras × tiles sharded in one train step.

Counterpart of the JAX package's ``parallel/grid_train.py``. On a
(data, tile) mesh, each row of the ``data`` axis takes its block of the
camera batch (B equal to the data-axis size in the reference; a multiple
of it here, so that one rank can batch cameras as ``data_parallel``
does). Every rank of a row preprocesses the row's camera and renders it
through :func:`parallel.tile_stream.make_tile_sharded_stream` over the
``tile`` group, round-robin: its tile subset composited, the tiles
gathered within the row, the packed gradient SUM-reduced over the row, so
that every rank of the row holds its camera's whole gradient. The loss is
taken on the full images, Σ_b loss_b / B, and the parameter gradients
and batch statistics are reduced over the data axis as
``data_parallel`` reduces them.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models.gaussians import (GaussianAux, GaussianParams, activated,
                                get_features)
from ..ops.preprocess import preprocess
from ..ops.rasterize import RasterConfig
from ..train.optim import AdamState
from ..train.step import _layout, _prefix
from .data_parallel import CameraBlock, finish_batch_step, leaves_of
from .mesh import Mesh, batch_sharded
from .tile_stream import make_tile_sharded_stream
from .tile_train import require_stream


def make_grid_train_step(opt_cfg, raster_cfg: RasterConfig,
                         spatial_lr_scale: float, mesh: Mesh,
                         data_axis: str = "data", tile_axis: str = "tile"):
    """Returns a step with ``make_batch_train_step``'s signature: ``cams``
    a list of B CameraViews, ``gts`` [B, 3, H, W], B a multiple of the
    data-axis size. Refuses a non-stream backend."""

    def step(params: GaussianParams, adam: AdamState, aux: GaussianAux,
             cams, gts, bg, step_i: int, do_stats: bool, *, width: int,
             height: int, sh_degree: int, render_n: int = 0,
             instance_cap: int = 0):
        rc = _layout(raster_cfg, instance_cap)
        require_stream(rc, "grid_parallel")
        raster = make_tile_sharded_stream(mesh, tile_axis, width, height, rc,
                                          round_robin=True)
        n_render = render_n if render_n else params.xyz.shape[0]
        dev = params.xyz.device
        leaves = leaves_of(params)
        ps = _prefix(leaves, n_render)
        block = CameraBlock(opt_cfg, dev)
        with record_function("train_step/forward"):
            scales, rotations, opacity = activated(ps)
            shs = get_features(ps)
            for cam, gt in zip(batch_sharded(mesh, list(cams), data_axis),
                               batch_sharded(mesh, gts, data_axis)):
                ndc = torch.zeros((n_render, 2), device=dev,
                                  requires_grad=True)
                processed = preprocess(
                    ps.xyz, opacity, cam, width, height, scales=scales,
                    rotations=rotations, shs=shs, sh_degree=sh_degree,
                    ndc_offset=ndc, mask=aux.alive[:n_render],
                    tile_w=rc.tile_w, tile_h=rc.tile_h)
                img, raux = raster(processed, bg)
                block.add(img, gt, ndc, raux["radii"],
                          raux["overflow_tiles"], raux["overflow_capacity"],
                          raux["tile_counts"].sum())
        return finish_batch_step(block, leaves, params, adam, aux,
                                 gts.shape[0], step_i, do_stats,
                                 spatial_lr_scale, mesh, data_axis)

    return step
