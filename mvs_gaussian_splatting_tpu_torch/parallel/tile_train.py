"""Tile-parallel training: one camera per step, its tile grid sharded.

Counterpart of the JAX package's ``parallel/tile_train.py``: a whole train
step (render → L1 + D-SSIM → backward → Adam → statistics) whose
composite runs sharded over the mesh's ``tile`` axis, round-robin by
default, through :func:`parallel.tile_stream.make_tile_sharded_stream`.
Parameters, camera and Adam state are replicated; preprocess, binning and
packing run on every rank; the packed attribute gradient is SUM-reduced
once, so every rank takes the same Adam step.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models.densify import add_densification_stats
from ..models.gaussians import (GaussianAux, GaussianParams, activated,
                                get_features)
from ..ops.preprocess import preprocess
from ..ops.rasterize import RasterConfig
from ..train.optim import AdamState, adam_update, group_lrs, scrub_grads
from ..train.step import StepMetrics, _layout, _prefix
from .data_parallel import camera_loss, grads_of, leaves_of, pad_rows
from .mesh import Mesh
from .tile_stream import make_tile_sharded_stream


def require_stream(rc: RasterConfig, mode: str) -> None:
    if rc.backend not in ("stream", "auto"):
        raise ValueError(f"{mode} requires the stream backend, got "
                         f"{rc.backend!r}")


def make_tile_train_step(opt_cfg, raster_cfg: RasterConfig,
                         spatial_lr_scale: float, mesh: Mesh,
                         axis: str = "tile", round_robin: bool = True):
    """Returns a step with ``make_train_step``'s signature (but
    ``visible_cap`` and ``tier_fracs``) that returns its StepMetrics. Refuses a non-stream backend, as the JAX module does."""

    def step(params: GaussianParams, adam: AdamState, aux: GaussianAux,
             camera, gt, bg, step_i: int, do_stats: bool, *, width: int,
             height: int, sh_degree: int, render_n: int = 0,
             instance_cap: int = 0):
        rc = _layout(raster_cfg, instance_cap)
        require_stream(rc, "tile_parallel")
        raster = make_tile_sharded_stream(mesh, axis, width, height, rc,
                                          round_robin=round_robin)
        capacity = params.xyz.shape[0]
        n_render = render_n if render_n else capacity
        dev = params.xyz.device
        leaves = leaves_of(params)
        ps = _prefix(leaves, n_render)
        ndc = torch.zeros((n_render, 2), device=dev, requires_grad=True)
        with record_function("train_step/forward"):
            scales, rotations, opacity = activated(ps)
            processed = preprocess(
                ps.xyz, opacity, camera, width, height, scales=scales,
                rotations=rotations, shs=get_features(ps),
                sh_degree=sh_degree, ndc_offset=ndc,
                mask=aux.alive[:n_render], tile_w=rc.tile_w,
                tile_h=rc.tile_h)
            img, raux = raster(processed, bg)
            loss, l1 = camera_loss(opt_cfg, img, gt)
        with record_function("train_step/backward"):
            g_params, (g_ndc,) = grads_of(loss, leaves, [ndc])
        with torch.no_grad(), record_function("train_step/update"):
            g_params, n_bad = scrub_grads(g_params)
            lrs = group_lrs(opt_cfg, step_i, spatial_lr_scale, params)
            new_params, new_adam = adam_update(g_params, adam, params, lrs,
                                               alive=aux.alive)
            radii = pad_rows(raux["radii"][None], capacity)[0]
            visible = radii > 0
            new_aux = (add_densification_stats(
                aux, radii, pad_rows(g_ndc[None], capacity)[0], visible)
                if do_stats else aux)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        metrics = StepMetrics(
            loss=loss.detach(), l1=l1.detach(), n_visible=visible.sum(),
            overflow_tiles=raux["overflow_tiles"],
            overflow_capacity=raux["overflow_capacity"],
            instance_load=raux["tile_counts"].sum(),
            nonfinite_grad_rows=n_bad, mask_visible=zero,
            overflow_visible=zero,
            tier_need_counts=raux["tier_need_counts"])
        return new_params, new_adam, new_aux, metrics

    return step
