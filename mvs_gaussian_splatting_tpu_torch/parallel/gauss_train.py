"""Gaussian-sharded training: parameters, Adam state and statistics live
N/D per rank.

Counterpart of the JAX package's ``parallel/gauss_train.py``. Every
per-Gaussian stage (activations, preprocess, depth sort, tile enumeration,
packing, the backward's scatter, Adam, the statistics) runs on the rank's
contiguous block of C/D rows of the capacity; one ``all_to_all`` sends the
instances to their tiles' owners (:mod:`parallel.gauss_stream`), and the
reverse exchange brings their gradients home, so no [N]-sized all-reduce
is made. Camera, ground truth and loss are replicated.

A rank renders its whole block, dead rows masked out: the loop keeps the
alive rows a prefix of the capacity, not of each block, so the render
slice (``render_n``) does not apply; images, gradients and statistics do
not change, only the work. ``instance_cap`` is global, as in the other
modes, and divided over the ranks (CHUNK-aligned).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models.densify import add_densification_stats
from ..models.gaussians import (GaussianAux, GaussianParams, activated,
                                get_features)
from ..ops.preprocess import preprocess
from ..ops.rasterize import RasterConfig
from ..ops.stream import CHUNK
from ..train.optim import AdamState, adam_update, group_lrs, scrub_grads
from ..train.step import StepMetrics, _layout
from .data_parallel import camera_loss, grads_of, leaves_of
from .gauss_stream import make_gauss_sharded_stream
from .mesh import Mesh, all_gather, all_reduce
from .tile_train import require_stream


def _block(mesh: Mesh, axis: str, rows: int) -> slice:
    n = mesh.shape[axis]
    if rows % n:
        raise ValueError(f"capacity {rows} does not divide over {n} ranks")
    i = mesh.coords[axis]
    return slice(i * (rows // n), (i + 1) * (rows // n))


def shard_tree(tree, mesh: Mesh, axis: str = "gauss"):
    """This rank's block of every [C, ...] leaf of a params- or aux-shaped
    tuple."""
    return type(tree)(*[None if a is None
                        else a[_block(mesh, axis, a.shape[0])].contiguous()
                        for a in tree])


def gather_tree(tree, mesh: Mesh, axis: str = "gauss"):
    """The whole [C, ...] leaves from every rank's block, in rank order."""
    def whole(a):
        full = all_gather(a, mesh, axis)
        return full.reshape((-1,) + tuple(a.shape[1:]))
    return type(tree)(*[None if a is None else whole(a) for a in tree])


def shard_state(params, adam: AdamState, aux, mesh: Mesh,
                axis: str = "gauss"):
    return (shard_tree(params, mesh, axis),
            AdamState(count=adam.count, mu=shard_tree(adam.mu, mesh, axis),
                      nu=shard_tree(adam.nu, mesh, axis)),
            shard_tree(aux, mesh, axis))


def gather_state(params, adam: AdamState, aux, mesh: Mesh,
                 axis: str = "gauss"):
    return (gather_tree(params, mesh, axis),
            AdamState(count=adam.count, mu=gather_tree(adam.mu, mesh, axis),
                      nu=gather_tree(adam.nu, mesh, axis)),
            gather_tree(aux, mesh, axis))


def make_gauss_train_step(opt_cfg, raster_cfg: RasterConfig,
                          spatial_lr_scale: float, mesh: Mesh,
                          axis: str = "gauss", round_robin: bool = True):
    """Returns a step with ``make_tile_train_step``'s signature, one
    camera per step. It takes and returns (params, adam, aux) sharded over
    ``axis``: :func:`shard_state` shards the whole state,
    :func:`gather_state` makes it whole again.
    Refuses a non-stream backend."""
    n_dev = mesh.shape[axis]

    def step(params: GaussianParams, adam: AdamState, aux: GaussianAux,
             camera, gt, bg, step_i: int, do_stats: bool, *, width: int,
             height: int, sh_degree: int, render_n: int = 0,
             instance_cap: int = 0):
        rc = raster_cfg
        if instance_cap:
            local = -(-instance_cap // n_dev)
            rc = _layout(rc, local + (-local) % CHUNK)
        require_stream(rc, "gauss_parallel")
        raster = make_gauss_sharded_stream(mesh, axis, width, height, rc,
                                           round_robin=round_robin)
        dev = params.xyz.device
        leaves = leaves_of(params)
        ndc = torch.zeros((params.xyz.shape[0], 2), device=dev,
                          requires_grad=True)
        with record_function("train_step/forward"):
            scales, rotations, opacity = activated(leaves)
            processed = preprocess(
                leaves.xyz, opacity, camera, width, height, scales=scales,
                rotations=rotations, shs=get_features(leaves),
                sh_degree=sh_degree, ndc_offset=ndc, mask=aux.alive,
                tile_w=rc.tile_w, tile_h=rc.tile_h)
            img, raux = raster(processed, bg)
            loss, l1 = camera_loss(opt_cfg, img, gt)
        with record_function("train_step/backward"):
            g_params, (g_ndc,) = grads_of(loss, leaves, [ndc])
        with torch.no_grad(), record_function("train_step/update"):
            g_params, n_bad = scrub_grads(g_params)
            lrs = group_lrs(opt_cfg, step_i, spatial_lr_scale, params)
            new_params, new_adam = adam_update(g_params, adam, params, lrs,
                                               alive=aux.alive)
            radii = raux["radii"]
            visible = radii > 0
            new_aux = (add_densification_stats(aux, radii, g_ndc, visible)
                       if do_stats else aux)
            counts = torch.stack([visible.sum(), n_bad]).to(torch.int64)
            all_reduce(counts, mesh, axis)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        metrics = StepMetrics(
            loss=loss.detach(), l1=l1.detach(),
            n_visible=counts[0].to(torch.int32),
            overflow_tiles=raux["overflow_tiles"],
            overflow_capacity=(raux["overflow_capacity"]
                               + raux["overflow_quota"]),
            # the summed exchange load: a global number, as the other
            # modes report it for the loop's instance-cap bucket
            instance_load=raux["instance_load"],
            nonfinite_grad_rows=counts[1].to(torch.int32),
            mask_visible=zero, overflow_visible=zero,
            tier_need_counts=torch.zeros((0,), dtype=torch.int32,
                                         device=dev))
        return new_params, new_adam, new_aux, metrics

    return step
