"""Camera-batched data-parallel training: B cameras per step against
replicated Gaussian parameters, the loss their mean.

Counterpart of the JAX package's ``parallel/data_parallel.py``. Each rank
of the mesh's ``data`` axis renders its contiguous block of B/D cameras,
each with its own zero ``ndc_offset`` rows, backpropagates
Σ_b loss_b / B, and SUM all-reduces the parameter gradients; only then are
they scrubbed (a camera's NaN poisons the reduced row either way) and the
identical Adam step taken on every rank. The densification statistics
follow the reference's reductions over the batch: ``max_radii2d`` MAX,
``xyz_grad_accum`` and ``denom`` SUM, ``n_visible`` the OR of visibility
over all B cameras, the overflow counters SUM, ``instance_load`` MAX.

As in the reference, each camera's viewspace gradient is that of the
batch MEAN, so the norms accumulated into ``xyz_grad_accum`` carry a
factor 1/B while ``denom`` counts every camera (ROADMAP C12).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..models.gaussians import GaussianAux, GaussianParams
from ..ops.rasterize import RasterConfig
from ..ops.render import render
from ..train.optim import AdamState, adam_update, group_lrs, scrub_grads
from ..train.step import _layout, _prefix
from ..utils.losses import l1_loss, ssim
from .mesh import Mesh, all_reduce, batch_sharded


class BatchStepMetrics(NamedTuple):
    """Device scalars of one batched step (sums over the batch, but the
    loss and L1, which are means). The last two are the single-camera
    step's visible-prefix feedback, which the batched steps do not take:
    zeros, so the loop reads every step's metrics alike."""

    loss: torch.Tensor
    l1: torch.Tensor
    n_visible: torch.Tensor
    overflow_tiles: torch.Tensor
    overflow_capacity: torch.Tensor
    instance_load: torch.Tensor
    nonfinite_grad_rows: torch.Tensor
    mask_visible: torch.Tensor
    overflow_visible: torch.Tensor


def camera_loss(opt_cfg, img, gt):
    """(loss, l1) of one camera: (1 − λ)·L1 + λ·(1 − SSIM)."""
    l1 = l1_loss(img, gt)
    return ((1.0 - opt_cfg.lambda_dssim) * l1
            + opt_cfg.lambda_dssim * (1.0 - ssim(img, gt))), l1


def leaves_of(params: GaussianParams) -> GaussianParams:
    """Detached copies of the parameters that record gradients."""
    return GaussianParams(*[None if a is None
                            else a.detach().requires_grad_(True)
                            for a in params])


def grads_of(loss, leaves: GaussianParams, extra=()):
    """(parameter gradients, gradients of ``extra``), zeros where a leaf
    takes no part."""
    inputs = [a for a in leaves if a is not None] + list(extra)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, inputs)]
    it = iter(grads[:len(grads) - len(extra)])
    return (GaussianParams(*[None if a is None else next(it)
                             for a in leaves]),
            grads[len(grads) - len(extra):])


def reduce_params(grads: GaussianParams, mesh: Mesh, axis=None):
    """SUM all-reduce of every gradient leaf over ``axis`` (one flat
    buffer, one collective)."""
    if mesh.axis_group(axis) is None:
        return grads
    leaves = [g for g in grads if g is not None]
    flat = torch.cat([g.reshape(-1) for g in leaves])
    all_reduce(flat, mesh, axis)
    out, o = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[o:o + g.numel()].view_as(g))
        o += g.numel()
    return GaussianParams(*out)


def pad_rows(x, capacity: int, fill=0):
    """[B, n, ...] → [B, capacity, ...], the tail filled."""
    if x.shape[1] == capacity:
        return x
    tail = torch.full((x.shape[0], capacity - x.shape[1]) + x.shape[2:],
                      fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=1)


def batch_stats(aux: GaussianAux, radii, vis, g_ndc, mesh: Mesh, axis,
                do_stats: bool):
    """The batch's densification statistics and visible count, reduced
    over ``axis``: radii [b, C] int, vis [b, C] bool, g_ndc [b, C, 2] of
    this rank's b cameras. Returns (aux, n_visible)."""
    visf = vis.to(torch.float32)
    max_r = torch.where(vis, radii.to(torch.float32), 0.0).amax(0)
    accum = (torch.linalg.vector_norm(g_ndc, dim=-1) * visf).sum(0)
    denom = visf.sum(0)
    any_vis = vis.any(0).to(torch.int32)
    if mesh.axis_group(axis) is not None:
        all_reduce(max_r, mesh, axis, dist.ReduceOp.MAX)
        all_reduce(any_vis, mesh, axis, dist.ReduceOp.MAX)
        both = all_reduce(torch.stack([accum, denom]), mesh, axis)
        accum, denom = both[0], both[1]
    if do_stats:
        aux = aux._replace(
            max_radii2d=torch.maximum(aux.max_radii2d, max_r),
            xyz_grad_accum=aux.xyz_grad_accum + accum,
            denom=aux.denom + denom)
    return aux, any_vis.sum()


def reduce_metrics(loss_sum, l1_sum, b: int, ot, oc, il, mesh: Mesh, axis):
    """(loss, l1, overflow_tiles, overflow_capacity, instance_load) of the
    batch: sums of this rank's cameras' losses over B, the counters SUM,
    the load MAX."""
    f64 = torch.float64
    sums = torch.stack([loss_sum.detach().to(f64), l1_sum.detach().to(f64),
                        ot.to(f64), oc.to(f64)])
    il = il.to(torch.int64).reshape(1)
    if mesh.axis_group(axis) is not None:
        all_reduce(sums, mesh, axis)
        all_reduce(il, mesh, axis, dist.ReduceOp.MAX)
    return ((sums[0] / b).float(), (sums[1] / b).float(),
            sums[2].to(torch.int32), sums[3].to(torch.int32),
            il[0].to(torch.int32))


class CameraBlock:
    """This rank's block of a camera batch, filled as its cameras render:
    the summed loss and L1, each camera's viewspace offsets and radii, the
    overflow counters and the load, for :func:`finish_batch_step`."""

    def __init__(self, opt_cfg, dev):
        self.opt_cfg = opt_cfg
        self.loss = self.l1 = torch.zeros((), device=dev)
        self.overflow_tiles = torch.zeros((), dtype=torch.int32, device=dev)
        self.overflow_capacity = torch.zeros((), dtype=torch.int32,
                                             device=dev)
        self.instance_load = torch.zeros((), dtype=torch.int32, device=dev)
        self.ndcs, self.radii = [], []

    def add(self, img, gt, ndc, radii, overflow_tiles, overflow_capacity,
            instance_load):
        """One camera's render: ``radii`` holds the rows the statistics
        read, a prefix of ``ndc``'s."""
        loss, l1 = camera_loss(self.opt_cfg, img, gt)
        self.loss = self.loss + loss
        self.l1 = self.l1 + l1
        self.ndcs.append(ndc)
        self.radii.append(radii)
        self.overflow_tiles = self.overflow_tiles + overflow_tiles
        self.overflow_capacity = self.overflow_capacity + overflow_capacity
        self.instance_load = torch.maximum(self.instance_load,
                                           instance_load.to(torch.int32))


def finish_batch_step(block: CameraBlock, leaves: GaussianParams,
                      params: GaussianParams, adam: AdamState,
                      aux: GaussianAux, b: int, step_i: int, do_stats: bool,
                      spatial_lr_scale: float, mesh: Mesh, axis):
    """The batched steps' tail: backpropagate Σ_b loss_b / B, SUM the
    parameter gradients over ``axis``, scrub, take the Adam step, and
    reduce the statistics and metrics over ``axis``. Returns (params,
    adam, aux, BatchStepMetrics)."""
    dev = params.xyz.device
    capacity = params.xyz.shape[0]
    with record_function("train_step/backward"):
        g_params, g_ndc = grads_of(block.loss / b, leaves, block.ndcs)
    with torch.no_grad(), record_function("train_step/update"):
        g_params = reduce_params(g_params, mesh, axis)
        g_params, n_bad = scrub_grads(g_params)
        lrs = group_lrs(block.opt_cfg, step_i, spatial_lr_scale, params)
        new_params, new_adam = adam_update(g_params, adam, params, lrs,
                                           alive=aux.alive)
        radii = pad_rows(torch.stack(block.radii), capacity)
        g_ndc = torch.stack([g[:r.shape[0]]
                             for g, r in zip(g_ndc, block.radii)])
        new_aux, n_vis = batch_stats(aux, radii, radii > 0,
                                     pad_rows(g_ndc, capacity), mesh, axis,
                                     do_stats)
        loss, l1, ot, oc, il = reduce_metrics(
            block.loss, block.l1, b, block.overflow_tiles,
            block.overflow_capacity, block.instance_load, mesh, axis)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    metrics = BatchStepMetrics(
        loss=loss, l1=l1, n_visible=n_vis, overflow_tiles=ot,
        overflow_capacity=oc, instance_load=il, nonfinite_grad_rows=n_bad,
        mask_visible=zero, overflow_visible=zero)
    return new_params, new_adam, new_aux, metrics


def make_batch_train_step(opt_cfg, raster_cfg: RasterConfig,
                          spatial_lr_scale: float, mesh: Mesh,
                          axis: str = "data"):
    """Returns ``step(params, adam, aux, cams, gts, bg, step_i, do_stats, *,
    width, height, sh_degree, render_n=0, instance_cap=0)`` → (params,
    adam, aux, BatchStepMetrics): ``cams`` a list of B CameraViews,
    ``gts`` [B, 3, H, W]; B a multiple of the ``axis`` size. Every rank of
    the mesh calls it with the same arguments and gets the same result."""

    def step(params: GaussianParams, adam: AdamState, aux: GaussianAux,
             cams, gts, bg, step_i: int, do_stats: bool, *, width: int,
             height: int, sh_degree: int, render_n: int = 0,
             instance_cap: int = 0):
        rc = _layout(raster_cfg, instance_cap)
        n_render = render_n if render_n else params.xyz.shape[0]
        dev = params.xyz.device
        leaves = leaves_of(params)
        ps = _prefix(leaves, n_render)
        block = CameraBlock(opt_cfg, dev)
        with record_function("train_step/forward"):
            for cam, gt in zip(batch_sharded(mesh, list(cams), axis),
                               batch_sharded(mesh, gts, axis)):
                ndc = torch.zeros((n_render, 2), device=dev,
                                  requires_grad=True)
                out = render(cam, width, height, ps, bg, sh_degree=sh_degree,
                             alive=aux.alive[:n_render], ndc_offset=ndc,
                             raster_config=rc)
                block.add(out["render"], gt, ndc, out["radii"],
                          out["overflow_tiles"], out["overflow_capacity"],
                          out["instance_load"])
        return finish_batch_step(block, leaves, params, adam, aux,
                                 gts.shape[0], step_i, do_stats,
                                 spatial_lr_scale, mesh, axis)

    return step
