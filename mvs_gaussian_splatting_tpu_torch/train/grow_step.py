"""The grow-mode training step: the speculative render set → loss →
backward → Adam → statistics.

Port of the JAX package's ``train/grow_step.py``, in
:func:`train.step.make_train_step`'s idiom. The render set is the live
prefix plus a block of grown and one of split candidates
(``models/grow.py:speculative_augment``), ``n_render + 2·spec_size`` rows
through ``preprocess`` and ``rasterize``, so through the same composite
kernels as the vanilla step (B3f / B3b in fast-math mode, B1 / B2 in exact
mode), whose VJPs carry the candidates' gradients back into the grow and
split parameters. The densification statistics are taken over the
original rows only. :func:`make_spec_batch_train_step` composes it with
camera batches (``parallel/data_parallel.py``): the render set is built
once per step and rendered against every camera of the batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from ..models.densify import add_densification_stats, densification_grads
from ..models.gaussians import GaussianAux, GaussianParams
from ..models.grow import GrowConfig, speculative_augment
from ..ops.preprocess import preprocess
from ..ops.rasterize import RasterConfig, rasterize
from ..utils.losses import l1_loss, ssim
from ..utils.transforms import normalize
from .optim import AdamState, adam_update, group_lrs, scrub_grads
from .step import StepMetrics, _layout, _prefix


def make_spec_train_step(opt_cfg, raster_cfg: RasterConfig,
                         spatial_lr_scale: float, grow_cfg: GrowConfig,
                         sphere_dirs, spec_size: int,
                         extent: float):
    """Returns step(params, adam, aux, camera, gt, bg, step_i, do_stats, *,
    width, height, sh_degree, render_n=0, instance_cap=0, generator=None,
    noise=None) → (params, adam, aux, StepMetrics).

    ``render_n`` and ``instance_cap`` as in ``make_train_step``; the
    instance cap covers the augmented set. ``noise`` / ``generator``: the
    split offsets' draw when the split distance is not learned
    (``speculative_augment``). ``sphere_dirs``: the [num_dirs, 3]
    codebook (grow_dir), numpy or a tensor."""
    dirs = (torch.as_tensor(sphere_dirs, dtype=torch.float32)
            if sphere_dirs is not None else None)

    def step(params: GaussianParams, adam: AdamState, aux: GaussianAux,
             camera, gt, bg, step_i: int, do_stats: bool, *, width: int,
             height: int, sh_degree: int, render_n: int = 0,
             instance_cap: int = 0,
             generator: Optional[torch.Generator] = None, noise=None):
        rc = _layout(raster_cfg, instance_cap)
        dev = params.xyz.device
        capacity = params.xyz.shape[0]
        n_render = render_n if render_n else capacity
        aux_s = GaussianAux(*[a[:n_render] for a in aux])
        grads_stat_s = densification_grads(aux)[:n_render]
        leaves = GaussianParams(*[None if a is None
                                  else a.detach().requires_grad_(True)
                                  for a in params])
        n_aug = n_render + 2 * spec_size
        ndc = torch.zeros((n_aug, 2), dtype=torch.float32, device=dev,
                          requires_grad=True)
        with record_function("train_step/forward"):
            augd = speculative_augment(
                _prefix(leaves, n_render), aux_s, grads_stat_s,
                None if dirs is None else dirs.to(dev),
                grow_cfg, opt_cfg.densify_grad_threshold, extent,
                opt_cfg.percent_dense, spec_size, generator, noise)
            shs = torch.cat([augd["f_dc"], augd["f_rest"]], dim=1)
            processed = preprocess(
                augd["xyz"], torch.sigmoid(augd["opacity"][:, 0]), camera,
                width, height, scales=torch.exp(augd["scaling"]),
                rotations=normalize(augd["rotation"]), shs=shs,
                sh_degree=sh_degree, ndc_offset=ndc, mask=augd["alive"],
                tile_w=rc.tile_w, tile_h=rc.tile_h)
            img, raux = rasterize(processed, width, height, bg, rc)
            l1 = l1_loss(img, gt)
            loss = ((1.0 - opt_cfg.lambda_dssim) * l1
                    + opt_cfg.lambda_dssim * (1.0 - ssim(img, gt)))
            if opt_cfg.opacitysparse > 0:
                opac = torch.sigmoid(leaves.opacity[:, 0])
                m = aux.alive & (opac < 0.005)
                cnt = m.sum()
                sparse = torch.where(
                    cnt > 0,
                    ((opac - 1.0).abs() * m).sum() / cnt.clamp(min=1), 0.0)
                loss = loss + opt_cfg.opacitysparse * sparse
        inputs = [a for a in leaves if a is not None] + [ndc]
        with record_function("train_step/backward"):
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, inputs)]
        g_ndc = grads.pop()
        it = iter(grads)
        g_params = GaussianParams(*[None if a is None else next(it)
                                    for a in params])
        loss, l1 = loss.detach(), l1.detach()

        with torch.no_grad(), record_function("train_step/update"):
            g_params, n_bad = scrub_grads(g_params)
            lrs = group_lrs(opt_cfg, step_i, spatial_lr_scale, params)
            new_params, new_adam = adam_update(g_params, adam, params, lrs,
                                               alive=aux.alive)

            def pad_c(x):
                if n_render == capacity:
                    return x
                return torch.cat([x, x.new_zeros((capacity - n_render,)
                                                 + x.shape[1:])])

            # the statistics over the original rows only
            radii = pad_c(raux["radii"][:n_render])
            visible = radii > 0
            new_aux = (add_densification_stats(
                aux, radii, pad_c(g_ndc[:n_render]), visible)
                if do_stats else aux)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        metrics = StepMetrics(
            loss=loss, l1=l1, n_visible=visible.sum(),
            overflow_tiles=raux["overflow_tiles"],
            overflow_capacity=raux["overflow_capacity"],
            instance_load=raux["tile_counts"].sum(),
            nonfinite_grad_rows=n_bad, mask_visible=zero,
            overflow_visible=zero,
            tier_need_counts=torch.zeros((0,), dtype=torch.int32,
                                         device=dev))
        return new_params, new_adam, new_aux, metrics

    return step


def make_spec_batch_train_step(opt_cfg, raster_cfg: RasterConfig,
                               spatial_lr_scale: float, grow_cfg: GrowConfig,
                               sphere_dirs, spec_size: int, extent: float,
                               mesh, axis: str = "data"):
    """The camera-batched speculative step (the JAX package's
    ``make_spec_batch_train_step``): grow mode composed with
    ``parallel/data_parallel.py``. The speculative render set depends only
    on (params, aux, draws), so it is built once per step, the same on
    every rank (the split offsets' ``noise`` / ``generator`` draws must be
    the same on every rank: a generator seeded alike that every rank calls
    alike), and each rank renders it against its block of the batch. The
    parameter gradients are SUM all-reduced over ``axis`` before the scrub
    and Adam; the statistics of the original rows follow the batch
    reductions of ``parallel/data_parallel.py``.

    Returns ``step(params, adam, aux, cams, gts, bg, step_i, do_stats, *,
    width, height, sh_degree, render_n=0, instance_cap=0, generator=None,
    noise=None)`` → (params, adam, aux, BatchStepMetrics)."""
    from ..parallel.data_parallel import (CameraBlock, finish_batch_step,
                                          leaves_of)
    from ..parallel.mesh import batch_sharded
    dirs = (torch.as_tensor(sphere_dirs, dtype=torch.float32)
            if sphere_dirs is not None else None)

    def step(params: GaussianParams, adam: AdamState, aux: GaussianAux,
             cams, gts, bg, step_i: int, do_stats: bool, *, width: int,
             height: int, sh_degree: int, render_n: int = 0,
             instance_cap: int = 0,
             generator: Optional[torch.Generator] = None, noise=None):
        rc = _layout(raster_cfg, instance_cap)
        dev = params.xyz.device
        n_render = render_n if render_n else params.xyz.shape[0]
        aux_s = GaussianAux(*[a[:n_render] for a in aux])
        grads_stat_s = densification_grads(aux)[:n_render]
        leaves = leaves_of(params)
        n_aug = n_render + 2 * spec_size
        block = CameraBlock(opt_cfg, dev)
        with record_function("train_step/forward"):
            augd = speculative_augment(
                _prefix(leaves, n_render), aux_s, grads_stat_s,
                None if dirs is None else dirs.to(dev),
                grow_cfg, opt_cfg.densify_grad_threshold, extent,
                opt_cfg.percent_dense, spec_size, generator, noise)
            shs = torch.cat([augd["f_dc"], augd["f_rest"]], dim=1)
            scales = torch.exp(augd["scaling"])
            rotations = normalize(augd["rotation"])
            opacity = torch.sigmoid(augd["opacity"][:, 0])
            for cam, gt in zip(batch_sharded(mesh, list(cams), axis),
                               batch_sharded(mesh, gts, axis)):
                ndc = torch.zeros((n_aug, 2), dtype=torch.float32,
                                  device=dev, requires_grad=True)
                processed = preprocess(
                    augd["xyz"], opacity, cam, width, height, scales=scales,
                    rotations=rotations, shs=shs, sh_degree=sh_degree,
                    ndc_offset=ndc, mask=augd["alive"], tile_w=rc.tile_w,
                    tile_h=rc.tile_h)
                img, raux = rasterize(processed, width, height, bg, rc)
                # the statistics over the original rows only
                block.add(img, gt, ndc, raux["radii"][:n_render],
                          raux["overflow_tiles"], raux["overflow_capacity"],
                          raux["tile_counts"].sum())
        return finish_batch_step(block, leaves, params, adam, aux,
                                 gts.shape[0], step_i, do_stats,
                                 spatial_lr_scale, mesh, axis)

    return step
