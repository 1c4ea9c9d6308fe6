"""The training step: render → loss → backward → Adam → statistics.

Port of the JAX package's ``train/step.py``. PyTorch runs it eagerly: the
render's backward goes through the composite's backward kernel (B3b in
fast-math mode, B2 in exact mode, B5 on the padded backend), the gather's
scatter-add and preprocess. The viewspace-gradient densification statistic
comes out of the same backward pass, as the gradient of a zero
``ndc_offset`` input.

Three profiler ranges mark the step's phases in a ``torch.profiler`` trace
(``train/loop.py``'s ``profile_dir``): ``train_step/forward`` (render and
loss), ``train_step/backward`` (the autograd pass) and
``train_step/update`` (scrub, Adam and the statistics).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..models.densify import add_densification_stats
from ..models.gaussians import GaussianAux, GaussianParams
from ..ops.rasterize import RasterConfig
from ..ops.render import render
from ..utils.losses import l1_loss, psnr, ssim
from .optim import AdamState, adam_update, group_lrs, scrub_grads


class StepMetrics(NamedTuple):
    """Device scalars of one step; read them only where the host needs
    them (each read waits for the card)."""

    loss: torch.Tensor
    l1: torch.Tensor
    n_visible: torch.Tensor
    overflow_tiles: torch.Tensor
    overflow_capacity: torch.Tensor
    instance_load: torch.Tensor
    nonfinite_grad_rows: torch.Tensor   # rows zeroed by optim.scrub_grads
    mask_visible: torch.Tensor          # the camera's visible count
    overflow_visible: torch.Tensor      # visible rows the cap dropped
    tier_need_counts: torch.Tensor      # rows needing > tier_budgets[i]


def _layout(raster_cfg: RasterConfig, instance_cap: int = 0,
            visible_cap: int = 0, tier_fracs: tuple = (),
            tier_layout=None) -> RasterConfig:
    rc = raster_cfg
    if instance_cap:
        rc = rc._replace(instance_cap=instance_cap)
    if visible_cap:
        rc = rc._replace(visible_cap=visible_cap)
    if tier_fracs:
        rc = rc._replace(tier_fracs=tier_fracs)
    if tier_layout is not None:
        d, budgets, fracs = tier_layout
        rc = rc._replace(max_tiles_per_gaussian=d, tier_budgets=budgets,
                         tier_fracs=fracs)
    return rc


def _prefix(params: GaussianParams, m: int) -> GaussianParams:
    return GaussianParams(*[None if a is None else a[:m] for a in params])


def make_train_step(opt_cfg, raster_cfg: RasterConfig,
                    spatial_lr_scale: float):
    """Returns train_step(params, adam, aux, camera, gt, bg, step, do_stats,
    *, width, height, sh_degree, render_n=0, instance_cap=0, visible_cap=0,
    tier_fracs=()) → (params, adam, aux, StepMetrics).

    ``render_n``: 0 renders the full capacity; otherwise the loop keeps
    every alive slot in ``[:render_n]`` (``compact_state`` after each
    densify round) and only that prefix is rendered. The tail's gradients
    are zero and Adam still updates the full (alive-masked) arrays.
    ``instance_cap`` / ``visible_cap`` / ``tier_fracs`` override the raster
    config's (0 / () = keep it)."""

    def train_step(params: GaussianParams, adam: AdamState,
                   aux: GaussianAux, camera, gt, bg, step: int,
                   do_stats: bool, *, width: int, height: int,
                   sh_degree: int, render_n: int = 0, instance_cap: int = 0,
                   visible_cap: int = 0, tier_fracs: tuple = ()):
        rc = _layout(raster_cfg, instance_cap, visible_cap, tier_fracs)
        capacity = params.xyz.shape[0]
        n_render = render_n if render_n else capacity
        leaves = GaussianParams(*[None if a is None
                                  else a.detach().requires_grad_(True)
                                  for a in params])
        ndc = torch.zeros((n_render, 2), dtype=torch.float32,
                          device=params.xyz.device, requires_grad=True)
        with record_function("train_step/forward"):
            out = render(camera, width, height, _prefix(leaves, n_render),
                         bg, sh_degree=sh_degree, alive=aux.alive[:n_render],
                         ndc_offset=ndc, raster_config=rc)
            img = out["render"]
            l1 = l1_loss(img, gt)
            loss = ((1.0 - opt_cfg.lambda_dssim) * l1
                    + opt_cfg.lambda_dssim * (1.0 - ssim(img, gt)))
            if opt_cfg.opacitysparse > 0:
                # push near-dead opacities toward 1 (reference
                # train.py:102-106)
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
            lrs = group_lrs(opt_cfg, step, spatial_lr_scale, params)
            new_params, new_adam = adam_update(g_params, adam, params, lrs,
                                               alive=aux.alive)

            def pad_c(x, fill=0):
                if x.shape[0] == capacity:
                    return x
                pad = torch.full((capacity - n_render,) + x.shape[1:], fill,
                                 dtype=x.dtype, device=x.device)
                return torch.cat([x, pad])

            visible = pad_c(out["visibility_filter"], fill=False)
            new_aux = (add_densification_stats(aux, pad_c(out["radii"]),
                                               pad_c(g_ndc), visible)
                       if do_stats else aux)
        i32 = torch.int32
        metrics = StepMetrics(
            loss=loss, l1=l1, n_visible=visible.sum(),
            overflow_tiles=out["overflow_tiles"],
            overflow_capacity=out["overflow_capacity"],
            instance_load=out["instance_load"],
            nonfinite_grad_rows=n_bad,
            mask_visible=torch.as_tensor(out["n_mask_visible"]).to(i32),
            overflow_visible=torch.as_tensor(out["overflow_visible"]).to(i32),
            tier_need_counts=torch.as_tensor(out["tier_need_counts"]).to(i32))
        return new_params, new_adam, new_aux, metrics

    return train_step


def make_eval_render(raster_cfg: RasterConfig):
    """eval_render(params, alive, camera, bg, *, width, height, sh_degree,
    render_n=0, instance_cap=0, tier_layout=None) → image [3, H, W] in
    [0, 1]."""

    @torch.no_grad()
    def eval_render(params, alive, camera, bg, *, width: int, height: int,
                    sh_degree: int, render_n: int = 0, instance_cap: int = 0,
                    tier_layout=None):
        m = render_n if render_n else params.xyz.shape[0]
        rc = _layout(raster_cfg, instance_cap, tier_layout=tier_layout)
        out = render(camera, width, height, _prefix(params, m), bg,
                     sh_degree=sh_degree, alive=alive[:m], raster_config=rc)
        return torch.clamp(out["render"], 0.0, 1.0)

    return eval_render


def make_eval_metrics(raster_cfg: RasterConfig):
    """eval_metrics(params, alive, camera, gt, bg, *, ...) → (L1, PSNR)
    device scalars of one view, rendered as :func:`make_eval_render`
    renders it."""
    eval_render = make_eval_render(raster_cfg)

    @torch.no_grad()
    def eval_metrics(params, alive, camera, gt, bg, **kwargs):
        img = eval_render(params, alive, camera, bg, **kwargs)
        gtc = torch.clamp(gt, 0.0, 1.0)
        return l1_loss(img, gtc), psnr(img, gtc)[0]

    return eval_metrics
