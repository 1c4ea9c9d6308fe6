"""The reference's training step and render, over the plain operator of
``plain.py``, and the fork's grow mechanism (the speculative render set of
grown candidates, a straight-through argmax over 128 sphere directions).

A step takes the raw state (dicts of tensors keyed like the parameters)
and returns the next state with what the correctness check compares: the
loss, the gradient each leaf gave Adam, and the rendered image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import plain


class State(NamedTuple):
    params: dict          # raw leaves, [N, ...] each
    mu: dict
    nu: dict
    count: int            # Adam's step count before the next step
    accum: torch.Tensor   # [N] accumulated viewspace-gradient norms
    denom: torch.Tensor   # [N] visible counts
    max_radii2d: torch.Tensor  # [N] largest screen radius while visible


class Setup(NamedTuple):
    """What a step needs besides the state (the cell's fixed inputs)."""
    opt: dict             # learning rates, λ, thresholds
    tile_w: int
    tile_h: int
    bg: torch.Tensor
    spatial_lr_scale: float
    block_elems: int
    sphere_dirs: Optional[torch.Tensor] = None  # [128, 3]: grow mode
    spec: int = 0                               # grown candidates' slots


def to_dtype(state: State, dtype) -> State:
    def cast(d):
        return {k: v.to(dtype) for k, v in d.items()}
    return state._replace(params=cast(state.params), mu=cast(state.mu),
                          nu=cast(state.nu))


def grow_set(p: dict, accum, denom, setup: Setup):
    """The render set of a grow step: the N Gaussians, then ``spec`` grown
    copies of the first ``spec`` rows whose mean viewspace gradient
    reaches the threshold (moved by their straight-through direction ×
    largest scale), then ``spec`` dead rows (the split block, unused
    without a learned split). Returns (raw leaves, alive)."""
    n = p["xyz"].shape[0]
    s = setup.spec
    dev = p["xyz"].device
    stat = torch.nan_to_num(accum / denom, nan=0.0, posinf=0.0, neginf=0.0)
    sel = stat >= setup.opt["densify_grad_threshold"]
    pos = torch.cumsum(sel.long(), 0) - 1
    idx = torch.full((s + 1,), n, dtype=torch.long, device=dev)
    idx.scatter_(0, torch.where(sel & (pos < s), pos, s),
                 torch.arange(n, device=dev))
    idx = idx[:s]
    ok = idx < n
    gi = torch.clamp(idx, 0, n - 1)
    logits = p["dirs_prob"].index_select(0, gi)
    soft = torch.softmax(logits, -1)
    hard = F.one_hot(torch.argmax(soft, -1), logits.shape[1]).to(soft.dtype)
    onehot = hard - soft.detach() + soft
    dirs = onehot @ setup.sphere_dirs.to(soft.dtype)
    shift = torch.amax(torch.exp(p["scaling"].index_select(0, gi)), 1,
                       keepdim=True)
    grown = p["xyz"].index_select(0, gi) + dirs * shift

    def cat(key, fill):
        leaf = p[key]
        pad = torch.full((s,) + leaf.shape[1:], fill, dtype=leaf.dtype,
                         device=dev)
        return torch.cat([leaf, leaf.index_select(0, gi), pad])

    ident = torch.zeros((s, 4), dtype=p["rotation"].dtype, device=dev)
    ident[:, 0] = 1.0
    out = {"xyz": torch.cat([p["xyz"], grown, torch.zeros_like(grown)]),
           "f_dc": cat("f_dc", 0.0), "f_rest": cat("f_rest", 0.0),
           "scaling": cat("scaling", -10.0), "opacity": cat("opacity", -10.0),
           "rotation": torch.cat([p["rotation"],
                                  p["rotation"].index_select(0, gi), ident])}
    alive = torch.cat([torch.ones(n, dtype=torch.bool, device=dev), ok,
                       torch.zeros(s, dtype=torch.bool, device=dev)])
    return out, alive


def forward_screen(raw: dict, view: plain.View, setup: Setup, ndc=None,
                   alive=None) -> plain.Screen:
    scales, quats, opac = plain.activate(raw)
    shs = torch.cat([raw["f_dc"], raw["f_rest"]], 1)
    return plain.project(raw["xyz"], opac, scales, quats, shs, view,
                         setup.tile_w, setup.tile_h, ndc_offset=ndc,
                         alive=alive)


def render_view(raw: dict, view: plain.View, setup: Setup):
    """(image [3, H, W], contributing pairs, contributing Gaussians) of one
    view, without gradients."""
    with torch.no_grad():
        screen = forward_screen(raw, view, setup)
        lists = plain.tile_lists(screen, view.width, view.height,
                                 setup.tile_w, setup.tile_h)
        return plain.render(screen, lists, view.width, view.height,
                            setup.tile_w, setup.tile_h, setup.bg,
                            setup.block_elems)


class StepOut(NamedTuple):
    state: State
    loss: float
    grads: dict           # the scrubbed gradient each leaf gave Adam
    image: torch.Tensor   # [3, H, W]: the step's render


def train_step(state: State, view: plain.View, gt, iteration: int,
               setup: Setup, do_stats: bool,
               loss_rows: Optional[int] = None) -> StepOut:
    """One training step at ``iteration``: render, (1−λ)·L1 + λ·D-SSIM,
    gradients, Adam, and (``do_stats``) the densification statistics.
    ``loss_rows`` is the half-batch fault of the correctness check."""
    p = state.params
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    n = p["xyz"].shape[0]
    dt = p["xyz"].dtype
    if setup.spec:
        raw, alive = grow_set(leaves, state.accum, state.denom, setup)
    else:
        raw, alive = leaves, None
    n_set = raw["xyz"].shape[0]
    ndc = torch.zeros((n_set, 2), dtype=dt, device=p["xyz"].device,
                      requires_grad=True)
    W, H = view.width, view.height
    with torch.enable_grad():
        screen = forward_screen(raw, view, setup, ndc, alive)
    lists = plain.tile_lists(screen, W, H, setup.tile_w, setup.tile_h)
    img, _, _ = plain.render(screen, lists, W, H, setup.tile_w,
                             setup.tile_h, setup.bg, setup.block_elems)
    img.requires_grad_(True)
    with torch.enable_grad():
        loss = plain.loss_fn(img, gt.to(dt), setup.opt["lambda_dssim"],
                         loss_rows)
        (g_img,) = torch.autograd.grad(loss, img)
    g_table = plain.render_vjp(screen, lists, W, H, setup.tile_w,
                               setup.tile_h, setup.bg, g_img,
                               setup.block_elems)
    keys = list(leaves)
    got = torch.autograd.grad(screen.table, [leaves[k] for k in keys] + [ndc],
                              g_table, allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(keys, got[:-1])}
    g_ndc = got[-1]
    grads = plain.scrub(grads)
    count = state.count + 1
    with torch.no_grad():
        new_p, mu, nu = plain.adam(p, grads, state.mu, state.nu, count,
                                   iteration, setup.opt,
                                   setup.spatial_lr_scale)
    accum, denom, radii = state.accum, state.denom, state.max_radii2d
    if do_stats:
        vis = screen.mask[:n]
        gn = torch.linalg.vector_norm(g_ndc[:n].float(), dim=-1)
        accum = accum + torch.where(vis, gn, 0.0)
        denom = denom + vis.float()
        radii = torch.where(vis, torch.maximum(
            radii, screen.radius[:n].float()), radii)
    return StepOut(State(new_p, mu, nu, count, accum, denom, radii),
                   float(loss.detach()), grads, img.detach())
