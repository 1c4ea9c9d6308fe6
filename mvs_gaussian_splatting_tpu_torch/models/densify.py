"""Adaptive density control on capacity-padded state.

Port of the JAX package's ``models/densify.py``: clone writes copies of
small high-gradient Gaussians into free (dead) slots; split writes child 1
over the parent slot and child 2 into a free slot; prune clears alive bits
and zeroes the Adam moments of the cleared slots; new slots start with zero
moments. Slots are assigned exactly as the JAX package assigns them (free
slots in index order, clones first), so the two packages produce the same
state from the same split noise. Grow mode's round
(:func:`densify_and_prune_grow`) grows instead of cloning and splits the
grown points too.

The reference's screen-size prune never fires (max_radii2d is zeroed
before it is read) and is not ported. Reference quirks kept: the gradient
statistic is ‖accumulated NDC gradient‖ / denom with NaN → 0; the
world-size prune reads the post-split scales.

Functions return new tuples; the tensors they are given may be updated in
place (the loop never reads the old state again), which keeps the [C, ...]
copies out of the densify round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.transforms import inverse_sigmoid, quat_to_rotmat
from .gaussians import (GaussianAux, GaussianParams, get_split_distance,
                        get_split_scale)


class DensifyConfig(NamedTuple):
    grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    symmetric_split: bool = False


def densification_grads(aux: GaussianAux) -> torch.Tensor:
    """‖viewspace grad‖ statistic with the reference's NaN→0 guard."""
    return torch.nan_to_num(aux.xyz_grad_accum / aux.denom, nan=0.0,
                            posinf=0.0, neginf=0.0)


def _rows(tree, idx):
    return type(tree)(*[None if a is None else a[idx] for a in tree])


def _set_rows(tree, idx, src):
    for a, s in zip(tree, src):
        if a is not None:
            a[idx] = s


def _zero_rows(tree, idx):
    for a in tree:
        if a is not None:
            a[idx] = 0.0


def _draw_noise(capacity: int, dev, generator, noise):
    """The split offsets' two N(0, 1) [C, 3] draws: ``noise`` or drawn
    from ``generator``."""
    if noise is None:
        return tuple(torch.randn((capacity, 3), generator=generator,
                                 device=dev) for _ in range(2))
    return tuple(torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                 device=dev) for x in noise)


def _clone_into_free(params, mu, nu, alive, sel, free_idx, offsets=None):
    """Copy the rows ``sel`` into the first free slots ``free_idx`` (in
    index order), displaced by ``offsets`` [C, 3] when given. Returns
    (params, mu, nu, alive, n_done, n_want, dest)."""
    src = sel.nonzero()[:, 0]
    n_want = int(src.shape[0])
    n_done = min(n_want, int(free_idx.shape[0]))
    src, dest = src[:n_done], free_idx[:n_done]
    _set_rows(params, dest, _rows(params, src))
    if offsets is not None:
        params.xyz[dest] += offsets[src]
    _zero_rows(mu, dest)
    _zero_rows(nu, dest)
    alive = alive.clone()
    alive[dest] = True
    return params, mu, nu, alive, n_done, n_want, dest


def _split_into_free(params, mu, nu, alive, sel, noise, free_idx,
                     slot_offset: int, symmetric_split: bool,
                     split_dist=None, scale_div=None):
    """Split the rows ``sel``: child 2 into the free slots from
    ``free_idx[slot_offset]`` on, child 1 over the parent; a parent whose
    child-2 slot was not granted stays as it is.

    The offsets are samples × scale in each Gaussian's frame: the learned
    ``split_dist`` [C, 3] (child 2 mirrored), else ``noise`` = two N(0, 1)
    [C, 3] draws (child 2 mirrored when ``symmetric_split``). The children's
    scale is the parent's over ``scale_div`` [C, 1], else over 1.6.
    Returns (params, mu, nu, alive, n_done, n_want)."""
    split_src = sel.nonzero()[:, 0]
    n_want = int(split_src.shape[0])
    n_done = max(0, min(n_want, int(free_idx.shape[0]) - slot_offset))
    split_src = split_src[:n_done]
    dest = free_idx[slot_offset:slot_offset + n_done]
    s = torch.exp(params.scaling[split_src])
    if split_dist is not None:
        noise1 = s * split_dist[split_src]
        noise2 = -noise1
    else:
        n1, n2 = noise
        noise1 = n1[split_src] * s
        noise2 = -noise1 if symmetric_split else n2[split_src] * s
    rot = quat_to_rotmat(params.rotation[split_src])
    off1 = (rot * noise1[:, None, :]).sum(-1)
    off2 = (rot * noise2[:, None, :]).sum(-1)
    div = scale_div[split_src] if scale_div is not None else 1.6
    new_scaling = torch.log(s / div)
    parent = _rows(params, split_src)
    _set_rows(params, dest, parent)
    params.xyz[dest] = parent.xyz + off2
    params.scaling[dest] = new_scaling
    params.xyz[split_src] = parent.xyz + off1
    params.scaling[split_src] = new_scaling
    for tree in (mu, nu):
        _zero_rows(tree, dest)
        _zero_rows(tree, split_src)
    alive = alive.clone()
    alive[dest] = True
    return params, mu, nu, alive, n_done, n_want


def densify_and_prune(params: GaussianParams, mu, nu, aux: GaussianAux,
                      generator: Optional[torch.Generator], extent,
                      cfg: DensifyConfig, size_threshold_active: bool, *,
                      noise=None):
    """One densification round: clone + split + prune.

    mu/nu: Adam moments shaped like params. extent: the scene radius.
    size_threshold_active: the loop passes iteration >
    opacity_reset_interval. The split offsets are N(0, 1)·scale in each
    Gaussian's frame, drawn as two [C, 3] tensors from ``generator``, or
    given as ``noise = (n1, n2)`` (the tests feed both packages one draw).

    Returns (params, mu, nu, aux, info) with the counts n_cloned, n_split,
    n_pruned, n_dropped and n_alive as ints."""
    capacity = aux.alive.shape[0]
    g = densification_grads(aux)
    max_scale = torch.exp(params.scaling).max(dim=1).values
    dense_lim = cfg.percent_dense * extent
    hot = aux.alive & (g >= cfg.grad_threshold)
    sel_clone = hot & (max_scale <= dense_lim)
    sel_split = hot & (max_scale > dense_lim)
    free_idx = (~aux.alive).nonzero()[:, 0]
    noise = _draw_noise(capacity, aux.alive.device, generator, noise)

    params, mu, nu, alive, n_cloned, n_clone_want, _ = _clone_into_free(
        params, mu, nu, aux.alive, sel_clone, free_idx)
    params, mu, nu, alive, n_split, n_split_want = _split_into_free(
        params, mu, nu, alive, sel_split, noise, free_idx, n_cloned,
        cfg.symmetric_split)

    n_dropped = (n_clone_want - n_cloned) + (n_split_want - n_split)
    params, mu, nu, aux, n_pruned = _postfix_and_prune(
        params, mu, nu, alive, extent, cfg, size_threshold_active)
    info = {"n_cloned": n_cloned, "n_split": n_split, "n_pruned": n_pruned,
            "n_dropped": n_dropped, "n_alive": int(aux.alive.sum())}
    return params, mu, nu, aux, info


def densify_and_prune_grow(params: GaussianParams, mu, nu, aux: GaussianAux,
                           generator: Optional[torch.Generator], extent,
                           cfg: DensifyConfig, grow_cfg, sphere_dirs,
                           size_threshold_active: bool, *, noise=None,
                           fresh=None):
    """Grow mode's densification round: grow + growsplit + prune.

    Grow: every high-gradient Gaussian spawns a copy displaced along its
    learned direction (no scale gate), and the original's direction
    parameters are re-initialized unless ``grow_cfg.prob_notreinit``
    (``fresh``: the continuous directions' [C, 3] draw, see
    ``grow.reinit_directions``). Growsplit: split the large Gaussians that
    are high-gradient OR were grown this round, by the learned split
    distance and scale where those are on (re-initialized unless
    ``split_notreinit``), else by ``noise`` as in :func:`densify_and_prune`.
    Draws not given come from ``generator``. Returns (params, mu, nu, aux,
    info) with n_cloned counting the grown copies."""
    from .grow import grow_offsets, reinit_directions

    capacity = aux.alive.shape[0]
    dev = aux.alive.device
    g = densification_grads(aux)
    hot = g >= cfg.grad_threshold
    sel_grow = aux.alive & hot
    free_idx = (~aux.alive).nonzero()[:, 0]
    with torch.no_grad():
        offsets = grow_offsets(params, sphere_dirs, grow_cfg)
    params, mu, nu, alive, n_grown, n_grow_want, grow_dest = _clone_into_free(
        params, mu, nu, aux.alive, sel_grow, free_idx, offsets=offsets)
    if not grow_cfg.prob_notreinit:
        params = reinit_directions(params, sel_grow, grow_cfg, generator,
                                   fresh)

    newly_grown = torch.zeros(capacity, dtype=torch.bool, device=dev)
    newly_grown[grow_dest] = True
    max_scale = torch.exp(params.scaling).max(dim=1).values
    sel_split = (alive & (hot | newly_grown)
                 & (max_scale > cfg.percent_dense * extent))

    split_dist = scale_div = None
    reset = {}
    if grow_cfg.learn_split_distance:
        split_dist = get_split_distance(params)
        reset["split_distance"] = params.split_distance
    if grow_cfg.learn_split_scale:
        scale_div = get_split_scale(params) * 2.0
        reset["split_scale"] = params.split_scale
    if not grow_cfg.split_notreinit:
        params = params._replace(**{
            k: torch.where(sel_split[:, None], 0.0, v)
            for k, v in reset.items()})
    if split_dist is None:
        noise = _draw_noise(capacity, dev, generator, noise)
    params, mu, nu, alive, n_split, n_split_want = _split_into_free(
        params, mu, nu, alive, sel_split, noise, free_idx, n_grown,
        grow_cfg.symmetric_split, split_dist=split_dist, scale_div=scale_div)

    n_dropped = (n_grow_want - n_grown) + (n_split_want - n_split)
    params, mu, nu, aux, n_pruned = _postfix_and_prune(
        params, mu, nu, alive, extent, cfg, size_threshold_active)
    info = {"n_cloned": n_grown, "n_split": n_split, "n_pruned": n_pruned,
            "n_dropped": n_dropped, "n_alive": int(aux.alive.sum())}
    return params, mu, nu, aux, info


def _postfix_and_prune(params, mu, nu, alive, extent, cfg: DensifyConfig,
                       size_threshold_active: bool):
    capacity = alive.shape[0]
    z = torch.zeros(capacity, dtype=torch.float32, device=alive.device)
    aux = GaussianAux(alive=alive, max_radii2d=z, xyz_grad_accum=z.clone(),
                      denom=z.clone())
    opac = torch.sigmoid(params.opacity[:, 0])
    prune = alive & (opac < cfg.min_opacity)
    if size_threshold_active:
        prune |= alive & (torch.exp(params.scaling).max(dim=1).values
                          > 0.1 * extent)
    # quarantine rows whose parameters are non-finite
    finite = None
    for leaf in params:
        if leaf is None:
            continue
        f = torch.isfinite(leaf).reshape(capacity, -1).all(-1)
        finite = f if finite is None else (finite & f)
    prune |= alive & ~finite
    n_pruned = int(prune.sum())
    aux = aux._replace(alive=alive & ~prune)
    _zero_rows(mu, prune)
    _zero_rows(nu, prune)
    return params, mu, nu, aux, n_pruned


def reset_opacity(params: GaussianParams, mu, nu):
    """Clamp opacities to ≤ 0.01 and zero the opacity Adam moments."""
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(params.opacity),
                                         max=0.01))
    return (params._replace(opacity=new_op),
            mu._replace(opacity=torch.zeros_like(mu.opacity)),
            nu._replace(opacity=torch.zeros_like(nu.opacity)))


def add_densification_stats(aux: GaussianAux, radii, ndc_grad,
                            visible) -> GaussianAux:
    """Per-iteration statistics: radii [C] int32, ndc_grad [C, 2] (the
    gradient with respect to the NDC offset), visible [C] bool."""
    gn = torch.linalg.vector_norm(ndc_grad[:, :2], dim=-1)
    return aux._replace(
        max_radii2d=torch.where(
            visible, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
            aux.max_radii2d),
        xyz_grad_accum=aux.xyz_grad_accum + torch.where(visible, gn, 0.0),
        denom=aux.denom + visible.to(torch.float32))
