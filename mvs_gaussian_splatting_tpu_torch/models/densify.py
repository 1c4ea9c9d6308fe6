"""Adaptive density control on capacity-padded state, vanilla mode.

Port of the JAX package's ``models/densify.py``: clone writes copies of
small high-gradient Gaussians into free (dead) slots; split writes child 1
over the parent slot and child 2 into a free slot; prune clears alive bits
and zeroes the Adam moments of the cleared slots; new slots start with zero
moments. Slots are assigned exactly as the JAX package assigns them (free
slots in index order, clones first), so the two packages produce the same
state from the same split noise.

The reference's screen-size prune never fires (max_radii2d is zeroed
before it is read) and is not ported. Reference quirks kept: the gradient
statistic is ‖accumulated NDC gradient‖ / denom with NaN → 0; the world-size prune
reads the post-split scales. The grow-mode round
(``densify_and_prune_grow``) is not ported (ROADMAP A12).

Functions return new tuples; the tensors they are given may be updated in
place (the loop never reads the old state again), which keeps the [C, ...]
copies out of the densify round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.transforms import inverse_sigmoid, quat_to_rotmat
from .gaussians import GaussianAux, GaussianParams


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
    dev = aux.alive.device
    g = densification_grads(aux)
    scal = torch.exp(params.scaling)
    max_scale = scal.max(dim=1).values
    dense_lim = cfg.percent_dense * extent
    hot = aux.alive & (g >= cfg.grad_threshold)
    sel_clone = hot & (max_scale <= dense_lim)
    sel_split = hot & (max_scale > dense_lim)
    free_idx = (~aux.alive).nonzero()[:, 0]
    n_free = int(free_idx.shape[0])
    alive = aux.alive.clone()

    if noise is None:
        n1 = torch.randn((capacity, 3), generator=generator, device=dev)
        n2 = torch.randn((capacity, 3), generator=generator, device=dev)
    else:
        n1, n2 = (torch.tensor(np.asarray(x), dtype=torch.float32,
                               device=dev) for x in noise)

    # clone: copies of the selected rows into the first free slots
    src = sel_clone.nonzero()[:, 0]
    n_clone_want = int(src.shape[0])
    n_cloned = min(n_clone_want, n_free)
    src, dest = src[:n_cloned], free_idx[:n_cloned]
    _set_rows(params, dest, _rows(params, src))
    _zero_rows(mu, dest)
    _zero_rows(nu, dest)
    alive[dest] = True

    # split: child 2 into the next free slots, child 1 over the parent; a
    # parent whose child-2 slot was not granted stays as it is
    split_src = sel_split.nonzero()[:, 0]
    n_split_want = int(split_src.shape[0])
    n_split = max(0, min(n_split_want, n_free - n_cloned))
    split_src = split_src[:n_split]
    dest = free_idx[n_cloned:n_cloned + n_split]
    s = scal[split_src]
    noise1 = n1[split_src] * s
    noise2 = -noise1 if cfg.symmetric_split else n2[split_src] * s
    rot = quat_to_rotmat(params.rotation[split_src])
    off1 = (rot * noise1[:, None, :]).sum(-1)
    off2 = (rot * noise2[:, None, :]).sum(-1)
    new_scaling = torch.log(s / 1.6)
    parent = _rows(params, split_src)
    _set_rows(params, dest, parent)
    params.xyz[dest] = parent.xyz + off2
    params.scaling[dest] = new_scaling
    params.xyz[split_src] = parent.xyz + off1
    params.scaling[split_src] = new_scaling
    for tree in (mu, nu):
        _zero_rows(tree, dest)
        _zero_rows(tree, split_src)
    alive[dest] = True

    n_dropped = (n_clone_want - n_cloned) + (n_split_want - n_split)
    params, mu, nu, aux, n_pruned = _postfix_and_prune(
        params, mu, nu, alive, extent, cfg, size_threshold_active)
    info = {"n_cloned": n_cloned, "n_split": n_split, "n_pruned": n_pruned,
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


def densify_and_prune_grow(*args, **kwargs):
    raise NotImplementedError("grow-mode densification (densify_and_grow / "
                              "growsplit) is not ported (ROADMAP A12)")


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
