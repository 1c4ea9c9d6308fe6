"""Grow mode: the fork's learnable densification.

Port of the JAX package's ``models/grow.py``:

- grow directions: a per-Gaussian 128-way softmax over the Fibonacci
  sphere with a straight-through argmax, or a continuous unit vector, plus
  a learnable grow distance;
- learned split distance and split scale;
- :func:`speculative_augment`: the render set of a grow-mode step, the
  live Gaussians plus a block of ``spec_size`` grown candidates and one of
  ``spec_size`` mirrored split children, so the learnable parameters get
  gradients before densification commits them;
- :func:`densify_grow`: the commit-time grow on its own.

Fixed-size index lists keep the JAX package's ``jnp.nonzero(mask,
size=s, fill_value=n)`` contract (the first ``s`` indices in ascending
order, padded with ``n``) without a host sync (:func:`nonzero_padded`).
Every random draw is a tensor argument, or is drawn from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.transforms import normalize, quat_to_rotmat
from .densify import _clone_into_free, densification_grads
from .gaussians import (GaussianAux, GaussianParams, get_grow_dist,
                        get_split_distance, get_split_scale)


class GrowConfig(NamedTuple):
    grow_dir: bool = False
    continous_dir: bool = False
    grow_distance: bool = False
    learn_split_distance: bool = False
    learn_split_scale: bool = False
    num_dirs: int = 128
    prob_notreinit: bool = False
    split_notreinit: bool = False
    symmetric_split: bool = False


def nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The first ``size`` indices where ``mask`` is set, ascending, padded
    with ``fill`` (int64 [size]); a cumsum and a scatter, no host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, device=mask.device))
    return out[:size]


def straight_through_argmax(logits: torch.Tensor, tau: float = 1.0,
                            dim: int = -1) -> torch.Tensor:
    """Hard one-hot forward (the first maximum), softmax gradients."""
    y_soft = torch.softmax(logits / tau, dim=dim)
    idx = torch.argmax(y_soft, dim=dim)
    y_hard = F.one_hot(idx, logits.shape[dim]).to(logits.dtype)
    if dim not in (-1, logits.dim() - 1):
        y_hard = y_hard.movedim(-1, dim)
    return y_hard - y_soft.detach() + y_soft


def grow_offsets(params: GaussianParams, sphere_dirs: Optional[torch.Tensor],
                 cfg: GrowConfig) -> torch.Tensor:
    """Per-Gaussian grow displacement Δxyz [C, 3]: direction × max scale ×
    learned distance. ``sphere_dirs`` [num_dirs, 3] float32 (grow_dir)."""
    if cfg.grow_dir:
        one_hot = straight_through_argmax(params.dirs_prob)
        dirs = one_hot @ sphere_dirs                      # f32, no TF32
    elif cfg.continous_dir:
        dirs = normalize(params.conti_dirs)
    else:
        raise ValueError("grow_offsets needs grow_dir or continous_dir")
    dist = get_grow_dist(params) if cfg.grow_distance else 1.0
    # amax: a tie shares the gradient evenly, as the JAX package's max does
    shift = torch.amax(torch.exp(params.scaling), dim=1, keepdim=True)
    return dirs * shift * dist


def speculative_augment(params: GaussianParams, aux: GaussianAux,
                        grads_stat: torch.Tensor, sphere_dirs,
                        cfg: GrowConfig, grad_threshold: float, extent,
                        percent_dense: float, spec_size: int,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> dict:
    """The augmented render set: C base Gaussians + ``spec_size`` grown
    candidates + ``spec_size`` mirrored split children, the originals
    selected for a split moved and shrunk in place.

    Returns a dict of raw parameter tensors (xyz, scaling, rotation, f_dc,
    f_rest, opacity), each [C + 2·spec_size, ...], with ``alive``,
    ``grow_idx`` and ``grow_ok``. Gradients reach dirs_prob / conti_dirs /
    grow_dist / split_distance / split_scale through them. Without a
    learned split distance the split offsets are N(0, 1) [C + spec_size, 3]
    draws times the scale: ``noise``, or drawn from ``generator``."""
    capacity = params.xyz.shape[0]
    s = spec_size
    dev = params.xyz.device
    has_grow = cfg.grow_dir or cfg.continous_dir

    sel = aux.alive & (grads_stat >= grad_threshold)
    grow_idx = nonzero_padded(sel, s, capacity)
    grow_ok = ((grow_idx < capacity) if has_grow
               else torch.zeros(s, dtype=torch.bool, device=dev))
    gi = torch.clamp(grow_idx, 0, capacity - 1)

    def take(leaf, idx):
        # index_select: its backward is one index_add_, where indexing's
        # sorts the indices first
        return torch.index_select(leaf, 0, idx)

    if has_grow:
        offsets = grow_offsets(params, sphere_dirs, cfg)  # [C, 3]
        grown_xyz = take(params.xyz, gi) + take(offsets, gi)
    else:
        # the split-only branch: no grow candidates
        grown_xyz = take(params.xyz, gi)

    def cat_take(leaf):
        return torch.cat([leaf, take(leaf, gi)], 0)

    xyz = torch.cat([params.xyz, grown_xyz], 0)
    scaling = cat_take(params.scaling)
    rotation = cat_take(params.rotation)
    f_dc = cat_take(params.f_dc)
    f_rest = cat_take(params.f_rest)
    opacity = cat_take(params.opacity)
    alive = torch.cat([aux.alive, grow_ok], 0)

    if cfg.learn_split_distance or cfg.learn_split_scale:
        n_aug = capacity + s
        # the grown candidates are split candidates whatever their gradient
        padded_grad = torch.cat([grads_stat, torch.full(
            (s,), float("inf"), dtype=grads_stat.dtype, device=dev)], 0)
        scal_aug = torch.exp(scaling)
        split_sel = (alive & (padded_grad >= grad_threshold)
                     & (scal_aug.max(dim=1).values > percent_dense * extent))
        sp_idx = nonzero_padded(split_sel, s, n_aug)
        sp_ok = sp_idx < n_aug
        si = torch.clamp(sp_idx, 0, n_aug - 1)

        if cfg.learn_split_distance:
            sd = get_split_distance(params)               # [C, 3]
            samples = scal_aug * torch.cat([sd, take(sd, gi)], 0)
        else:
            if noise is None:
                noise = torch.randn((n_aug, 3), generator=generator,
                                    device=dev)
            samples = torch.as_tensor(noise, dtype=torch.float32,
                                      device=dev) * scal_aug
        R = quat_to_rotmat(rotation)
        delta = (R * samples[:, None, :]).sum(-1)         # [n_aug, 3]

        if cfg.learn_split_scale:
            ss = get_split_scale(params)                  # [C, 1]
            shrink = torch.cat([ss, take(ss, gi)], 0) * 2.0  # divisor
        else:
            shrink = torch.full((n_aug, 1), 1.6, device=dev)
        new_log_scaling = torch.log(scal_aug / shrink)

        onehot = torch.zeros(n_aug, device=dev).index_add(
            0, si, sp_ok.to(torch.float32))[:, None]
        # in place: the originals move by +delta and shrink
        xyz = xyz + onehot * delta
        scaling = torch.where(onehot > 0, new_log_scaling, scaling)
        # the mirrored children at -delta (xyz already holds +delta)
        child_xyz = take(xyz, si) - 2.0 * take(delta, si)
        xyz = torch.cat([xyz, child_xyz], 0)
        scaling = torch.cat([scaling, take(new_log_scaling, si)], 0)
        rotation = torch.cat([rotation, take(rotation, si)], 0)
        f_dc = torch.cat([f_dc, take(f_dc, si)], 0)
        f_rest = torch.cat([f_rest, take(f_rest, si)], 0)
        opacity = torch.cat([opacity, take(opacity, si)], 0)
        alive = torch.cat([alive, sp_ok], 0)
    else:
        def pad(a, fill=0.0):
            return torch.cat([a, torch.full((s,) + a.shape[1:], fill,
                                            dtype=a.dtype, device=dev)], 0)
        xyz, f_dc, f_rest = pad(xyz), pad(f_dc), pad(f_rest)
        scaling, opacity = pad(scaling, -10.0), pad(opacity, -10.0)
        ident = torch.zeros((s, 4), device=dev)
        ident[:, 0] = 1.0
        rotation = torch.cat([rotation, ident], 0)
        alive = torch.cat([alive, torch.zeros(s, dtype=torch.bool,
                                              device=dev)], 0)

    return {"xyz": xyz, "scaling": scaling, "rotation": rotation,
            "f_dc": f_dc, "f_rest": f_rest, "opacity": opacity,
            "alive": alive, "grow_idx": grow_idx, "grow_ok": grow_ok}


def reinit_directions(params: GaussianParams, sel: torch.Tensor,
                      cfg: GrowConfig,
                      generator: Optional[torch.Generator] = None,
                      fresh=None) -> GaussianParams:
    """Re-initialize the grow parameters of the rows ``sel``: uniform
    dirs_prob, fresh continuous directions (normalized N(0, 1) [C, 3]
    draws: ``fresh``, or drawn from ``generator``), grow distance logit 0."""
    selc = sel[:, None]
    if cfg.grow_dir:
        params = params._replace(dirs_prob=torch.where(
            selc, 1.0 / cfg.num_dirs, params.dirs_prob))
    elif cfg.continous_dir:
        dev = params.conti_dirs.device
        if fresh is None:
            fresh = torch.randn(params.conti_dirs.shape, generator=generator,
                                device=dev)
        fresh = normalize(torch.as_tensor(fresh, dtype=torch.float32,
                                          device=dev))
        params = params._replace(conti_dirs=torch.where(
            selc, fresh, params.conti_dirs))
    if cfg.grow_distance:
        params = params._replace(grow_dist=torch.where(
            selc, 0.0, params.grow_dist))
    return params


def densify_grow(params: GaussianParams, mu, nu, aux: GaussianAux,
                 sphere_dirs, cfg: GrowConfig, grad_threshold: float,
                 generator: Optional[torch.Generator] = None, fresh=None):
    """Commit-time grow: copy every high-gradient Gaussian into a free slot
    at xyz + its learned offset (no scale gate), then re-initialize the
    ORIGINAL's direction parameters unless ``prob_notreinit`` (``fresh``:
    see :func:`reinit_directions`). Returns (params, mu, nu, aux, info)
    with the counts n_grown and n_dropped as ints."""
    g = densification_grads(aux)
    sel = aux.alive & (g >= grad_threshold)
    with torch.no_grad():
        offsets = grow_offsets(params, sphere_dirs, cfg)
    free_idx = (~aux.alive).nonzero()[:, 0]
    params, mu, nu, alive, n_grown, n_want, _ = _clone_into_free(
        params, mu, nu, aux.alive, sel, free_idx, offsets=offsets)
    if not cfg.prob_notreinit:
        params = reinit_directions(params, sel, cfg, generator, fresh)
    return params, mu, nu, aux._replace(alive=alive), {
        "n_grown": n_grown, "n_dropped": n_want - n_grown}
