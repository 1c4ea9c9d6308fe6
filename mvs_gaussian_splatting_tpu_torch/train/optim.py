"""Per-group Adam with explicit moment tuples.

Port of the JAX package's ``train/optim.py``: the reference's
``torch.optim.Adam(param_groups, lr=0.0, eps=1e-15)`` with the xyz learning
rate schedule, hand-rolled so that densification can write into the
moments directly (they are GaussianParams-shaped). One global step count
for every leaf, bias correction, eps added after the square root, and
alive-masked moments and steps. ``torch.optim.Adam`` is not this operator:
it keeps a count per parameter and knows no alive mask.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..models.gaussians import GaussianParams, params_from_numpy
from ..utils.schedules import expon_lr


class AdamState(NamedTuple):
    count: torch.Tensor   # scalar int32
    mu: GaussianParams    # first moments
    nu: GaussianParams    # second moments


def adam_init(params: GaussianParams) -> AdamState:
    def zeros():
        return GaussianParams(*[None if p is None else torch.zeros_like(p)
                                for p in params])
    return AdamState(count=torch.zeros((), dtype=torch.int32,
                                       device=params.xyz.device),
                     mu=zeros(), nu=zeros())


def adam_from_numpy(count, mu: Mapping[str, np.ndarray],
                    nu: Mapping[str, np.ndarray], device="cuda") -> AdamState:
    """AdamState on ``device`` from a step count and two moment dicts of
    numpy arrays keyed by GaussianParams field."""
    return AdamState(count=torch.tensor(int(count), dtype=torch.int32,
                                        device=device),
                     mu=params_from_numpy(mu, device),
                     nu=params_from_numpy(nu, device))


def group_lrs(opt_cfg, step, spatial_lr_scale,
              params: GaussianParams) -> GaussianParams:
    """The reference's param-group learning rates, one float per leaf: xyz
    follows the exponential schedule, f_rest is feature_lr / 20. None where
    ``params`` has None."""
    xyz_lr = expon_lr(step,
                      opt_cfg.position_lr_init * spatial_lr_scale,
                      opt_cfg.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=opt_cfg.position_lr_delay_mult,
                      max_steps=opt_cfg.position_lr_max_steps)
    lrs = GaussianParams(
        xyz=xyz_lr, f_dc=opt_cfg.feature_lr, f_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr, rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr, dirs_prob=opt_cfg.growdirs_lr,
        conti_dirs=opt_cfg.growdirs_lr, grow_dist=opt_cfg.growdistance_lr,
        split_distance=opt_cfg.splitdistance_lr,
        split_scale=opt_cfg.splitscale_lr)
    return GaussianParams(*[None if p is None else lr
                            for p, lr in zip(params, lrs)])


def scrub_grads(grads: GaussianParams):
    """Zero the gradients of rows carrying any non-finite value.

    One escaped NaN gradient would poison the row's Adam moments, then its
    parameters, then (through a NaN depth key) the instance sort of every
    later frame; this keeps such a row inert. Returns (scrubbed grads,
    number of rows zeroed), the count feeding
    StepMetrics.nonfinite_grad_rows."""
    finite = None
    for g in grads:
        if g is None:
            continue
        f = torch.isfinite(g).reshape(g.shape[0], -1).all(-1)
        finite = f if finite is None else (finite & f)
    scrubbed = GaussianParams(*[
        None if g is None else torch.where(
            finite.reshape((-1,) + (1,) * (g.dim() - 1)), g, 0.0)
        for g in grads])
    return scrubbed, (~finite).sum()


def adam_update(grads: GaussianParams, state: AdamState,
                params: GaussianParams, lrs: GaussianParams, alive=None,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step. ``lrs`` holds one float learning rate per leaf;
    ``alive`` masks updates (dead slots get neither moment updates nor
    parameter changes). Returns (new params, new AdamState)."""
    count = state.count + 1
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=cf.device), cf)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p, lr in zip(grads, state.mu, state.nu, params, lrs):
        if p is None:
            new_p.append(None)
            new_m.append(None)
            new_v.append(None)
            continue
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * (g * g)
        step = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if alive is not None:
            mask = alive.reshape((-1,) + (1,) * (g.dim() - 1))
            m_new = torch.where(mask, m_new, m)
            v_new = torch.where(mask, v_new, v)
            step = torch.where(mask, step, 0.0)
        new_p.append(p - step)
        new_m.append(m_new)
        new_v.append(v_new)
    return GaussianParams(*new_p), AdamState(count=count,
                                             mu=GaussianParams(*new_m),
                                             nu=GaussianParams(*new_v))
