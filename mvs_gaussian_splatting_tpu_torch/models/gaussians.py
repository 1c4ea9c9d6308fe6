"""Gaussian scene state as a fixed-capacity tuple of tensors.

Port of the JAX package's ``models/gaussians.py``: raw, unactivated
parameters with the activations exp(scaling), normalize(rotation),
sigmoid(opacity), held in capacity-padded arrays with an alive mask
(:class:`GaussianAux`), so densification writes into free slots and the
loop grows capacity geometrically. :func:`params_from_numpy` and
:func:`aux_from_numpy` carry state in from numpy — the PLY loader's dict,
or ``np.asarray`` of each field of the JAX package's ``GaussianParams`` /
``GaussianAux``.

Grow mode's research extras (``dirs_prob``, ``conti_dirs``, ``grow_dist``,
``split_distance``, ``split_scale``) are leaves like the others when their
feature is on and None otherwise; their activations are
:func:`get_grow_dist`, :func:`get_split_distance` and
:func:`get_split_scale`.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..ops.knn import mean_sq_dist_to_knn
from ..utils.sh import rgb2sh
from ..utils.transforms import inverse_sigmoid, normalize


class GaussianParams(NamedTuple):
    """Optimized parameters, all [C, ...] (raw, unactivated)."""

    xyz: torch.Tensor        # [C, 3]
    f_dc: torch.Tensor       # [C, 1, 3]
    f_rest: torch.Tensor     # [C, (deg+1)^2-1, 3]
    scaling: torch.Tensor    # [C, 3] log-scale
    rotation: torch.Tensor   # [C, 4] unnormalized quaternion (w, x, y, z)
    opacity: torch.Tensor    # [C, 1] logit
    # Research extras (None when the feature is off).
    dirs_prob: Optional[torch.Tensor] = None       # [C, num_dirs]
    conti_dirs: Optional[torch.Tensor] = None      # [C, 3]
    grow_dist: Optional[torch.Tensor] = None       # [C, 1]
    split_distance: Optional[torch.Tensor] = None  # [C, 3]
    split_scale: Optional[torch.Tensor] = None     # [C, 1]


class GaussianAux(NamedTuple):
    """Non-optimized per-Gaussian training state."""

    alive: torch.Tensor           # [C] bool
    max_radii2d: torch.Tensor     # [C] float32
    xyz_grad_accum: torch.Tensor  # [C] float32 (accumulated |dL/d ndc_xy|)
    denom: torch.Tensor           # [C] float32


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device="cuda") -> GaussianParams:
    """GaussianParams on ``device`` from float32 numpy arrays keyed by field
    name; missing or None extras stay None."""
    unknown = set(d) - set(GaussianParams._fields)
    if unknown:
        raise ValueError(f"unknown GaussianParams fields {sorted(unknown)}")
    return GaussianParams(**{
        k: torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in d.items() if v is not None})


def activated(params: GaussianParams):
    """(scaling, rotation, opacity) through their activations."""
    return (torch.exp(params.scaling), normalize(params.rotation),
            torch.sigmoid(params.opacity[:, 0]))


def get_features(params: GaussianParams) -> torch.Tensor:
    """[C, (deg+1)^2, 3] SH coefficients, dc first."""
    return torch.cat([params.f_dc, params.f_rest], dim=1)


def get_grow_dist(params: GaussianParams) -> torch.Tensor:
    return 2.0 * torch.sigmoid(params.grow_dist)


def get_split_distance(params: GaussianParams) -> torch.Tensor:
    return 2.2 * torch.sigmoid(params.split_distance)


def get_split_scale(params: GaussianParams) -> torch.Tensor:
    return 0.6 * torch.sigmoid(params.split_scale) + 0.5


def extras_of(params: GaussianParams) -> dict:
    """The research-feature flags a GaussianParams carries leaves for."""
    return {"grow_dir": params.dirs_prob is not None,
            "continous_dir": params.conti_dirs is not None,
            "grow_distance": params.grow_dist is not None,
            "learn_split_distance": params.split_distance is not None,
            "learn_split_scale": params.split_scale is not None}


def aux_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> GaussianAux:
    """GaussianAux on ``device`` from numpy arrays keyed by field name."""
    return GaussianAux(
        alive=torch.tensor(np.asarray(d["alive"], bool), device=device),
        **{k: torch.tensor(np.asarray(d[k], np.float32), device=device)
           for k in GaussianAux._fields[1:]})


def to_numpy(tree) -> dict:
    """{field: numpy array} of a GaussianParams / GaussianAux, None fields
    left out."""
    return {k: v.detach().cpu().numpy() for k, v in tree._asdict().items()
            if v is not None}


def num_alive(aux: GaussianAux) -> torch.Tensor:
    return aux.alive.sum()


def _dead_fill(capacity: int, sh_rest: int, device, num_dirs: int = 128,
               extras: Optional[dict] = None) -> GaussianParams:
    """Safe parameter values for dead slots (never rendered, but keep all
    math finite: tiny scale, identity quat, ~0 opacity); the extras whose
    flag is set in ``extras`` start uniform (dirs_prob), along +x
    (conti_dirs) or at logit 0."""
    extras = extras or {}
    f32 = dict(dtype=torch.float32, device=device)
    rotation = torch.zeros((capacity, 4), **f32)
    rotation[:, 0] = 1.0
    conti = None
    if extras.get("continous_dir"):
        conti = torch.zeros((capacity, 3), **f32)
        conti[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), **f32),
        f_dc=torch.zeros((capacity, 1, 3), **f32),
        f_rest=torch.zeros((capacity, sh_rest, 3), **f32),
        scaling=torch.full((capacity, 3), -10.0, **f32),
        rotation=rotation,
        opacity=torch.full((capacity, 1), -10.0, **f32),
        dirs_prob=(torch.full((capacity, num_dirs), 1.0 / num_dirs, **f32)
                   if extras.get("grow_dir") else None),
        conti_dirs=conti,
        grow_dist=(torch.zeros((capacity, 1), **f32)
                   if extras.get("grow_distance") else None),
        split_distance=(torch.zeros((capacity, 3), **f32)
                        if extras.get("learn_split_distance") else None),
        split_scale=(torch.zeros((capacity, 1), **f32)
                     if extras.get("learn_split_scale") else None))


def _empty_aux(capacity: int, device) -> GaussianAux:
    z = torch.zeros(capacity, dtype=torch.float32, device=device)
    return GaussianAux(alive=torch.zeros(capacity, dtype=torch.bool,
                                         device=device),
                       max_radii2d=z, xyz_grad_accum=z.clone(),
                       denom=z.clone())


def init_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                  sh_degree: int = 3, *, extras: Optional[dict] = None,
                  num_dirs: int = 128, device="cuda",
                  generator: Optional[torch.Generator] = None,
                  conti_dirs=None):
    """Build (params, aux) from a point cloud: points/colors [N, 3] numpy,
    capacity >= N; slots N..C start dead. RGB → SH dc, zero rest,
    log(sqrt(3-NN mean squared distance)) scales, identity quats, opacity
    logit(0.1).

    ``extras``: the research-feature flags (grow_dir, continous_dir,
    grow_distance, learn_split_distance, learn_split_scale). The continuous
    directions of the N points are normalized N(0, 1) draws [N, 3], given
    as ``conti_dirs`` (the tests feed both packages one draw) or drawn from
    ``generator``."""
    n = points.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < initial points {n}")
    sh_rest = (sh_degree + 1) ** 2 - 1
    pts = torch.tensor(np.asarray(points, np.float32), device=device)
    dist2 = torch.clamp(mean_sq_dist_to_knn(pts), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    params = _dead_fill(capacity, sh_rest, device, num_dirs, extras)
    params.xyz[:n] = pts
    params.f_dc[:n, 0] = torch.tensor(
        np.asarray(rgb2sh(np.asarray(colors, np.float32)), np.float32),
        device=device)
    params.scaling[:n] = scales
    params.opacity[:n] = inverse_sigmoid(
        0.1 * torch.ones((n, 1), dtype=torch.float32, device=device))
    if params.conti_dirs is not None:
        if conti_dirs is None:
            draw = torch.randn((n, 3), generator=generator, device=device)
        else:
            draw = torch.as_tensor(np.asarray(conti_dirs, np.float32),
                                   device=device)
        params.conti_dirs[:n] = normalize(draw)
    aux = _empty_aux(capacity, device)
    aux.alive[:n] = True
    return params, aux


def pad_capacity(params: GaussianParams, aux: GaussianAux,
                 new_capacity: int):
    """Grow storage to ``new_capacity``; new slots are dead."""
    old = params.xyz.shape[0]
    if new_capacity < old:
        raise ValueError("capacity can only grow")
    dev = params.xyz.device
    num_dirs = (params.dirs_prob.shape[1] if params.dirs_prob is not None
                else 128)
    fill = _dead_fill(new_capacity, params.f_rest.shape[1], dev, num_dirs,
                      extras_of(params))
    for f, p in zip(fill, params):
        if p is not None:
            f[:old] = p
    new_aux = _empty_aux(new_capacity, dev)
    for f, a in zip(new_aux, aux):
        f[:old] = a
    return fill, new_aux


def compact(params: GaussianParams, aux: GaussianAux) -> dict:
    """The alive Gaussians as a dict of numpy arrays [n_alive, ...] (e.g.
    for PLY export)."""
    idx = aux.alive.nonzero()[:, 0]
    return {name: arr[idx].detach().cpu().numpy()
            for name, arr in params._asdict().items() if arr is not None}


def compact_state(params: GaussianParams, mu, nu, aux: GaussianAux):
    """Permute every per-point array so the alive slots form a prefix
    (stable among the alive), so the training step can render a
    ``[:render_n]`` slice instead of the padded capacity."""
    perm = torch.argsort((~aux.alive).to(torch.uint8), stable=True)

    def take(tree):
        return type(tree)(*[None if a is None else a[perm] for a in tree])

    return take(params), take(mu), take(nu), take(aux)
