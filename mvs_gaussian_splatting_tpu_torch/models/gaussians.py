"""Gaussian scene parameters as a NamedTuple of tensors.

Port of the JAX package's ``models/gaussians.py`` (the subset the render
path needs): raw, unactivated parameters with the activations exp(scaling),
normalize(rotation), sigmoid(opacity). :func:`params_from_numpy` carries
weights in from numpy — the PLY loader's dict, or ``np.asarray`` of each
field of a JAX ``GaussianParams``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..utils.transforms import normalize


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
