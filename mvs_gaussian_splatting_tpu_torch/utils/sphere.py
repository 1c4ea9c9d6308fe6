"""Fibonacci-sphere direction codebook of grow mode.

Port of the JAX package's ``utils/sphere.py``: n points at golden-angle-
spaced azimuths with z linearly spaced in [1-1/n, 1/n-1].
"""

from __future__ import annotations

import numpy as np


def sphere_points(n: int = 128) -> np.ndarray:
    golden_angle = np.pi * (3 - np.sqrt(5))
    theta = golden_angle * np.arange(n)
    z = np.linspace(1 - 1.0 / n, 1.0 / n - 1, n)
    radius = np.sqrt(1 - z * z)
    return np.stack([radius * np.cos(theta), radius * np.sin(theta), z], axis=1)
