"""Camera/projection math.

Semantics match the reference's utils/graphics_utils.py (getWorld2View2:38-49,
getProjectionMatrix:51-71, fov2focal/focal2fov:73-77) so that cameras built
from the same COLMAP/Blender inputs produce identical matrices. Pure
numpy: functions take and return numpy arrays (host-side camera setup)
unless noted.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray  # [N, 3] float
    colors: np.ndarray  # [N, 3] float in [0, 1]
    normals: np.ndarray  # [N, 3] float


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world→camera matrix (column-vector convention: x_cam = W2V @ x_world).

    ``R`` is the camera-to-world rotation as stored by the COLMAP reader
    (transposed qvec rotation), ``t`` the world→camera translation.
    ``translate``/``scale`` optionally recenters/rescales the camera center
    (NeRF++-style normalization hooks; the reference passes zeros/1.0).
    """
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is None and scale == 1.0:
        return np.float32(Rt)
    if translate is None:
        translate = np.zeros(3)
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style asymmetric-frustum projection, z into [0, 1], z_sign = +1.

    Column-vector convention (clip = P @ cam). Matches the reference exactly.
    """
    tan_half_y = math.tan(fovy / 2)
    tan_half_x = math.tan(fovx / 2)
    top = tan_half_y * znear
    right = tan_half_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def ndc2pix(v, size):
    """NDC [-1, 1] → pixel coordinate, matching the rasterizer's convention.

    Maps so that the continuous pixel coordinate of pixel index i is exactly i
    (the reference composites at integer pixel coordinates, not centers).
    """
    return ((v + 1.0) * size - 1.0) * 0.5


def nerfpp_norm(cam_to_world_centers: np.ndarray) -> dict:
    """NeRF++-style scene normalization from camera centers [N, 3].

    Returns translate (−mean center) and radius (1.1 × max distance from the
    mean center), matching scene/dataset_readers.py:45-66.
    """
    centers = np.asarray(cam_to_world_centers, dtype=np.float64)
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    diagonal = float(dist.max()) if len(dist) else 0.0
    return {"translate": -avg, "radius": diagonal * 1.1}
