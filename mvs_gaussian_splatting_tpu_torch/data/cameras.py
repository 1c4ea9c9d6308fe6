"""Host-side camera objects.

Port of the JAX package's ``data/cameras.py``: a Camera owns numpy
matrices and, optionally, the ground-truth image; ``view(device)`` yields
the float32 :class:`CameraView` the rasterizer takes, and
``device_image(device)`` the image as a tensor. Pose-only cameras
(``image=None``) render fine. :func:`camera_from_json` inverts
:func:`camera_to_json`, so a model directory's ``cameras.json`` alone gives
renderable poses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops.preprocess import CameraView
from ..utils import graphics

_WARNED = False


@dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray            # C2W rotation (transposed W2C, reference convention)
    T: np.ndarray            # W2C translation
    fovx: float
    fovy: float
    image: Optional[np.ndarray]   # [3, H, W] float32 in [0, 1], None for pose-only
    image_name: str
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        W2V = graphics.world_to_view(self.R, self.T, self.trans, self.scale)
        P = graphics.projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)
        self.world_view = W2V.astype(np.float32)          # column-vector conv.
        self.full_proj = (P @ W2V).astype(np.float32)
        self.camera_center = np.linalg.inv(W2V)[:3, 3].astype(np.float32)
        self._device_images = {}

    def device_image(self, device="cuda") -> torch.Tensor:
        """The ground-truth image [3, H, W] on ``device``, uploaded once."""
        if self.image is None:
            raise ValueError(f"camera {self.image_name} has no image")
        key = str(device)
        if key not in self._device_images:
            self._device_images[key] = torch.as_tensor(self.image,
                                                       device=device)
        return self._device_images[key]

    def view(self, device="cuda") -> CameraView:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return CameraView(viewmatrix=f32(self.world_view),
                          projmatrix=f32(self.full_proj),
                          campos=f32(self.camera_center),
                          tanfovx=f32(math.tan(self.fovx * 0.5)),
                          tanfovy=f32(math.tan(self.fovy * 0.5)))


def resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0):
    """The reference's downscale policy: -1 → cap width at 1.6K; 1/2/4/8 →
    divide; other positive values → target width."""
    global _WARNED
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        if orig_w > 1600:
            if not _WARNED:
                print("[ INFO ] Large input images (>1.6K width) — rescaling "
                      "to 1.6K. Use --resolution 1 to disable.")
                _WARNED = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera(cam_info, uid: int, resolution: int,
                resolution_scale: float = 1.0) -> Camera:
    """cam_info: data.readers.CameraInfo with a PIL image attached (or None)."""
    pil = cam_info.image
    if pil is not None:
        target = resolve_resolution(pil.size[0], pil.size[1], resolution,
                                    resolution_scale)
        resized = pil.resize(target)
        arr = np.asarray(resized, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        chw = np.clip(arr.transpose(2, 0, 1), 0.0, 1.0)
        rgb = chw[:3]
        if chw.shape[0] == 4:
            rgb = rgb * chw[3:4]   # alpha-mask multiply
        width, height = target
    else:
        rgb = None
        width, height = cam_info.width, cam_info.height
    return Camera(uid=uid, colmap_id=cam_info.uid, R=cam_info.R, T=cam_info.T,
                  fovx=cam_info.FovX, fovy=cam_info.FovY, image=rgb,
                  image_name=cam_info.image_name, width=width, height=height)


def camera_to_json(uid: int, cam: Camera) -> dict:
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    return {
        "id": uid,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": C2W[:3, 3].tolist(),
        "rotation": [r.tolist() for r in C2W[:3, :3]],
        "fy": graphics.fov2focal(cam.fovy, cam.height),
        "fx": graphics.fov2focal(cam.fovx, cam.width),
    }


def camera_from_json(entry: dict) -> Camera:
    """Pose-only Camera from one :func:`camera_to_json` entry."""
    C2W = np.eye(4)
    C2W[:3, :3] = np.asarray(entry["rotation"], np.float64)
    C2W[:3, 3] = np.asarray(entry["position"], np.float64)
    W2C = np.linalg.inv(C2W)
    w, h = int(entry["width"]), int(entry["height"])
    return Camera(uid=int(entry["id"]), colmap_id=int(entry["id"]),
                  R=W2C[:3, :3].T, T=W2C[:3, 3],
                  fovx=graphics.focal2fov(entry["fx"], w),
                  fovy=graphics.focal2fov(entry["fy"], h), image=None,
                  image_name=entry["img_name"], width=w, height=h)
