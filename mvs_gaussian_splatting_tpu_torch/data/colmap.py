"""COLMAP sparse-reconstruction parsers (binary + text).

Replaces scene/colmap_loader.py (read_extrinsics_binary :180-212,
read_intrinsics_binary :215-241, read_points3D_binary :125-154 and the text
fallbacks). Binary layouts follow the COLMAP on-disk format
(src/base/reconstruction.cc): little-endian packed records. Points are parsed
vectorized with numpy instead of per-record struct loops — MipNeRF-360 scenes
have millions of track entries. The binary readers first try the C++
parsers of ``native/`` (built with ``g++`` at first use) and fall back to
the Python ones. :func:`write_pinhole_scene` writes a whole dataset the
readers take back (synthetic scenes, the card's smoke test).
"""

from __future__ import annotations

import math
import struct
from typing import Dict, NamedTuple

import numpy as np


class CameraIntrinsics(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ImageExtrinsics(NamedTuple):
    id: int
    qvec: np.ndarray   # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


# model_id → (name, num_params), COLMAP's camera model table.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → (w, x, y, z) quaternion (for dataset writers)."""
    t = np.trace(R)
    m = np.array([1 + t,
                  1 + R[0, 0] - R[1, 1] - R[2, 2],
                  1 - R[0, 0] + R[1, 1] - R[2, 2],
                  1 - R[0, 0] - R[1, 1] + R[2, 2]])
    i = int(np.argmax(m))
    s = 2.0 * math.sqrt(max(m[i], 1e-12))
    if i == 0:
        q = [m[0] * 2 / s / 2, (R[2, 1] - R[1, 2]) / s,
             (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    elif i == 1:
        q = [(R[2, 1] - R[1, 2]) / s, m[1] * 2 / s / 2,
             (R[0, 1] + R[1, 0]) / s, (R[2, 0] + R[0, 2]) / s]
    elif i == 2:
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
             m[2] * 2 / s / 2, (R[1, 2] + R[2, 1]) / s]
    else:
        q = [(R[1, 0] - R[0, 1]) / s, (R[2, 0] + R[0, 2]) / s,
             (R[1, 2] + R[2, 1]) / s, m[3] * 2 / s / 2]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def read_cameras_binary(path: str) -> Dict[int, CameraIntrinsics]:
    parsed = _native_cameras(path)
    if parsed is not None:
        return parsed
    out = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODELS[model_id]
            params = np.frombuffer(f.read(8 * n_params), dtype="<f8").copy()
            out[cam_id] = CameraIntrinsics(cam_id, name, int(width), int(height), params)
    return out


def read_images_binary(path: str) -> Dict[int, ImageExtrinsics]:
    parsed = _native_images(path)
    if parsed is not None:
        return parsed
    out = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            image_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.frombuffer(f.read(32), dtype="<f8").copy()
            tvec = np.frombuffer(f.read(24), dtype="<f8").copy()
            camera_id = struct.unpack("<i", f.read(4))[0]
            name_bytes = bytearray()
            while (c := f.read(1)) != b"\x00":
                name_bytes += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n2d, 1)  # skip 2D points (x f8, y f8, id i8)
            out[image_id] = ImageExtrinsics(image_id, qvec, tvec, camera_id,
                                            name_bytes.decode("utf-8"))
    return out


def read_points3d_binary(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N,1] f64)."""
    parsed = _native_points(path)
    if parsed is not None:
        return parsed
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        blob = f.read()
    xyz = np.empty((num, 3))
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty((num, 1))
    off = 0
    rec_head = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                         ("err", "<f8"), ("track_len", "<u8")])
    for i in range(num):
        rec = np.frombuffer(blob, dtype=rec_head, count=1, offset=off)[0]
        xyz[i] = rec["xyz"]
        rgb[i] = rec["rgb"]
        err[i] = rec["err"]
        off += rec_head.itemsize + 8 * int(rec["track_len"])
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, CameraIntrinsics]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cam_id, model = int(tok[0]), tok[1]
            out[cam_id] = CameraIntrinsics(cam_id, model, int(tok[2]), int(tok[3]),
                                           np.array(tok[4:], dtype=np.float64))
    return out


def read_images_text(path: str) -> Dict[int, ImageExtrinsics]:
    out = {}
    with open(path) as f:
        expecting_pose = True
        for raw in f:
            line = raw.strip()
            if expecting_pose:
                if not line or line.startswith("#"):
                    continue
                tok = line.split()
                image_id = int(tok[0])
                qvec = np.array(tok[1:5], dtype=np.float64)
                tvec = np.array(tok[5:8], dtype=np.float64)
                out[image_id] = ImageExtrinsics(image_id, qvec, tvec,
                                                int(tok[8]), tok[9])
                expecting_pose = False
            else:
                # the 2D-points line is consumed unconditionally — it may be
                # empty for an image with zero observations
                expecting_pose = True
    return out


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            xyzs.append([float(v) for v in tok[1:4]])
            rgbs.append([int(v) for v in tok[4:7]])
            errs.append([float(tok[7])])
    return (np.array(xyzs), np.array(rgbs, np.uint8), np.array(errs))


def write_cameras_binary(cams: Dict[int, CameraIntrinsics], path: str) -> None:
    """Inverse of read_cameras_binary (round-trip tests, synthetic fixtures)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(struct.pack("<iiQQ", cam.id, CAMERA_MODEL_IDS[cam.model],
                                cam.width, cam.height))
            f.write(np.asarray(cam.params, dtype="<f8").tobytes())


def write_images_binary(images: Dict[int, ImageExtrinsics], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, dtype="<f8").tobytes())
            f.write(np.asarray(im.tvec, dtype="<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q", i))
            f.write(np.asarray(xyz[i], dtype="<f8").tobytes())
            f.write(np.asarray(rgb[i], dtype="u1").tobytes())
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))


def write_pinhole_scene(path: str, cameras, images, xyz: np.ndarray,
                        rgb: np.ndarray) -> None:
    """A COLMAP dataset that ``read_colmap_scene`` reads back: one PINHOLE
    intrinsic and one pose per camera (``data.cameras.Camera``, its fovs and
    R / T), ``images/<image_name>.png`` from ``images`` ([H, W, 3] uint8
    arrays, one per camera), and the point cloud ``xyz`` / ``rgb`` (uint8)
    as ``sparse/0/points3D.ply``."""
    import os

    from PIL import Image

    from ..models.ply import store_point_cloud_ply
    from ..utils.graphics import fov2focal

    sparse = os.path.join(path, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    intr, extr = {}, {}
    for k, (cam, img) in enumerate(zip(cameras, images)):
        h, w = img.shape[:2]
        intr[k + 1] = CameraIntrinsics(
            k + 1, "PINHOLE", w, h,
            np.array([fov2focal(cam.fovx, w), fov2focal(cam.fovy, h),
                      w / 2, h / 2]))
        name = f"{cam.image_name}.png"
        # R is the camera-to-world rotation (W2C transposed)
        extr[k + 1] = ImageExtrinsics(k + 1, rotmat2qvec(np.asarray(cam.R).T),
                                      np.asarray(cam.T, np.float64), k + 1,
                                      name)
        Image.fromarray(np.asarray(img, np.uint8)).save(
            os.path.join(path, "images", name))
    write_cameras_binary(intr, os.path.join(sparse, "cameras.bin"))
    write_images_binary(extr, os.path.join(sparse, "images.bin"))
    store_point_cloud_ply(os.path.join(sparse, "points3D.ply"), xyz, rgb)


# ---- native fast path (native/, C++ via ctypes); None falls back to the
# Python parsers above

def _native_points(path: str):
    try:
        from .. import native
        return native.read_points3d(path)
    except Exception:
        return None


def _native_images(path: str):
    try:
        from .. import native
        raw = native.read_images(path)
        if raw is None:
            return None
        return {k: ImageExtrinsics(k, q, t, cid, name)
                for k, (q, t, cid, name) in raw.items()}
    except Exception:
        return None


def _native_cameras(path: str):
    try:
        from .. import native
        raw = native.read_cameras(path)
        if raw is None:
            return None
        out = {}
        for k, (model_id, w, h, params) in raw.items():
            name, n_params = CAMERA_MODELS[model_id]
            out[k] = CameraIntrinsics(k, name, w, h, params[:n_params].copy())
        return out
    except Exception:
        return None
