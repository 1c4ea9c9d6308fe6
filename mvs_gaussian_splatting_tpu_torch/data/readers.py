"""Scene readers: COLMAP and Blender(NeRF-Synthetic) dataset ingestion.

Replaces scene/dataset_readers.py: readColmapSceneInfo :132-177 (bin→txt
fallback, every-8th test split), readNerfSyntheticInfo :221-255 (alpha
composite onto bg, random 100K-point init), getNerfppNorm :45-66.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
from PIL import Image

from ..models import ply as plyio
from ..utils import graphics
from ..utils.sh import sh2rgb
from . import colmap


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: Optional[Image.Image]
    image_path: str
    image_name: str
    width: int
    height: int


class SceneInfo(NamedTuple):
    points: np.ndarray          # [N, 3]
    colors: np.ndarray          # [N, 3] in [0, 1]
    normals: np.ndarray
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def _read_colmap_cameras(extr, intr, images_folder, load_images=True):
    infos = []
    for key in extr:
        e = extr[key]
        i = intr[e.camera_id]
        R = np.transpose(colmap.qvec2rotmat(e.qvec))
        T = np.array(e.tvec)
        if i.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            focal_x = i.params[0]
            fovy = graphics.focal2fov(focal_x, i.height)
            fovx = graphics.focal2fov(focal_x, i.width)
        elif i.model == "PINHOLE":
            fovy = graphics.focal2fov(i.params[1], i.height)
            fovx = graphics.focal2fov(i.params[0], i.width)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {i.model}: undistort to "
                "PINHOLE/SIMPLE_PINHOLE first (convert.py)")
        image_path = os.path.join(images_folder, os.path.basename(e.name))
        image_name = os.path.basename(image_path).split(".")[0]
        img = Image.open(image_path) if load_images else None
        infos.append(CameraInfo(uid=i.id, R=R, T=T, FovY=fovy, FovX=fovx,
                                image=img, image_path=image_path,
                                image_name=image_name, width=i.width,
                                height=i.height))
    return infos


def _nerfpp_norm(cam_infos):
    centers = []
    for cam in cam_infos:
        W2C = graphics.world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(W2C)[:3, 3])
    return graphics.nerfpp_norm(np.stack(centers))


def read_colmap_scene(path: str, images: str = "images", eval_split: bool = False,
                      llffhold: int = 8, load_images: bool = True) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    infos = _read_colmap_cameras(extr, intr, os.path.join(path, images),
                                 load_images)
    infos = sorted(infos, key=lambda c: c.image_name)
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    norm = _nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        plyio.store_point_cloud_ply(ply_path, xyz, rgb)
    points, colors, normals = plyio.fetch_point_cloud_ply(ply_path)
    return SceneInfo(points, colors, normals, train, test, norm, ply_path)


def _read_blender_cameras(path, transformsfile, white_background, extension=".png"):
    infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1          # OpenGL → COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        image = Image.open(cam_name)
        im_data = np.array(image.convert("RGBA")) / 255.0
        bg = np.ones(3) if white_background else np.zeros(3)
        arr = im_data[:, :, :3] * im_data[:, :, 3:4] + bg * (1 - im_data[:, :, 3:4])
        image = Image.fromarray((arr * 255.0).astype(np.uint8), "RGB")
        fovy = graphics.focal2fov(graphics.fov2focal(fovx, image.size[0]),
                                  image.size[1])
        infos.append(CameraInfo(uid=idx, R=R, T=T, FovY=fovy, FovX=fovx,
                                image=image, image_path=cam_name,
                                image_name=Path(cam_name).stem,
                                width=image.size[0], height=image.size[1]))
    return infos


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False,
                       extension: str = ".png") -> SceneInfo:
    train = _read_blender_cameras(path, "transforms_train.json",
                                  white_background, extension)
    test = _read_blender_cameras(path, "transforms_test.json",
                                 white_background, extension)
    if not eval_split:
        train = train + test
        test = []
    norm = _nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.RandomState(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        plyio.store_point_cloud_ply(ply_path, xyz,
                                    (np.asarray(sh2rgb(shs)) * 255).astype(np.uint8))
    points, colors, normals = plyio.fetch_point_cloud_ply(ply_path)
    return SceneInfo(points, colors, normals, train, test, norm, ply_path)


def read_scene(source_path: str, images: str = "images",
               white_background: bool = False, eval_split: bool = False,
               load_images: bool = True) -> SceneInfo:
    """Dataset-type dispatch (scene/__init__.py:37-44)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path, images, eval_split,
                                 load_images=load_images)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return read_blender_scene(source_path, white_background, eval_split)
    raise ValueError(f"could not recognize scene type for {source_path}")
