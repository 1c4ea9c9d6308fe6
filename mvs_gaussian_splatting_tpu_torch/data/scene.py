"""Scene container: cameras + point cloud + model-directory artifacts.

Port of the JAX package's ``data/scene.py``: dataset dispatch,
per-resolution-scale camera lists, the scene radius (``cameras_extent``),
and, for a new model (no ``load_iteration``), ``input.ply`` and
``cameras.json`` in the model directory; :meth:`Scene.save` writes a
trained model's PLY through the port's ``models/ply.py``.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import Dict, List, Optional

from ..models import ply as plyio
from ..train.config import ModelConfig
from .cameras import Camera, camera_to_json, load_camera
from .readers import SceneInfo, read_scene


class Scene:
    def __init__(self, cfg: ModelConfig, *, load_iteration=None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 scene_info: Optional[SceneInfo] = None):
        self.cfg = cfg
        self.model_path = cfg.model_path
        self.loaded_iter = load_iteration

        info = scene_info if scene_info is not None else read_scene(
            cfg.source_path, cfg.images, cfg.white_background, cfg.eval)
        self.info = info
        self.cameras_extent = info.nerf_normalization["radius"]
        writes = not self.loaded_iter and self.model_path
        if writes:
            os.makedirs(self.model_path, exist_ok=True)
            if info.ply_path and os.path.exists(info.ply_path):
                shutil.copyfile(info.ply_path,
                                os.path.join(self.model_path, "input.ply"))

        self.train_cameras: Dict[float, List[Camera]] = {}
        self.test_cameras: Dict[float, List[Camera]] = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                load_camera(c, i, cfg.resolution, scale)
                for i, c in enumerate(info.train_cameras)]
            self.test_cameras[scale] = [
                load_camera(c, i, cfg.resolution, scale)
                for i, c in enumerate(info.test_cameras)]
            if shuffle:
                random.shuffle(self.train_cameras[scale])
                random.shuffle(self.test_cameras[scale])

        if writes:
            cams = (self.train_cameras[resolution_scales[0]]
                    + self.test_cameras[resolution_scales[0]])
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)],
                          f)

    def get_train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.test_cameras[scale]

    def ply_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}")

    def save(self, iteration: int, gaussians: dict) -> None:
        """gaussians: compacted raw arrays (models.gaussians.compact)."""
        plyio.save_gaussian_ply(
            os.path.join(self.ply_dir(iteration), "point_cloud.ply"),
            gaussians)
