"""Scene container, read-only: cameras + point cloud of a dataset.

Port of the JAX package's ``data/scene.py`` for rendering a trained model:
dataset dispatch and per-resolution-scale camera lists. It writes nothing
into the model directory (the training slice adds that).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..train.config import ModelConfig
from .cameras import Camera, load_camera
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

    def get_train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.test_cameras[scale]
