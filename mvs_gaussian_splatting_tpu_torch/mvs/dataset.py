"""Datasets for the generalizable MVS→Gaussian branch (BASELINE config #4).

Port of the JAX package's ``mvs/dataset.py``. Two sources, one group
format:

- :func:`load_dtu_scan` — the MVSNeRF/MVSGaussian DTU layout
  (``Cameras/pair.txt`` + per-view ``*_cam.txt`` with extrinsic/intrinsic/
  depth-range blocks + ``Rectified/scan*/rect_*.png`` images), read with
  PIL as the JAX module reads it;
- :func:`make_synthetic_groups` — a random Gaussian scene rendered from an
  arc of cameras through the port's preprocess + rasterize (B1 on a card,
  its plain version on the CPU), from the same ``np.random.RandomState``
  draws as the JAX module, so one seed gives one scene in both packages.

A *group* is (reference view, V source views, target view): the model builds
its cost volume in the reference frustum from {ref, srcs} and is supervised
by rendering the held-out target. Views hold numpy arrays.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..utils import graphics


@dataclass
class MVSView:
    image: np.ndarray          # [3, H, W] float32 in [0, 1]
    K: np.ndarray              # [3, 3] intrinsics at image resolution
    w2c: np.ndarray            # [4, 4] world→camera
    near: float
    far: float
    # optional alpha-composited expected-depth map [H, W] (0 where nothing
    # renders) — synthetic fixtures provide it for depth supervision
    # (MVSConfig.lambda_depth); DTU loaders leave it None
    depth: Optional[np.ndarray] = None

    @property
    def height(self) -> int:
        return self.image.shape[1]

    @property
    def width(self) -> int:
        return self.image.shape[2]


@dataclass
class MVSGroup:
    ref: MVSView
    srcs: List[MVSView]
    target: MVSView


# ---------------------------------------------------------------------------
# DTU (MVSNeRF layout)
# ---------------------------------------------------------------------------

def parse_cam_txt(text: str):
    """MVSNet camera file → (w2c [4,4], K [3,3], near, far).

    Format: an ``extrinsic`` block of 4 rows, an ``intrinsic`` block of 3
    rows, then a depth line ``depth_min depth_interval [num depth_max]``."""
    nums = {}
    section = None
    rows: List[List[float]] = []
    depth_line: List[float] = []
    for line in text.splitlines():
        s = line.strip()
        if not s:
            continue
        low = s.lower()
        if low.startswith("extrinsic"):
            section = "extrinsic"
            rows = []
            continue
        if low.startswith("intrinsic"):
            nums["extrinsic"] = rows
            section = "intrinsic"
            rows = []
            continue
        vals = [float(v) for v in re.split(r"[\s,]+", s) if v]
        if not vals:
            continue
        if section == "intrinsic" and len(rows) == 3:
            depth_line = vals
            continue
        rows.append(vals)
    nums.setdefault("intrinsic", rows)
    if "extrinsic" not in nums:
        raise ValueError("cam file missing extrinsic block")
    w2c = np.asarray(nums["extrinsic"], np.float64).reshape(4, 4)
    K = np.asarray(nums["intrinsic"][:3], np.float64).reshape(3, 3)
    if len(depth_line) >= 4:
        near, far = depth_line[0], depth_line[3]
    elif len(depth_line) >= 2:
        near = depth_line[0]
        far = depth_line[0] + depth_line[1] * 192.0   # MVSNet default planes
    else:
        near, far = 425.0, 905.0                      # DTU defaults
    return w2c.astype(np.float32), K.astype(np.float32), float(near), float(far)


def parse_pair_txt(text: str):
    """``pair.txt`` → {ref_view_id: [src ids by score]}."""
    toks = text.split()
    n = int(toks[0])
    i = 1
    pairs = {}
    for _ in range(n):
        ref = int(toks[i]); i += 1
        m = int(toks[i]); i += 1
        srcs = [int(toks[i + 2 * j]) for j in range(m)]
        i += 2 * m
        pairs[ref] = srcs
    return pairs


def load_dtu_scan(root: str, scan: str, *, num_src: int = 2,
                  light_idx: int = 3, max_dim: int = 640,
                  views: Optional[Sequence[int]] = None) -> List[MVSGroup]:
    """Load one DTU scan in the MVSNeRF layout into MVS groups.

    ``root/Cameras/pair.txt``, ``root/Cameras/train/%08d_cam.txt`` (or
    ``root/Cameras/%08d_cam.txt``), images at
    ``root/Rectified/{scan}_train/rect_{v+1:03d}_{light_idx}_r5000.png``
    (or ``root/Rectified/{scan}/...``). Each pair entry becomes one group:
    ref = the entry's view, srcs = its top-``num_src`` partners, target =
    the next-best partner (held out of the cost volume)."""
    from PIL import Image

    cam_dir = os.path.join(root, "Cameras")
    pair_path = os.path.join(cam_dir, "pair.txt")
    with open(pair_path) as f:
        pairs = parse_pair_txt(f.read())

    def cam_path(v):
        for p in (os.path.join(cam_dir, "train", f"{v:08d}_cam.txt"),
                  os.path.join(cam_dir, f"{v:08d}_cam.txt")):
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no cam file for view {v} under {cam_dir}")

    def img_path(v):
        for d in (f"{scan}_train", scan):
            p = os.path.join(root, "Rectified", d,
                             f"rect_{v + 1:03d}_{light_idx}_r5000.png")
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no image for view {v} ({scan})")

    def load_view(v) -> MVSView:
        w2c, K, near, far = parse_cam_txt(open(cam_path(v)).read())
        img = Image.open(img_path(v)).convert("RGB")
        # the MVSNet cam files are written at 1/4 of the rectified 1600x1200
        # images; rescale K to the actual image, then downsize to max_dim
        sx = img.width / 1600.0 * 4.0
        K = K.copy()
        K[0] *= sx
        K[1] *= sx
        if max(img.width, img.height) > max_dim:
            s = max_dim / max(img.width, img.height)
            img = img.resize((int(img.width * s), int(img.height * s)),
                             Image.LANCZOS)
            K[0] *= s
            K[1] *= s
        arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
        return MVSView(image=arr, K=K.astype(np.float32),
                       w2c=w2c, near=near, far=far)

    groups = []
    for ref_id, srcs in sorted(pairs.items()):
        if views is not None and ref_id not in views:
            continue
        if len(srcs) < num_src + 1:
            continue
        groups.append(MVSGroup(ref=load_view(ref_id),
                               srcs=[load_view(v) for v in srcs[:num_src]],
                               target=load_view(srcs[num_src])))
    return groups


# ---------------------------------------------------------------------------
# Synthetic fixture
# ---------------------------------------------------------------------------

def make_synthetic_groups(n_groups: int = 6, width: int = 64,
                          height: int = 48, n_gauss: int = 300,
                          num_src: int = 2, seed: int = 0,
                          backend: str = "auto",
                          device="cuda") -> List[MVSGroup]:
    """Random-Gaussian scene rendered from an arc of cameras on ``device``.

    Views per group are consecutive cameras on the arc (ref, srcs around it,
    target between them) so the cost volume has real parallax. Rendering
    goes through the port's preprocess + rasterize with the JAX module's
    raster configuration; ``backend`` "auto" is the stream backend."""
    import torch

    from ..ops.preprocess import CameraView, preprocess
    from ..ops.rasterize import RasterConfig, rasterize
    from ..utils.transforms import normalize as _norm

    device = torch.device(device)
    rng = np.random.RandomState(seed)
    # a colorful blob cloud around the origin
    means = rng.uniform(-1.0, 1.0, (n_gauss, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.03), np.log(0.12),
                                (n_gauss, 3))).astype(np.float32)
    quats = rng.randn(n_gauss, 4).astype(np.float32)
    opac = rng.uniform(0.4, 0.95, n_gauss).astype(np.float32)
    colors = rng.rand(n_gauss, 3).astype(np.float32)

    fovx = math.radians(55.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    fx = graphics.fov2focal(fovx, width)
    fy = graphics.fov2focal(fovy, height)
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]],
                 np.float32)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    cfg = RasterConfig(tile_capacity=256, max_tiles_per_gaussian=16,
                       tile_batch=16, backend=backend)

    def dev(a):
        return torch.as_tensor(a, device=device)

    t_means, t_scales, t_opac, t_colors = (dev(a) for a in
                                           (means, scales, opac, colors))
    t_rot = _norm(dev(quats))
    zeros = torch.zeros(3, device=device)

    def look_at_w2c(eye):
        fwd = -eye / np.linalg.norm(eye)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])   # rows = cam axes
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ eye
        return w2c.astype(np.float32)

    @torch.no_grad()
    def render_view(viewmat, projmat, campos):
        cam = CameraView(dev(viewmat), dev(projmat), dev(campos),
                         dev(np.float32(math.tan(fovx / 2))),
                         dev(np.float32(math.tan(fovy / 2))))
        p = preprocess(t_means, t_opac, cam, width, height, scales=t_scales,
                       rotations=t_rot, colors_precomp=t_colors,
                       tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        img, _ = rasterize(p, width, height, zeros, cfg)
        # alpha-composited expected depth (per-Gaussian camera-space z as
        # the "color"), normalized by the rendered opacity so fully-covered
        # pixels read true depth
        vm = cam.viewmatrix
        z_cam = (t_means * vm[2, :3]).sum(-1) + vm[2, 3]
        pz = p._replace(rgb=z_cam[:, None].expand(z_cam.shape[0], 3))
        dimg, daux = rasterize(pz, width, height, zeros, cfg)
        alpha = 1.0 - daux["final_T"]
        depth = torch.where(alpha > 0.3,
                            dimg[0] / torch.clamp_min(alpha, 1e-6), 0.0)
        return (img.clamp(0.0, 1.0).cpu().numpy(),
                depth.cpu().numpy())

    def view_at(angle) -> MVSView:
        r = 3.2 + 0.15 * math.sin(3 * angle)
        eye = np.array([r * math.sin(angle), 0.5 * math.cos(2 * angle),
                        -r * math.cos(angle)])
        w2c = look_at_w2c(eye)
        img, depth = render_view(w2c, (P @ w2c).astype(np.float32),
                                 np.linalg.inv(w2c)[:3, 3].astype(np.float32))
        return MVSView(image=img.astype(np.float32), K=K.copy(),
                       w2c=w2c, near=1.5, far=6.0,
                       depth=depth.astype(np.float32))

    groups = []
    spread = 0.12
    for g in range(n_groups):
        base = 2 * math.pi * g / n_groups
        ref = view_at(base)
        srcs = [view_at(base + spread * (i + 1) * (-1 if i % 2 else 1))
                for i in range(num_src)]
        target = view_at(base + spread / 2)
        groups.append(MVSGroup(ref=ref, srcs=srcs, target=target))
    return groups


def make_synthetic_scenes(n_scenes: int = 4, groups_per_scene: int = 2,
                          width: int = 64, height: int = 48,
                          n_gauss: int = 300, num_src: int = 2,
                          seed: int = 0, backend: str = "auto",
                          device="cuda") -> List[List[MVSGroup]]:
    """Independent synthetic scenes (distinct Gaussian clouds), each with its
    own camera-arc groups — the held-out-SCENE generalization fixture: train
    on scenes[1:], evaluate on the never-seen scenes[0]."""
    return [make_synthetic_groups(n_groups=groups_per_scene, width=width,
                                  height=height, n_gauss=n_gauss,
                                  num_src=num_src, seed=seed + 1000 * i,
                                  backend=backend, device=device)
            for i in range(n_scenes)]
