"""Training driver for the generalizable MVS→Gaussian branch.

Port of the JAX package's ``mvs/train.py``. Optimizes the
:class:`MVSGaussianModel` network weights (not a per-scene point cloud):
each step picks a (ref, srcs, target) group, predicts a pixel-aligned
Gaussian cloud in the reference camera frame, transforms it to world,
renders the held-out target through the port's preprocess + rasterize, and
backpropagates the photometric L1 + D-SSIM loss into the CNNs — the DTU
3-view generalizable setting of BASELINE config #4.

On a card the render takes the stream backend in exact mode, as the JAX
loop does on its accelerator: B1 forward and B2 backward, through the
wrappers. On the CPU it takes the ``"jnp"`` tile compositor, as the JAX
loop does off the accelerator. ``optax.adam(optax.exponential_decay(lr,
iterations, f))`` is ``torch.optim.Adam`` (eps 1e-8) with the learning rate
set before update k (from 0) to lr · f^(k / iterations). The checkpoint is
the port's own ``torch.save`` file.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.preprocess import CameraView, preprocess
from ..ops.rasterize import RasterConfig, rasterize
from ..utils import graphics
from ..utils.losses import l1_loss, psnr, ssim
from ..utils.transforms import normalize, quat_multiply, rotmat_to_quat
from .dataset import MVSGroup
from .model import MVSGaussianModel


@dataclass
class MVSConfig:
    iterations: int = 2000
    lr: float = 5e-4
    lr_final_factor: float = 0.1
    num_depths: int = 32
    lambda_dssim: float = 0.2
    # optional depth supervision: L1 between the cost-volume expected depth
    # and the reference view's GT depth map (synthetic fixtures render one;
    # MVSView.depth None disables per group). Normalized by (far - near).
    lambda_depth: float = 0.0
    eval_every: int = 500
    model_path: str = ""
    num_src: int = 2
    seed: int = 0
    backend: str = "auto"
    feat_dims: tuple = (16, 32, 32)


class MVSBatch(NamedTuple):
    """One group as device tensors."""

    ref_image: torch.Tensor       # [3, H, W]
    src_images: torch.Tensor      # [V, 3, H, W]
    k_ref_feat: torch.Tensor      # [3, 3] intrinsics at feature (H/4) scale
    k_src_feats: torch.Tensor     # [V, 3, 3]
    rel_rs: torch.Tensor          # [V, 3, 3] ref-cam → src-cam
    rel_ts: torch.Tensor          # [V, 3]
    near: torch.Tensor            # [] float32
    far: torch.Tensor             # []
    w2c_ref: torch.Tensor         # [4, 4]
    target_cam: CameraView
    target_image: torch.Tensor    # [3, H, W]
    ref_depth: torch.Tensor       # [H, W] GT depth (0 where unknown)
    has_depth: torch.Tensor       # [] 1.0 when ref_depth is real


def _feat_k(K: np.ndarray, scale: float = 0.25) -> np.ndarray:
    k = K.copy().astype(np.float32)
    k[0] *= scale
    k[1] *= scale
    return k


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _camera_view(view, device="cuda") -> CameraView:
    fovx = 2.0 * math.atan(view.width / (2.0 * view.K[0, 0]))
    fovy = 2.0 * math.atan(view.height / (2.0 * view.K[1, 1]))
    P = graphics.projection_matrix(0.05 * view.near, 10.0 * view.far,
                                   fovx, fovy)
    w2c = view.w2c.astype(np.float32)
    return CameraView(_f32(w2c, device), _f32(P @ w2c, device),
                      _f32(np.linalg.inv(w2c)[:3, 3], device),
                      _f32(math.tan(fovx / 2), device),
                      _f32(math.tan(fovy / 2), device))


def group_to_batch(g: MVSGroup, device="cuda") -> MVSBatch:
    ref = g.ref
    R_r = ref.w2c[:3, :3]
    t_r = ref.w2c[:3, 3]
    rel_rs, rel_ts, k_srcs = [], [], []
    for s in g.srcs:
        R_s = s.w2c[:3, :3]
        t_s = s.w2c[:3, 3]
        R_rel = R_s @ R_r.T
        rel_rs.append(R_rel)
        rel_ts.append(t_s - R_rel @ t_r)
        k_srcs.append(_feat_k(s.K))
    depth = (ref.depth if ref.depth is not None
             else np.zeros(ref.image.shape[1:], np.float32))
    return MVSBatch(
        ref_image=_f32(ref.image, device),
        src_images=_f32(np.stack([s.image for s in g.srcs]), device),
        k_ref_feat=_f32(_feat_k(ref.K), device),
        k_src_feats=_f32(np.stack(k_srcs), device),
        rel_rs=_f32(np.stack(rel_rs), device),
        rel_ts=_f32(np.stack(rel_ts), device),
        near=_f32(ref.near, device),
        far=_f32(ref.far, device),
        w2c_ref=_f32(ref.w2c, device),
        target_cam=_camera_view(g.target, device),
        target_image=_f32(g.target.image, device),
        ref_depth=_f32(depth, device),
        has_depth=_f32(0.0 if ref.depth is None else 1.0, device),
    )


def gaussians_to_world(out: dict, w2c_ref: torch.Tensor):
    """Predicted ref-camera-frame Gaussians → world frame.

    X_w = Rᵀ(X_c − t); rotations compose with the cam→world quaternion."""
    R = w2c_ref[:3, :3]
    t = w2c_ref[:3, 3]
    xyz_w = (out["xyz_cam"] - t) @ R        # rows: Rᵀ @ x
    q_c2w = rotmat_to_quat(R.T)
    rot_w = quat_multiply(q_c2w[None, :], normalize(out["rotation"]))
    return xyz_w, rot_w


def render_predicted(out: dict, batch: MVSBatch, width: int, height: int,
                     raster_cfg: RasterConfig):
    xyz_w, rot_w = gaussians_to_world(out, batch.w2c_ref)
    p = preprocess(xyz_w, torch.sigmoid(out["opacity_logit"][:, 0]),
                   batch.target_cam, width, height,
                   scales=torch.exp(out["log_scaling"]),
                   rotations=rot_w,
                   colors_precomp=out["colors"],
                   tile_w=raster_cfg.tile_w, tile_h=raster_cfg.tile_h)
    zeros = torch.zeros(3, device=xyz_w.device)
    return rasterize(p, width, height, zeros, raster_cfg)


def _resize(img: torch.Tensor, shape) -> torch.Tensor:
    """[H, W] → ``shape``: ``jax.image.resize(..., "bilinear")``, which
    antialiases when it shrinks."""
    return F.interpolate(img[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def apply_model(model: MVSGaussianModel, batch: MVSBatch) -> dict:
    return model(batch.ref_image, batch.src_images, batch.k_ref_feat,
                 batch.k_src_feats, batch.rel_rs, batch.rel_ts, batch.near,
                 batch.far)


def mvs_loss(model: MVSGaussianModel, batch: MVSBatch, cfg: MVSConfig,
             raster_cfg: RasterConfig, width: int, height: int):
    """(loss, l1) of one group: L1 + D-SSIM of the rendered target, plus
    ``lambda_depth`` times the masked, scale-normalized depth error."""
    out = apply_model(model, batch)
    img, _ = render_predicted(out, batch, width, height, raster_cfg)
    l1 = l1_loss(img, batch.target_image)
    loss = ((1.0 - cfg.lambda_dssim) * l1
            + cfg.lambda_dssim * (1.0 - ssim(img, batch.target_image)))
    if cfg.lambda_depth > 0:
        # the GT map encodes holes as 0: a resize of the raw map would blend
        # those zeros into valid pixels across hole boundaries, so the
        # coverage mask is resized apart and only pixels fully inside it
        # (resized mask ≈ 1) are supervised
        pred = out["depth"]                                 # [h, w]
        gt = _resize(batch.ref_depth, pred.shape)
        cov = _resize((batch.ref_depth > 0).to(torch.float32), pred.shape)
        m = (cov >= 0.999).to(torch.float32) * batch.has_depth
        derr = ((pred - gt).abs() * m).sum() / torch.clamp_min(
            m.sum(), 1.0) / (batch.far - batch.near)
        loss = loss + cfg.lambda_depth * derr
    return loss, l1


def lr_at(cfg: MVSConfig, k: int) -> float:
    """``optax.exponential_decay(lr, iterations, lr_final_factor)`` at its
    count k (0 for the first update)."""
    return cfg.lr * cfg.lr_final_factor ** (k / cfg.iterations)


def make_mvs_train_step(model: MVSGaussianModel, cfg: MVSConfig,
                        raster_cfg: RasterConfig, width: int, height: int,
                        optimizer: torch.optim.Optimizer):
    """(train_step(batch, k) → (loss, l1), eval_step(batch) → (psnr, image)).

    train_step sets the learning rate of update k, takes the gradient into
    the parameters' ``.grad`` (set anew each step) and steps ``optimizer``."""

    def train_step(batch: MVSBatch, k: int):
        for group in optimizer.param_groups:
            group["lr"] = lr_at(cfg, k)
        optimizer.zero_grad(set_to_none=True)
        loss, l1 = mvs_loss(model, batch, cfg, raster_cfg, width, height)
        loss.backward()
        optimizer.step()
        return loss.detach(), l1.detach()

    @torch.no_grad()
    def eval_step(batch: MVSBatch):
        out = apply_model(model, batch)
        img, _ = render_predicted(out, batch, width, height, raster_cfg)
        img = img.clamp(0.0, 1.0)
        return psnr(img, batch.target_image.clamp(0.0, 1.0))[0], img

    return train_step, eval_step


def raster_config(device, backend: str = "auto") -> RasterConfig:
    """The JAX loop's raster configuration: exact mode, the stream backend
    on a card ("auto"), the ``"jnp"`` compositor elsewhere."""
    if backend == "auto":
        backend = "stream" if torch.device(device).type == "cuda" else "jnp"
    return RasterConfig(tile_capacity=512, max_tiles_per_gaussian=16,
                        tile_batch=32, backend=backend)


def train_mvs(cfg: MVSConfig, groups: List[MVSGroup],
              eval_groups: Optional[List[MVSGroup]] = None,
              log_fn: Callable[[str], None] = print, device="cuda"):
    """Train the generalizable model on a list of MVS groups on ``device``.

    Returns (model, history): history["loss"] holds (iteration, loss) every
    10 iterations, history["time"] the seconds since the first step at the
    same iterations, history["psnr_eval"] the eval PSNR by iteration."""
    if not groups:
        raise ValueError("no training groups")
    device = torch.device(device)
    height, width = groups[0].target.image.shape[1:]
    raster_cfg = raster_config(device, cfg.backend)

    model = MVSGaussianModel(num_depths=cfg.num_depths,
                             feat_dims=cfg.feat_dims, seed=cfg.seed).to(device)
    batches = [group_to_batch(g, device) for g in groups]
    eval_batches = [group_to_batch(g, device) for g in (eval_groups or [])]
    n_params = sum(p.numel() for p in model.parameters())
    log_fn(f"MVS model: {n_params / 1e3:.1f}K parameters, "
           f"{len(batches)} train groups, {width}x{height}, "
           f"backend={raster_cfg.backend}")

    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-8)
    train_step, eval_step = make_mvs_train_step(model, cfg, raster_cfg,
                                                width, height, optimizer)

    rng = np.random.RandomState(cfg.seed)
    history = {"loss": [], "time": [], "psnr_eval": {}}
    ema = None
    t0 = time.perf_counter()
    for it in range(1, cfg.iterations + 1):
        batch = batches[rng.randint(len(batches))]
        loss, _ = train_step(batch, it - 1)
        if it % 10 == 0 or it == cfg.iterations:
            lv = float(loss)
            ema = lv if ema is None else 0.4 * lv + 0.6 * ema
            history["loss"].append((it, lv))
            history["time"].append((it, time.perf_counter() - t0))
        if it % max(1, cfg.eval_every) == 0 or it == cfg.iterations:
            evb = eval_batches or batches[:4]
            ps = float(np.mean([float(eval_step(b)[0]) for b in evb]))
            history["psnr_eval"][it] = ps
            dt = time.perf_counter() - t0
            log_fn(f"[ITER {it}] loss {ema:.5f} eval PSNR {ps:.2f} "
                   f"({it / dt:.1f} it/s)")
    if cfg.model_path:
        path = os.path.join(cfg.model_path, "mvs_model.pt")
        save_mvs_checkpoint(path, model, cfg)
        log_fn(f"saved {path}")
    return model, history


def save_mvs_checkpoint(path: str, model: MVSGaussianModel,
                        cfg: MVSConfig) -> None:
    """The model's weights (``torch.save`` of its state_dict) at ``path``
    and its shape at ``path``.json."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    meta = {"num_depths": cfg.num_depths, "feat_dims": list(cfg.feat_dims),
            "num_src": cfg.num_src}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_mvs_checkpoint(path: str, device="cuda") -> MVSGaussianModel:
    """The model saved by :func:`save_mvs_checkpoint`, on ``device``."""
    with open(path + ".json") as f:
        meta = json.load(f)
    model = MVSGaussianModel(num_depths=meta["num_depths"],
                             feat_dims=tuple(meta["feat_dims"]))
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    return model.to(device)
