"""Plane-sweep homography warping and cost-volume construction.

Port of the JAX package's ``mvs/homography.py``: the MVS front end of the
generalizable-splatting branch. Source-view features are warped into the
reference frustum at D fronto-parallel depth planes by differentiable
bilinear sampling, and the variance across the views at each depth forms
the cost volume (MVSNeRF-style). Shapes are [V, C, H, W] features and [D]
depths.

The sampler is ``F.grid_sample`` (bilinear, zero padding, corners not
aligned): a pixel centre sits at an integer coordinate, as in the JAX
sampler, and a tap outside the image reads zero there too. The JAX branch
has no Pallas kernel here; these are library calls on either side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img [C, H, W]; x, y [...]: pixel coords → samples [C, ...] (zeros
    outside)."""
    return bilinear_sample_batch(img[None], x[None], y[None])[0]


def bilinear_sample_batch(imgs: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor):
    """imgs [B, C, H, W]; x, y [B, ...] → samples [B, C, ...]."""
    b, c, h, w = imgs.shape
    shape = x.shape[1:]
    grid = torch.stack([(2.0 * x + 1.0) / w - 1.0,
                        (2.0 * y + 1.0) / h - 1.0], -1).reshape(b, 1, -1, 2)
    out = F.grid_sample(imgs, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)                # [B, C, 1, M]
    return out.reshape(b, c, *shape)


def _ref_rays(k_ref_inv: torch.Tensor, height: int, width: int):
    """[3, H, W] reference-camera ray directions through the pixel centres."""
    dev = k_ref_inv.device
    us = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    vs = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    vv, uu = torch.meshgrid(vs, us, indexing="ij")          # [H, W]
    rays = torch.stack([uu, vv, torch.ones_like(uu)], 0)    # [3, H, W]
    return torch.einsum("ij,jhw->ihw", k_ref_inv, rays)


def plane_sweep_warp_batch(src_feats: torch.Tensor, k_ref_inv: torch.Tensor,
                           k_srcs: torch.Tensor, rel_rs: torch.Tensor,
                           rel_ts: torch.Tensor, depths: torch.Tensor,
                           height: int, width: int) -> torch.Tensor:
    """Every source view warped into the reference frustum: src_feats
    [V, C, Hs, Ws]; per-source K_src [V, 3, 3] and ref-cam → src-cam
    (rel_R [V, 3, 3], rel_t [V, 3]); depths [D] → [V, D, C, H, W]."""
    rays = _ref_rays(k_ref_inv, height, width)
    pts = rays[None] * depths[:, None, None, None]          # [D, 3, H, W]
    p_src = (torch.einsum("vij,djhw->vdihw", rel_rs, pts)
             + rel_ts[:, None, :, None, None])              # [V, D, 3, H, W]
    p_pix = torch.einsum("vij,vdjhw->vdihw", k_srcs, p_src)
    z = torch.clamp_min(p_pix[:, :, 2], 1e-6)
    x = p_pix[:, :, 0] / z - 0.5
    y = p_pix[:, :, 1] / z - 0.5
    behind = p_src[:, :, 2] <= 1e-6                         # [V, D, H, W]
    samp = bilinear_sample_batch(src_feats, x, y)           # [V, C, D, H, W]
    samp = samp.transpose(1, 2)                             # [V, D, C, H, W]
    return torch.where(behind[:, :, None], 0.0, samp)


def plane_sweep_warp(src_feat: torch.Tensor, k_ref_inv: torch.Tensor,
                     k_src: torch.Tensor, rel_r: torch.Tensor,
                     rel_t: torch.Tensor, depths: torch.Tensor,
                     height: int, width: int) -> torch.Tensor:
    """Warp one source feature map into the reference frustum.

    src_feat [C, Hs, Ws]; K_ref_inv [3,3]; K_src [3,3]; rel_R/rel_t: ref-cam →
    src-cam rigid transform; depths [D] → warped [D, C, H, W]."""
    return plane_sweep_warp_batch(src_feat[None], k_ref_inv, k_src[None],
                                  rel_r[None], rel_t[None], depths, height,
                                  width)[0]


def build_cost_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                      k_ref_inv, k_srcs, rel_rs, rel_ts, depths,
                      height: int, width: int) -> torch.Tensor:
    """Variance cost volume over {reference, warped sources}.

    ref_feat [C, H, W]; src_feats [V, C, Hs, Ws]; per-source intrinsics /
    relative poses stacked on axis 0 → volume [D, C, H, W] (variance across
    the V+1 views at each depth)."""
    warped = plane_sweep_warp_batch(src_feats, k_ref_inv, k_srcs, rel_rs,
                                    rel_ts, depths, height, width)
    d = depths.shape[0]
    ref = ref_feat[None].expand((d,) + tuple(ref_feat.shape))
    all_views = torch.cat([ref[None], warped], 0)           # [V+1, D, C, H, W]
    mean = all_views.mean(0)
    return ((all_views - mean) ** 2).mean(0)                # [D, C, H, W]
