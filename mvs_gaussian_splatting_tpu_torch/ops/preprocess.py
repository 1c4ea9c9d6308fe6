"""Per-Gaussian preprocessing: projection, EWA 2D covariance, radii, SH colour.

Port of the JAX package's ``ops/preprocess.py``; the semantics are the CUDA
rasterizer's forward, term for term:

- frustum cull at camera-space z <= 0.2
- perspective divide with +1e-7 on w
- Σ2D = J W Σ3D Wᵀ Jᵀ (+0.3·I low-pass), J at the view ray clamped to
  |x/z| <= 1.3·tan_fovx (and y likewise)
- conic = inverse covariance (a, b, c): power = −½(a·dx² + c·dy²) − b·dx·dy
- radius = ceil(3·sqrt(max eigenvalue)), the sqrt argument floored at 0.1
- pixel convention: ndc2pix(v, S) = ((v+1)·S − 1)/2
- SH→RGB with +0.5 offset clamped at 0
- tight per-axis tile rects from the alpha ≥ 1/255 level set, intersected
  with the 3σ square; radius 0 when the rect is empty

Everything is float32 element-wise arithmetic (broadcast-multiply-sums, no
matrix product), so no TF32 path is ever taken.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.sh import sh_to_rgb_clamped
from ..utils.transforms import (covariance_from_scaling_rotation,
                                unstrip_symmetric)


class CameraView(NamedTuple):
    """Camera for rendering (column-vector convention), all float32 tensors.

    viewmatrix: [4, 4] world→camera. projmatrix: [4, 4] = P @ W2V (clip from
    world). campos: [3] camera centre in world. tanfovx/tanfovy: 0-d."""

    viewmatrix: torch.Tensor
    projmatrix: torch.Tensor
    campos: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor


class Processed(NamedTuple):
    xy: torch.Tensor        # [N, 2] pixel-space means
    depth: torch.Tensor     # [N] camera-space z
    conic: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c)
    rgb: torch.Tensor       # [N, 3]
    opacity: torch.Tensor   # [N]
    radius: torch.Tensor    # [N] int32, 0 = culled
    rect_min: torch.Tensor  # [N, 2] int32 tile coords (x, y), inclusive
    rect_max: torch.Tensor  # [N, 2] int32 tile coords, exclusive
    mask: torch.Tensor      # [N] bool, visible
    cull_r2: torch.Tensor   # [N] squared max radius of the alpha >= 1/255
                            # level set plus a 1 px margin; tiles farther
                            # away contribute nothing and are culled


def _tile_rect(xy, ext_x, ext_y, tiles_x: int, tiles_y: int,
               tile_w: int, tile_h: int):
    """Tile-footprint rectangle of a splat, CUDA getRect semantics with
    per-axis extents instead of a single circular radius."""
    def edge(v, size, hi):
        return torch.clamp(torch.floor(v / size), 0, hi).to(torch.int32)

    min_x = edge(xy[:, 0] - ext_x, tile_w, tiles_x)
    min_y = edge(xy[:, 1] - ext_y, tile_h, tiles_y)
    max_x = edge(xy[:, 0] + ext_x + tile_w - 1, tile_w, tiles_x)
    max_y = edge(xy[:, 1] + ext_y + tile_h - 1, tile_h, tiles_y)
    return torch.stack([min_x, min_y], -1), torch.stack([max_x, max_y], -1)


def preprocess(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    camera: CameraView,
    image_width: int,
    image_height: int,
    *,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    ndc_offset: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    tile_w: int = 16,
    tile_h: int = 16,
) -> Processed:
    """Project N Gaussians into screen space for one camera.

    Either (scales, rotations) or cov3d_precomp (6-vector upper triangle) must
    be given; likewise (shs, sh_degree) or colors_precomp. ``mask`` marks
    alive slots; dead slots come out with radius 0.
    """
    n = means3d.shape[0]
    opacities = opacities.reshape(n)

    R_wc = camera.viewmatrix[:3, :3]
    t_wc = camera.viewmatrix[:3, 3]
    p_view = (means3d[:, None, :] * R_wc[None, :, :]).sum(-1) + t_wc  # [N, 3]
    depth = p_view[:, 2]
    in_frustum = depth > 0.2

    # World → clip → NDC with the CUDA 1e-7 w-guard. Culled rows get the
    # divisor 1.0 instead: a splat crossing the camera plane has w ≈ -1e-7,
    # and the backward of the raw divide would be 0·inf = NaN there. For
    # visible rows w == view z ≥ 0.2, so this is exact for every output.
    p_hom = ((means3d[:, None, :] * camera.projmatrix[None, :3, :3]).sum(-1)
             + camera.projmatrix[:3, 3])
    w_hom = ((means3d * camera.projmatrix[3, :3]).sum(-1)
             + camera.projmatrix[3, 3])
    w_safe = torch.where(in_frustum, w_hom + 1e-7, 1.0)
    p_ndc = p_hom[:, :2] / w_safe[:, None]
    if ndc_offset is not None:
        p_ndc = p_ndc + ndc_offset
    xy = torch.stack([
        ((p_ndc[:, 0] + 1.0) * image_width - 1.0) * 0.5,
        ((p_ndc[:, 1] + 1.0) * image_height - 1.0) * 0.5,
    ], dim=-1)

    if cov3d_precomp is not None:
        cov3d = unstrip_symmetric(cov3d_precomp)
    else:
        cov3d = covariance_from_scaling_rotation(scales, rotations,
                                                 scale_modifier)

    # EWA projection; J at the frustum-clamped view point (CUDA computeCov2D).
    focal_x = image_width / (2.0 * camera.tanfovx)
    focal_y = image_height / (2.0 * camera.tanfovy)
    lim_x = 1.3 * camera.tanfovx
    lim_y = 1.3 * camera.tanfovy
    # z of culled rows replaced before dividing (NaN-free backward).
    z = torch.where(in_frustum, depth, 1.0)
    tx = torch.minimum(torch.maximum(p_view[:, 0] / z, -lim_x), lim_x) * z
    ty = torch.minimum(torch.maximum(p_view[:, 1] / z, -lim_y), lim_y) * z

    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([focal_x / z, zero, -focal_x * tx / (z * z)], -1),
        torch.stack([zero, focal_y / z, -focal_y * ty / (z * z)], -1),
    ], dim=-2)                                                 # [N, 2, 3]
    JW = (J[:, :, :, None] * R_wc[None, None, :, :]).sum(2)    # [N, 2, 3]
    JWC = (JW[:, :, :, None] * cov3d[:, None, :, :]).sum(2)    # [N, 2, 3]
    cov2d = (JWC[:, :, None, :] * JW[:, None, :, :]).sum(-1)   # [N, 2, 2]
    cxx = cov2d[:, 0, 0] + 0.3
    cyy = cov2d[:, 1, 1] + 0.3
    cxy = cov2d[:, 0, 1]

    det = cxx * cyy - cxy * cxy
    det_valid = det != 0.0
    det_inv = torch.where(det_valid, 1.0 / torch.where(det_valid, det, 1.0),
                          0.0)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)

    mid = 0.5 * (cxx + cyy)
    sq = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + sq
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - sq)))

    visible = in_frustum & det_valid
    if mask is not None:
        visible = visible & mask

    tiles_x = -(-image_width // tile_w)
    tiles_y = -(-image_height // tile_h)
    # Tight per-axis rect: only pixels with alpha = op·exp(power) ≥ 1/255 can
    # be touched, i.e. the level-set ellipse power ≥ −ln(255·op), whose
    # axis-aligned extents are sqrt(2·ln(255·op)·Σxx) and ·Σyy. Intersected
    # with the 3σ square rect; +0.5 px guards f32 rounding, the 1 px floor
    # keeps area ≥ 1 tile so `radii > 0` is unchanged. Rects are indices
    # only: detached.
    c0 = 2.0 * torch.log(torch.clamp(255.0 * opacities.detach(), min=1.0))
    radius_d = radius_f.detach()
    ext_x = torch.minimum(torch.clamp(torch.sqrt(c0 * cxx.detach()) + 0.5,
                                      min=1.0), radius_d)
    ext_y = torch.minimum(torch.clamp(torch.sqrt(c0 * cyy.detach()) + 0.5,
                                      min=1.0), radius_d)
    cull_r2 = (c0 * lambda1).detach()
    cull_r2 = cull_r2 + 2.0 * torch.sqrt(cull_r2) + 1.0
    rect_min, rect_max = _tile_rect(xy.detach(), ext_x, ext_y, tiles_x,
                                    tiles_y, tile_w, tile_h)
    area = (torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=0)
            * torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0))
    visible = visible & (radius_f > 0) & (area > 0)
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dirs = means3d - camera.campos
        # clamp inside the sqrt: a splat at the camera centre stays finite
        n2 = (dirs * dirs).sum(-1, keepdim=True)
        dirs = dirs / torch.sqrt(torch.clamp(n2, min=1e-16))
        rgb, _ = sh_to_rgb_clamped(sh_degree, shs, dirs)

    return Processed(xy=xy, depth=depth, conic=conic, rgb=rgb,
                     opacity=opacities, radius=radius,
                     rect_min=rect_min, rect_max=rect_max, mask=visible,
                     cull_r2=cull_r2)
