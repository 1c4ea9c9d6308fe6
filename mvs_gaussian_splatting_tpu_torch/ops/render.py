"""High-level render(): camera + Gaussian parameters + background → image.

Port of the JAX package's ``ops/render.py``, with all its flags and its
full output dict: render [3, H, W], radii [N] int32, visibility_filter [N]
bool, final_T [H, W], the overflow counters, instance_load (tile instances
this frame), n_mask_visible and tier_need_counts (0 and empty on the padded
backends).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gaussians import GaussianParams, activated, get_features
from ..utils.sh import sh_to_rgb_clamped
from ..utils.transforms import (covariance_from_scaling_rotation,
                                strip_symmetric)
from .preprocess import CameraView, preprocess
from .rasterize import RasterConfig, rasterize


def render(camera: CameraView, image_width: int, image_height: int,
           params: GaussianParams, bg_color: torch.Tensor, *,
           sh_degree: int, alive: Optional[torch.Tensor] = None,
           scale_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           ndc_offset: Optional[torch.Tensor] = None,
           compute_cov3d_python: bool = False,
           convert_shs_python: bool = False,
           raster_config: RasterConfig = RasterConfig()):
    scales, rotations, opacity = activated(params)

    kwargs = {}
    if compute_cov3d_python:
        # Σ3D built outside the rasterizer from the same activations.
        cov = covariance_from_scaling_rotation(scales, rotations,
                                               scale_modifier)
        kwargs["cov3d_precomp"] = strip_symmetric(cov)
    else:
        kwargs["scales"] = scales
        kwargs["rotations"] = rotations

    if override_color is not None:
        kwargs["colors_precomp"] = override_color
    elif convert_shs_python:
        # SH→RGB evaluated outside the rasterizer, fed as colours.
        dirs = params.xyz - camera.campos
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        rgb, _ = sh_to_rgb_clamped(sh_degree, get_features(params), dirs)
        kwargs["colors_precomp"] = rgb
    else:
        kwargs["shs"] = get_features(params)
        kwargs["sh_degree"] = sh_degree

    processed = preprocess(
        params.xyz, opacity, camera, image_width, image_height,
        scale_modifier=scale_modifier, ndc_offset=ndc_offset, mask=alive,
        tile_w=raster_config.tile_w, tile_h=raster_config.tile_h, **kwargs)

    image, aux = rasterize(processed, image_width, image_height, bg_color,
                           raster_config)
    return {
        "render": image,
        "radii": aux["radii"],
        "visibility_filter": aux["radii"] > 0,
        "final_T": aux["final_T"],
        "overflow_tiles": aux["overflow_tiles"],
        "overflow_capacity": aux["overflow_capacity"],
        # the stream backend's feedback for the loop's buckets; the padded
        # backends have none
        "overflow_visible": aux.get("overflow_visible", 0),
        "instance_load": aux["tile_counts"].sum(),
        "n_mask_visible": aux.get("n_mask_visible", 0),
        "tier_need_counts": aux.get(
            "tier_need_counts",
            torch.zeros((0,), dtype=torch.int32, device=image.device)),
    }
