"""Naive per-pixel reference rasterizer (the conformance oracle).

Port of the JAX package's ``ops/raster_ref.py``: global front-to-back order
by camera depth (stable sort); power = −½(a·dx² + c·dy²) − b·dx·dy, skip if
power > 0; alpha = min(0.99, opacity·exp(power)), skip if alpha < 1/255;
terminate (excluding the current Gaussian) when T·(1−alpha) < 1e-4;
out = Σ c·α·T + T_final·bg. A Gaussian only touches pixels whose tile lies
inside its tile rect, as in the tiled path.

O(N·H·W) memory and compute: small scenes and tests only.
"""

from __future__ import annotations

import torch

from .preprocess import Processed


def composite_order(processed: Processed) -> torch.Tensor:
    """Depth-ascending order over visible Gaussians (invisible sort last)."""
    key = torch.where(processed.mask, processed.depth, torch.inf)
    return torch.sort(key, stable=True).indices


def rasterize_reference(processed: Processed, image_width: int,
                        image_height: int, bg_color: torch.Tensor,
                        return_aux: bool = False, tile_w: int = 16,
                        tile_h: int = 16):
    """Composite all Gaussians against every pixel → [3, H, W] image; with
    ``return_aux`` also dict(final_T [H, W], contrib [H, W])."""
    order = composite_order(processed)
    xy = processed.xy[order]
    conic = processed.conic[order]
    rgb = processed.rgb[order]
    opacity = processed.opacity[order]
    valid = processed.mask[order]
    rect_min = processed.rect_min[order]
    rect_max = processed.rect_max[order]
    dev = xy.device

    px = torch.arange(image_width, dtype=torch.float32, device=dev)
    py = torch.arange(image_height, dtype=torch.float32, device=dev)
    dx = xy[:, 0, None, None] - px[None, None, :]   # [N, 1, W]
    dy = xy[:, 1, None, None] - py[None, :, None]   # [N, H, 1]
    power = (-0.5 * (conic[:, 0, None, None] * dx * dx
                     + conic[:, 2, None, None] * dy * dy)
             - conic[:, 1, None, None] * dx * dy)   # [N, H, W]

    tile_x = torch.arange(image_width, device=dev) // tile_w
    tile_y = torch.arange(image_height, device=dev) // tile_h
    in_rect = ((tile_x[None, None, :] >= rect_min[:, 0, None, None])
               & (tile_x[None, None, :] < rect_max[:, 0, None, None])
               & (tile_y[None, :, None] >= rect_min[:, 1, None, None])
               & (tile_y[None, :, None] < rect_max[:, 1, None, None]))

    alpha = torch.clamp(opacity[:, None, None] * torch.exp(power), max=0.99)
    contributes = (valid[:, None, None] & in_rect & (power <= 0.0)
                   & (alpha >= 1.0 / 255.0))
    alpha = torch.where(contributes, alpha, 0.0)

    # Exclusive transmittance before each Gaussian, then the termination
    # rule: a Gaussian that would push T below 1e-4 is dropped and ends the
    # pixel.
    one_minus = 1.0 - alpha
    T_excl = torch.cumprod(torch.cat([torch.ones_like(one_minus[:1]),
                                      one_minus[:-1]]), dim=0)
    fail = contributes & (T_excl * one_minus < 1e-4)
    failed = fail.to(torch.int32)
    done_before = torch.cumsum(failed, dim=0) - failed
    include = contributes & (done_before == 0) & ~fail

    w = torch.where(include, alpha * T_excl, 0.0)             # [N, H, W]
    image = (w[:, None] * rgb[:, :, None, None]).sum(0)        # [3, H, W]
    final_T = torch.prod(torch.where(include, one_minus, 1.0), dim=0)
    image = image + final_T[None] * bg_color[:, None, None]
    if return_aux:
        return image, {"final_T": final_T, "contrib": include.sum(0)}
    return image
