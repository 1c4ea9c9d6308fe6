"""A 360° capture shaped like Mip-NeRF 360's bicycle: cameras on a ring
looking inward at a dense central object, over a ground disc, inside a
sparse background shell. The Gaussians' screen sizes are log-normal, as
``tools/bench.py`` draws them, sized against their distance to the camera
ring; opacities and SH coefficients are drawn as there. Every tensor is
made on the device from one ``torch.Generator`` in a few large calls."""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench.scene import fovs


def train_cameras(cfg: dict, rng):
    """The capture's camera centres, ``n_cameras`` around the ring, each
    jittered, and the points they look at."""
    s = cfg["scene"]
    k = cfg["n_cameras"]
    ang = 2 * np.pi * (np.arange(k) + rng.uniform(-0.3, 0.3, k)) / k
    rad = s["ring_radius"] * (1 + rng.uniform(-0.05, 0.05, k))
    z = s["ring_height"] + rng.uniform(-0.2, 0.2, k)
    centres = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], -1)
    look = rng.normal(0.0, s["look_jitter"], (k, 3))
    return centres, look


def orbit(cfg: dict, poses: int) -> list:
    """``poses`` (centre, target) pairs evenly along the ring, looking at
    the centre (a video or viewer orbit)."""
    s = cfg["scene"]
    ang = 2 * np.pi * np.arange(poses) / poses
    return [([s["ring_radius"] * math.cos(a), s["ring_radius"] * math.sin(a),
              s["ring_height"]], (0.0, 0.0, 0.0)) for a in ang]


def cloud(cfg: dict, gen: torch.Generator, device):
    """Raw leaves of the configuration's N Gaussians."""
    s = cfg["scene"]
    n = cfg["n_gaussians"]
    n_obj = int(n * s["object_share"])
    n_ground = int(n * s["ground_share"])
    u = torch.rand((n, 4), generator=gen, device=device)
    g = torch.randn((n, 3), generator=gen, device=device)
    obj = g[:n_obj] * s["object_sigma"]
    r = s["ground_radius"] * torch.sqrt(u[n_obj:n_obj + n_ground, 0])
    a = 2 * math.pi * u[n_obj:n_obj + n_ground, 1]
    ground = torch.stack([r * torch.cos(a), r * torch.sin(a),
                          s["ground_height"]
                          + 0.05 * g[n_obj:n_obj + n_ground, 2]], -1)
    us = u[n_obj + n_ground:]
    rad = s["shell_inner"] + (s["shell_outer"] - s["shell_inner"]) * us[:, 0]
    az = 2 * math.pi * us[:, 1]
    el = s["shell_elev_min"] + (s["shell_elev_max"]
                                - s["shell_elev_min"]) * us[:, 2]
    shell = torch.stack([rad * torch.cos(el) * torch.cos(az),
                         rad * torch.cos(el) * torch.sin(az),
                         rad * torch.sin(el)], -1)
    xyz = torch.cat([obj, ground, shell])
    # distance to the camera ring: the nearest view's depth
    rxy = torch.linalg.vector_norm(xyz[:, :2], dim=-1)
    d_ring = torch.sqrt((rxy - s["ring_radius"]) ** 2
                        + (xyz[:, 2] - s["ring_height"]) ** 2)
    d_ring = torch.clamp(d_ring, min=s["min_depth"])
    _, _, focal = fovs(cfg)
    jitter = 0.6 + 0.8 * torch.rand((n, 3), generator=gen, device=device)
    # screen sizes drawn apart from the positions, the tail cut so that no
    # Gaussian outgrows the top tier's tile budget
    z = torch.randn(n, generator=gen, device=device)
    px = torch.exp(math.log(s["px_median"])
                   + s["px_sigma"] * torch.clamp(z, max=s["px_max_z"]))
    world = px * d_ring / focal
    scaling = torch.log(world[:, None] * jitter)
    rotation = torch.randn((n, 4), generator=gen, device=device)
    lo, hi = s["opacity_range"]
    op = lo + (hi - lo) * u[:, 3]
    opacity = torch.log(op / (1 - op))[:, None]
    shs = torch.randn((n, 16, 3), generator=gen, device=device) * s["sh_std"]
    return {"xyz": xyz, "f_dc": shs[:, :1].contiguous(),
            "f_rest": shs[:, 1:].contiguous(), "scaling": scaling,
            "rotation": rotation, "opacity": opacity}
