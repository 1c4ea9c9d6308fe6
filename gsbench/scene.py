"""The synthetic capture of a configuration, made from the seed.

The configuration's ``capture`` names the module of its shape
(``captures/<capture>.py``): where the Gaussians and the cameras lie.
This module makes the rest the same way for every shape: the training
state at the cell's iteration (Adam's moments, the densification
statistics, the grow logits), the cameras' matrices and the targets.
Every tensor is made on the device from one ``torch.Generator`` in a few
large calls; the cameras come from a NumPy generator of the same seed.
The same seed gives the same inputs on the same kind of device.

Everything the configuration file leaves to this module is listed there
under ``assumed``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .reference.plain import View


class Capture(NamedTuple):
    params: dict              # raw leaves [N, ...]
    mu: dict                  # Adam's moments at the cell's iteration
    nu: dict
    count: int                # Adam's step count before the next step
    accum: torch.Tensor       # [N] densification statistics
    denom: torch.Tensor
    max_radii2d: torch.Tensor
    train_views: list         # [View] of the training cameras
    spatial_lr_scale: float   # the cameras' NeRF++ radius
    sphere_dirs: Optional[torch.Tensor]


def projection(znear: float, zfar: float, fovx: float, fovy: float):
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / math.tan(fovx / 2)
    P[1, 1] = 1.0 / math.tan(fovy / 2)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def look_at(centre, target, up=(0.0, 0.0, 1.0)):
    """World→camera [4, 4] of a camera at ``centre`` looking at
    ``target``: +z forward, +y down, +x right (COLMAP's convention)."""
    f = np.asarray(target, float) - centre
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    M = np.eye(4)
    M[:3, :3] = np.stack([r, d, f])
    M[:3, 3] = -M[:3, :3] @ centre
    return M


def fovs(cfg: dict):
    fovx = math.radians(cfg["fovx_deg"])
    focal = cfg["width"] / (2 * math.tan(fovx / 2))
    return fovx, 2 * math.atan(cfg["height"] / (2 * focal)), focal


def make_view(centre, target, cfg: dict, device) -> View:
    fovx, fovy, _ = fovs(cfg)
    W2V = look_at(np.asarray(centre, float), target)
    full = projection(0.01, 100.0, fovx, fovy) @ W2V

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return View(t(W2V), t(full), t(centre), t(math.tan(fovx / 2)),
                t(math.tan(fovy / 2)), cfg["width"], cfg["height"])


def capture(cfg: dict):
    """The module of the configuration's ``capture`` shape
    (``captures/<capture>.py``)."""
    from .spec import module
    return module("captures", cfg["capture"])


def orbit_views(cfg: dict, poses: int, device) -> list:
    """The capture's render path of ``poses`` views."""
    return [make_view(c, t, cfg, device)
            for c, t in capture(cfg).orbit(cfg, poses)]


def sphere_points(n: int) -> np.ndarray:
    """``n`` directions on the Fibonacci sphere (the grow codebook)."""
    theta = np.pi * (3 - np.sqrt(5)) * np.arange(n)
    z = np.linspace(1 - 1.0 / n, 1.0 / n - 1, n)
    r = np.sqrt(1 - z * z)
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], 1)


def cloud(cfg: dict, gen: torch.Generator, device):
    """Raw leaves of the configuration's N Gaussians."""
    return capture(cfg).cloud(cfg, gen, device)


def make_capture(cfg: dict, iteration: int, seed: int, device) -> Capture:
    """Everything a cell starts from: the cloud, Adam's state after
    ``iteration - 1`` steps, the densification statistics, the cameras."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = cloud(cfg, gen, device)
    n = cfg["n_gaussians"]
    grow = cfg.get("grow")
    sphere = None
    if grow:
        nd = grow["num_dirs"]
        # a clear first choice per row, so the argmax is stable under
        # a few Adam steps
        logits = grow["logit_std"] * torch.randn((n, nd), generator=gen,
                                                 device=device)
        pick = torch.randint(0, nd, (n,), generator=gen, device=device)
        logits[torch.arange(n, device=device), pick] += grow["logit_margin"]
        params["dirs_prob"] = logits
        sphere = torch.tensor(sphere_points(nd), dtype=torch.float32,
                              device=device)
    scale = cfg["adam_scale"]
    mu, nu = {}, {}
    for k, v in params.items():
        m = torch.randn(v.shape, generator=gen, device=device)
        w = torch.rand(v.shape, generator=gen, device=device)
        mu[k] = m * scale[k]
        nu[k] = (cfg["adam_noise"] * scale[k] * (0.5 + w)) ** 2
    st = cfg["stats"]
    denom = torch.randint(st["denom_min"], st["denom_max"], (n,),
                          generator=gen, device=device).float()
    u = torch.rand((n, 3), generator=gen, device=device)
    thr = cfg["optimization"]["densify_grad_threshold"]
    hot = u[:, 0] < st["hot_share"]
    ratio = torch.where(hot, thr * (st["hot_low"] + st["hot_span"] * u[:, 1]),
                        thr * st["cold_high"] * u[:, 1])
    accum = ratio * denom
    max_radii2d = 10.0 * u[:, 2]

    rng = np.random.default_rng(seed)
    centres, look = capture(cfg).train_cameras(cfg, rng)
    # every ``test_every``-th camera is held out, as the loaders do
    keep = [i for i in range(len(centres)) if i % cfg["test_every"]]
    train = [make_view(centres[i], look[i], cfg, device) for i in keep]
    tc = centres[keep]
    lr_scale = float(np.linalg.norm(tc - tc.mean(0), axis=1).max() * 1.1)
    return Capture(params, mu, nu, iteration - 1, accum, denom, max_radii2d,
                   train, lr_scale, sphere)


def make_targets(cfg: dict, cameras, seed: int, device, render):
    """[len(cameras), 3, H, W] training targets in [0, 1]: ``render(i)``,
    the scene's own render from training view ``i``, plus pixel noise of
    std ``target_noise`` drawn from the seed and the view's index (so
    either side can make any view's target alone), clamped. The scene is
    then a model converged to its captures up to their noise, as at a
    late training point."""
    H, W = cfg["height"], cfg["width"]
    out = torch.empty((len(cameras), 3, H, W), device=device)
    for j, i in enumerate(cameras):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1024 + i)
        noise = torch.randn((3, H, W), generator=gen, device=device)
        out[j] = torch.clamp(render(i) + cfg["target_noise"] * noise,
                             0.0, 1.0)
    return out
