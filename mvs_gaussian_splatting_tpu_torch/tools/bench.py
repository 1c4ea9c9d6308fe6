"""1080p differentiable render, forward and backward, on one card.

Counterpart of the JAX repository's ``bench.py``: the hot path of a
training iteration (preprocess, tile binning, the packed instance stream,
the composite kernel, the backward to every Gaussian parameter) at
1920×1088 on 200,000 synthetic Gaussians sized like a densified scene,
printed as one JSON line::

    python -m mvs_gaussian_splatting_tpu_torch.tools.bench [--exact]
        [--forward] [--iters N] [--device cpu]

Fast-math compositing (B3f/B3b) is the default, as in training; ``--exact``
takes B1/B2. ``--forward`` times the render alone (B1 or B3f), the
measurement comparable with the reference's published "≥ 30 fps at
1080p", which is a forward-only render: ``vs_baseline`` is fps / 30.

Timing: a warm-up, then a burst of ``--iters`` steps that ends in a device
synchronise, on the host clock; ``extra`` adds the device milliseconds per
step and the busy share from ``torch.profiler`` over a short window, the
card's name and power limit, the overflow counters and the peak memory.
The instance capacity is calibrated to the measured load (+12 %) and falls
back to the auto capacity if that clips, as the JAX bench does.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ..ops.preprocess import CameraView, preprocess
from ..ops.rasterize import RasterConfig, rasterize
from ..ops.stream import CHUNK
from ..utils import graphics
from ..utils.transforms import normalize
from . import measure

WIDTH, HEIGHT, N = 1920, 1088, 200_000
BASELINE_FPS = 30.0       # the reference's published forward-only 1080p rate
PROFILE_STEPS = 3


def build_scene(n: int, width: int, height: int, seed: int = 0,
                device="cuda"):
    """(camera, (means, log_scales, quats, opacity_logits, shs)): a
    depth-stratified cloud filling the frustum of a camera at the origin
    looking down +z, with log-normal screen sizes (most splats a few
    pixels), SH degree 3. The numpy draws are the JAX bench's, in its
    order, so the arrays are bit-equal to its ``build_scene``."""
    rng = np.random.RandomState(seed)
    fovx = math.radians(65.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    z = rng.uniform(2.0, 12.0, n)
    x = rng.uniform(-0.95, 0.95, n) * z * math.tan(fovx / 2)
    y = rng.uniform(-0.95, 0.95, n) * z * math.tan(fovy / 2)
    means = np.stack([x, y, z], -1).astype(np.float32)
    focal = width / (2 * math.tan(fovx / 2))
    px_target = rng.lognormal(mean=np.log(2.5), sigma=0.6, size=n)
    world_scale = px_target * z / focal
    scales = (world_scale[:, None]
              * rng.uniform(0.6, 1.4, (n, 3))).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    shs = (rng.randn(n, 16, 3) * 0.2).astype(np.float32)
    arrays = (means, np.log(scales), quats,
              np.log(opac / (1 - opac)).astype(np.float32), shs)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    cam = CameraView(t(np.eye(4)), t(P), t(np.zeros(3)),
                     t(math.tan(fovx / 2)), t(math.tan(fovy / 2)))
    return cam, tuple(t(a) for a in arrays)


def raster_config(fast: bool) -> RasterConfig:
    """The bench's layout: 32×16 tiles, 32 tiles a Gaussian at most, the
    stream backend (the kernels on a card, their plain versions on the
    CPU)."""
    return RasterConfig(tile_w=32, tile_h=16, tile_capacity=1024,
                        max_tiles_per_gaussian=32, tile_batch=256,
                        backend="stream", fast_math=fast)


def project(arrays, cam, width: int, height: int, cfg: RasterConfig):
    """The scene's raw arrays preprocessed at ``cfg``'s tile shape."""
    means, log_scales, quats, opac_logit, shs = arrays
    return preprocess(means, torch.sigmoid(opac_logit), cam, width, height,
                      scales=torch.exp(log_scales),
                      rotations=normalize(quats), shs=shs, sh_degree=3,
                      tile_w=cfg.tile_w, tile_h=cfg.tile_h)


def render_image(arrays, cam, width: int, height: int, cfg: RasterConfig,
                 bg):
    """(image [3, H, W], aux) of the scene's raw arrays."""
    return rasterize(project(arrays, cam, width, height, cfg), width, height,
                     bg, cfg)


def loss_and_grads(arrays, cam, width: int, height: int, cfg: RasterConfig,
                   bg):
    """(loss = image mean, image, the five gradients, aux)."""
    leaves = [a.detach().requires_grad_(True) for a in arrays]
    img, aux = render_image(leaves, cam, width, height, cfg, bg)
    loss = img.mean()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), img.detach(), grads, aux


def make_step(arrays, cam, width: int, height: int, cfg: RasterConfig, bg,
              forward: bool):
    """One timed step: the render under ``no_grad``, or the loss and its
    gradients. Returns (tensors to check for finiteness, aux)."""
    def step():
        if forward:
            with torch.no_grad():
                img, aux = render_image(arrays, cam, width, height, cfg, bg)
            return (img,), aux
        _, img, grads, aux = loss_and_grads(arrays, cam, width, height, cfg,
                                            bg)
        return grads, aux
    return step


def load_cap(load: int) -> int:
    """An instance capacity for a measured tile load: the load plus 12 %,
    CHUNK-aligned, at least one CHUNK."""
    cap = load + int(0.12 * load)
    return max(cap + (-cap) % CHUNK, CHUNK)


def calibrate(arrays, cam, width: int, height: int, cfg: RasterConfig, bg,
              forward: bool):
    """The instance capacity sized to the measured tile load plus 12 %,
    CHUNK-aligned; the auto capacity again if that capacity clips.
    Returns (step, config, aux of its last call)."""
    _, aux = make_step(arrays, cam, width, height, cfg, bg, forward)()
    tight = cfg._replace(instance_cap=load_cap(int(aux["tile_counts"].sum())))
    step = make_step(arrays, cam, width, height, tight, bg, forward)
    _, aux = step()
    if int(aux["overflow_capacity"]):
        tight = cfg
        step = make_step(arrays, cam, width, height, cfg, bg, forward)
        _, aux = step()
    return step, tight, aux


def run(width: int = WIDTH, height: int = HEIGHT, n: int = N,
        fast: bool = True, forward: bool = False, iters: int = 10,
        device="cuda") -> dict:
    """The bench's JSON record (see the module docstring)."""
    device = torch.device(device)
    cam, arrays = build_scene(n, width, height, device=device)
    bg = torch.zeros(3, device=device)
    measure.reset_peak(device)
    step, cfg, aux = calibrate(arrays, cam, width, height,
                               raster_config(fast), bg, forward)
    ms = measure.host_ms(step, iters, device, warmup=2)
    prof = measure.busy(step, PROFILE_STEPS, device)
    outs, aux = step()
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    fps = 1e3 / ms
    what = "forward-only" if forward else "fwd+bwd"
    name = measure.device_name(device)
    where = "card" if device.type == "cuda" else "cpu"
    return {
        "metric": "1080p_forward_fps" if forward else "1080p_fwdbwd_fps",
        "value": fps,
        "unit": (f"steps/s ({width}x{height} {what}, {n // 1000}K "
                 f"gaussians, 1 {where})"),
        "vs_baseline": fps / BASELINE_FPS,
        "extra": {
            "mpix_per_s": width * height * fps / 1e6,
            "backend": "stream" + ("+fast" if fast else ""),
            "device": name,
            "card": measure.card() if device.type == "cuda" else None,
            "ms_per_step": ms,
            "timing": f"host clock, {iters} steps ending in a synchronise",
            "device_ms_per_step": prof["device_ms_per_step"],
            "busy_share": prof["busy_share"],
            "instance_cap": cfg.instance_cap,
            "instance_load": int(aux["tile_counts"].sum()),
            "tile_capacity_overflow_entries": int(aux["overflow_capacity"]),
            "overflow_tiles": int(aux["overflow_tiles"]),
            "overflow_visible": int(aux["overflow_visible"]),
            "max_memory_allocated": measure.peak_memory(device),
            "finite": finite,
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--exact", action="store_true",
                    help="exact compositing (B1/B2) instead of fast math")
    ap.add_argument("--forward", action="store_true",
                    help="time the render alone, no backward")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    result = run(fast=not args.exact, forward=args.forward,
                 iters=args.iters, device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
