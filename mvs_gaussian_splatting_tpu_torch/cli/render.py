"""Render CLI: render a trained model's train/test views to PNG.

Port of the JAX package's ``cli/render.py``, same flags plus ``--device``
(default ``cuda``): loads the model at iteration N (or the retained
``point_cloud_final.ply.gz``), sizes the eval raster layout from the
measured per-view tile needs, and writes ``<model>/<split>/ours_<iter>/
{renders,gt}/NNNNN.png``.

    python -m mvs_gaussian_splatting_tpu_torch.cli.render -m <model_dir>

Rendering is exact whatever ``--fast_math`` says; ``--backend pallas`` (or
``jnp``) composites padded per-tile tables with the measured layout's
``max_tiles_per_gaussian`` as the flat per-Gaussian budget and
``--tile_capacity`` entries per tile. Each split's clipping (the overflow
counters summed over its views) is printed and returned by :func:`main`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
from PIL import Image

from ..data.scene import Scene
from ..models.gaussians import GaussianParams, activated, params_from_numpy
from ..models.ply import load_gaussian_ply
from ..ops.binning import adaptive_tier_layout, stream_instance_bound
from ..ops.preprocess import preprocess
from ..ops.rasterize import widen_eval_budgets
from ..ops.render import render
from ..ops.stream import tile_limit
from ..train.config import ModelConfig, PipelineConfig, load_cfg_args
from ..train.loop import raster_config_from_pipe
from ..utils.system import search_max_iteration
from .args import add_dataclass_args, extract, merge_with_saved


def params_from_ply(path: str, sh_degree: int, device="cuda") -> GaussianParams:
    return params_from_numpy(load_gaussian_ply(path, max_sh_degree=sh_degree),
                             device)


def quantize_image(img: torch.Tensor) -> np.ndarray:
    """[3, H, W] float image → [H, W, 3] uint8, as written to PNG."""
    arr = torch.clamp(img, 0.0, 1.0).cpu().numpy()
    return (arr.transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8)


def save_image(img: torch.Tensor, path: str) -> None:
    Image.fromarray(quantize_image(img)).save(path)


def eval_raster_config(pipe_cfg, n_gaussians: int = 0):
    """Offline rendering is an EVAL surface: exact compositing and generous
    per-Gaussian tile budgets. With ``n_gaussians`` the instance capacity is
    the exact tier-enumeration bound, so global capacity overflow cannot
    happen."""
    cfg = widen_eval_budgets(
        raster_config_from_pipe(pipe_cfg)._replace(fast_math=False))
    if n_gaussians:
        bound = stream_instance_bound(n_gaussians, cfg.max_tiles_per_gaussian,
                                      cfg.tier_budgets, cfg.tier_fracs)
        cfg = cfg._replace(instance_cap=bound + (-bound) % 128)
    return cfg


def measure_tile_needs(params: GaussianParams, cameras, tile_w: int,
                       tile_h: int) -> np.ndarray:
    """Per-Gaussian worst-case tile count over ``cameras``: the projected
    rect area of each visible splat, maxed across views (preprocess only)."""
    dev = params.xyz.device
    with torch.no_grad():
        scales, rotations, opacity = activated(params)
        dummy_rgb = torch.zeros_like(params.xyz)
        needs = torch.zeros(params.xyz.shape[0], dtype=torch.int64,
                            device=dev)
        for cam in cameras:
            p = preprocess(params.xyz, opacity, cam.view(dev), cam.width,
                           cam.height, scales=scales, rotations=rotations,
                           colors_precomp=dummy_rgb, tile_w=tile_w,
                           tile_h=tile_h)
            area = (torch.clamp(p.rect_max[:, 0] - p.rect_min[:, 0], min=0)
                    * torch.clamp(p.rect_max[:, 1] - p.rect_min[:, 1], min=0))
            needs = torch.maximum(needs, torch.where(p.mask, area, 0))
    return needs.cpu().numpy()


def adaptive_eval_config(cfg, needs: np.ndarray, log=print,
                         slot_limit: int = 16_000_000):
    """Resize ``cfg``'s tier layout from measured tile needs (see
    ops/binning.adaptive_tier_layout) and re-derive the exact instance cap,
    so offline rendering is clip-free up to ``slot_limit`` instance slots
    (the JAX package's fixed 16M; beyond it splats are clipped, and
    counted in overflow_tiles)."""
    n = int(needs.shape[0])
    # A flat () layout means "never clip": a needs-sized ladder renders the
    # same image with far fewer slots.
    budgets_in = cfg.tier_budgets or (4, 12, 64)
    fracs_in = cfg.tier_fracs if cfg.tier_budgets else (0.0, 0.0, 0.0)
    d, budgets, fracs, n_clipped = adaptive_tier_layout(
        needs, cfg.max_tiles_per_gaussian, budgets_in, fracs_in,
        slot_limit=slot_limit, quantize=True)
    if n_clipped:
        log(f"WARNING: adaptive budgets hit the slot limit — {n_clipped} "
            f"Gaussians render with fewer tiles than they need")
    bound = stream_instance_bound(n, d, budgets, fracs)
    log(f"adaptive eval budgets: max_tiles {d}, tiers {budgets} @ "
        f"fracs {tuple(round(f, 4) for f in fracs)} "
        f"(need max {int(needs.max()) if n else 0}, instance cap {bound})")
    return cfg._replace(max_tiles_per_gaussian=d, tier_budgets=budgets,
                        tier_fracs=fracs,
                        instance_cap=bound + (-bound) % 128)


def render_set(model_path, name, iteration, cameras, params, bg, sh_degree,
               raster_cfg):
    """Renders and writes ``cameras``; returns the overflow counters summed
    over them."""
    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gt_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gt_path, exist_ok=True)
    dev = params.xyz.device
    overflow = {"views": 0, "overflow_tiles": 0, "overflow_capacity": 0}
    for idx, cam in enumerate(cameras):
        with torch.no_grad():
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=sh_degree, raster_config=raster_cfg)
        save_image(out["render"], os.path.join(render_path, f"{idx:05d}.png"))
        if cam.image is not None:
            save_image(torch.from_numpy(cam.image),
                       os.path.join(gt_path, f"{idx:05d}.png"))
        overflow["views"] += 1
        for key in ("overflow_tiles", "overflow_capacity"):
            overflow[key] += int(out[key])
    print(f"{name}: {overflow}")
    return overflow


def main(argv=None):
    """Returns each rendered split's overflow counters (see
    :func:`render_set`)."""
    parser = argparse.ArgumentParser(description="Testing script parameters")
    add_dataclass_args(parser, ModelConfig, sentinel=True)
    add_dataclass_args(parser, PipelineConfig)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--adaptive_budgets",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="size tier budgets from the measured per-view "
                        "tile needs so no splat is clipped (default on)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default cuda)")
    args = parser.parse_args(argv)
    # an empty tile, refused before any data is read
    why = tile_limit(args.tile_w, args.tile_h)
    if why:
        parser.error(f"--tile_w {args.tile_w} --tile_h {args.tile_h}: {why}")
    device = torch.device(args.device)

    try:
        saved = load_cfg_args(args.model_path)
    except (FileNotFoundError, TypeError):
        saved = None
    model_cfg = merge_with_saved(ModelConfig, args, saved)
    model_cfg.model_path = args.model_path
    pipe_cfg = extract(PipelineConfig, args)

    retained = os.path.join(model_cfg.model_path, "point_cloud_final.ply.gz")
    iteration = args.iteration
    if iteration == -1:
        try:
            iteration = search_max_iteration(
                os.path.join(model_cfg.model_path, "point_cloud"))
        except (FileNotFoundError, ValueError):
            iteration = -1
    if iteration == -1:
        if os.path.exists(retained):
            iteration = "final"
        else:
            raise FileNotFoundError(
                f"no checkpoint under "
                f"{os.path.join(model_cfg.model_path, 'point_cloud')} and no "
                f"retained point_cloud_final.ply.gz — nothing to render")
    print(f"Rendering {model_cfg.model_path} at iteration {iteration}")

    scene = Scene(model_cfg, load_iteration=iteration, shuffle=False)
    ply = os.path.join(model_cfg.model_path, "point_cloud",
                       f"iteration_{iteration}", "point_cloud.ply")
    if not os.path.exists(ply) and os.path.exists(retained):
        print(f"using retained final model {retained}")
        ply = retained
    params = params_from_ply(ply, model_cfg.sh_degree, device)
    bg = (torch.ones(3, device=device) if model_cfg.white_background
          else torch.zeros(3, device=device))
    raster_cfg = eval_raster_config(pipe_cfg,
                                    n_gaussians=int(params.xyz.shape[0]))
    if args.adaptive_budgets:
        cams = (([] if args.skip_train else list(scene.get_train_cameras()))
                + ([] if args.skip_test else list(scene.get_test_cameras())))
        if cams:
            needs = measure_tile_needs(params, cams, raster_cfg.tile_w,
                                       raster_cfg.tile_h)
            raster_cfg = adaptive_eval_config(raster_cfg, needs)

    overflow = {}
    if not args.skip_train:
        overflow["train"] = render_set(
            model_cfg.model_path, "train", iteration,
            scene.get_train_cameras(), params, bg, model_cfg.sh_degree,
            raster_cfg)
    if not args.skip_test:
        overflow["test"] = render_set(
            model_cfg.model_path, "test", iteration,
            scene.get_test_cameras(), params, bg, model_cfg.sh_degree,
            raster_cfg)
    return overflow


if __name__ == "__main__":
    main(sys.argv[1:])
