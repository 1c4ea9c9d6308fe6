"""``render``: ``ops/render.py:render`` on the offline render surface
(exact compositing, ``cli/render.py``'s eval layout sized from the tile
needs measured over the capture's render path at set-up): one client
renders the path's poses in turn, each frame synchronised before the
next. A seeded sample of the frames, with the heaviest pose in it, is
kept and compared with the reference's render once the window has
closed.
"""

from __future__ import annotations

import random
import time

import torch

from gsbench import scene, work
from gsbench.bench import (background, camera_views, pipeline_config,
                           ref_setup, rmse, tile_areas)
from gsbench.reference import step as ref


def judge(run, images: dict) -> None:
    """The run's checks: ``images`` (pose → the program's frame, or what
    is put in its place) against the reference's, and the window's
    counters."""
    run.checks = {"rmse": max(rmse(images[p], run.reference[p])
                              for p in run.reference),
                  "clipped": run.counts["clipped"]}


def run(run):
    from mvs_gaussian_splatting_tpu_torch.cli.render import (
        adaptive_eval_config, eval_raster_config)
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
        GaussianParams
    from mvs_gaussian_splatting_tpu_torch.ops.render import render as port

    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    n = cfg["n_gaussians"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    raw = scene.cloud(cfg, gen, dev)
    orbit = scene.orbit_views(cfg, tr["poses"], dev)
    views = camera_views(orbit)
    loads, need = tile_areas(raw, orbit, cfg, dev)
    rc = eval_raster_config(pipeline_config(cfg), n_gaussians=n)
    rc = adaptive_eval_config(rc, need.cpu().numpy(),
                              log=lambda *a: None,
                              slot_limit=tr["slot_limit"])
    params = GaussianParams(**raw)
    run.n_rows = n
    bg = background(cfg, dev)
    W, H = cfg["width"], cfg["height"]
    # the frames a traced window renders are the orbit's first ones
    span = min(tr["trace_views"], len(orbit)) if run.trace_on else len(orbit)
    heaviest = max(range(span), key=loads.__getitem__)
    rng = random.Random(run.seed + 5)
    others = [i for i in range(span) if i != heaviest]
    sample = sorted([heaviest] + rng.sample(others, tr["check_views"] - 1))
    kept = {}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    acc = {"clipped": zero.clone(), "failed": zero.clone()}
    alter = run.hooks.get("image")

    def frame(k: int):
        pose = k % len(views)
        out = port(views[pose], W, H, params, bg,
                   sh_degree=cfg["sh_degree"], raster_config=rc)
        img = out["render"]
        if alter is not None:
            img = alter(img, pose)
        clipped = (torch.as_tensor(out["overflow_tiles"]).long()
                   + torch.as_tensor(out["overflow_capacity"]).long()
                   + torch.as_tensor(out["overflow_visible"]).long())
        acc["clipped"] += clipped
        acc["failed"] += (clipped > 0).long()
        if pose in sample and pose not in kept:
            kept[pose] = img.clone()
        return img

    for k in range(tr["warmup_views"]):
        frame(heaviest + k)
    kept.clear()
    acc["clipped"].zero_()
    acc["failed"].zero_()
    run.close_setup()

    lat = []

    def body(k: int):
        t = time.perf_counter()
        frame(k)
        run.sync()
        lat.append(time.perf_counter() - t)

    frames, secs = run.window(body, tr["trace_views"])
    run.close_window(frames, secs)
    run.values["render_views_per_s"] = frames / secs
    lat.sort()
    run.values["render_ms_p95"] = lat[max(0, -(-95 * len(lat) // 100) - 1)] \
        * 1e3
    run.counts = {k: int(v) for k, v in acc.items()}
    run.failed = run.counts["failed"]
    kept = {k: v.cpu() for k, v in kept.items()}
    del params, raw
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference renders the kept frames ----------------------------
    if not kept:
        raise RuntimeError("the window rendered none of the sampled poses")
    poses = sorted(kept)
    run.reference = {}
    for pose, (img, pairs, rows) in zip(poses, reference_images(
            cfg, run.seed, orbit, poses, dev)):
        run.reference[pose] = img.cpu()
        run.work.append((pose, work.ViewWork(pairs, rows, W * H)))
    run.program = kept
    judge(run, kept)
    run.readings = {"rmse": [rmse(kept[p], run.reference[p]) for p in poses],
                    "max_abs": [float((kept[p] - run.reference[p]).abs()
                                      .max()) for p in poses],
                    "poses": poses,
                    "layout": [rc.max_tiles_per_gaussian, rc.tier_budgets,
                               rc.tier_fracs, rc.instance_cap],
                    "max_load": max(loads)}


def reference_images(cfg: dict, seed: int, orbit: list, poses: list, dev,
                     dtype=torch.float32):
    """The reference's (image, contributing pairs, contributing rows) of
    each pose, from the seed's cloud, one at a time. ``dtype`` below
    float32 is the control."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    raw = {k: v.to(dtype) for k, v in scene.cloud(cfg, gen, dev).items()}
    setup = ref_setup(cfg, dev)
    for pose in poses:
        img, pairs, rows = ref.render_view(raw, orbit[pose], setup)
        yield img.float(), pairs, rows
