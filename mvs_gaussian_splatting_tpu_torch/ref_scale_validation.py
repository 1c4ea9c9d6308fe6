"""The flagship's reference-scale run in the port: its procedural dataset
and a training run on it.

    python -m mvs_gaussian_splatting_tpu_torch.ref_scale_validation \\
        --out DIR [--scene_style specular] [--grow_dir] [--fast] \\
        [--iterations N] [--max_capacity N] [--device cuda|cpu]
    python -m mvs_gaussian_splatting_tpu_torch.ref_scale_validation \\
        --out DIR --smoke --device cpu          # a tiny CPU run

Port of the JAX package's ``scripts/ref_scale_validation.py``: a
bicycle-r4-scale workload (1237×822 images, 120 orbit views, 54,000
COLMAP-style init points subsampled with noise from a 150,000-Gaussian
ground truth) written to disk as a COLMAP dataset, then trained through
``train/loop.py:train`` from that dataset, as a real scene would be. The
ground truth (``build_gt_scene``) and the cameras (``orbit_cameras``) are
numpy, copied here; ``write_dataset`` renders each view through the port's
``preprocess`` and ``rasterize``, by default with the operator the TPU run
used (the stream backend, exact, 32×16 tiles, 1,024 slots a tile, 32
tiles per Gaussian). The image depends on the tile shape, so the tile shape
and the backend are arguments.

The recipes of the JAX package's runs: ``--scene_style specular`` (the
base recipe, exact mode, ``runs/specfinal``) and ``--grow_dir --fast
--max_capacity 524288 --scene_style specular`` (grow mode,
``runs/growspec30``). Writes ``<out>/dataset``, ``<out>/model`` (the
loop's outputs), ``<out>/train.log`` and ``<out>/history.json``: the
loop-eval test PSNR and alive count at every milestone, the wall time, the
step times and the peak device memory.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import math
import os
import re
import shutil
import time

import numpy as np

# the JAX package's runs of the two recipes: loop-eval test PSNR by
# iteration (runs/specfinal/NOTE.md, runs/growspec30/NOTE.md)
REFERENCE = {
    "base": {"source": "runs/specfinal/NOTE.md",
             "psnr_test": {1000: 24.10, 3000: 26.05, 5000: 26.78,
                           7000: 27.21, 10_000: 27.60, 15_000: 27.84,
                           20_000: 27.95, 25_000: 28.00}},
    "grow": {"source": "runs/growspec30/NOTE.md",
             "psnr_test": {1000: 24.03, 3000: 26.09, 5000: 26.73,
                           7000: 27.22, 10_000: 27.60, 15_000: 27.83,
                           20_000: 27.91, 25_000: 27.98}},
}


def build_gt_scene(n_target: int = 150_000, seed: int = 0,
                   style: str = "speckle"):
    """Structured GT Gaussian soup: textured ground plane + blob clusters +
    scattered dust. Returns dict of numpy arrays.

    ``style``: "speckle" (per-point colour noise + random coloured dust),
    "clean" (smooth surfaces, no random dust) or "specular" (clean
    geometry + view-dependent materials via per-point SH to degree 3 + thin
    wire structures); "specular" adds an ``shs`` [N, 16, 3] key."""
    clean = style in ("clean", "specular")
    specular = style == "specular"
    rng = np.random.RandomState(seed)
    parts = []

    def add(xyz, scale, color, opac):
        parts.append((xyz.astype(np.float32), scale.astype(np.float32),
                      color.astype(np.float32), opac.astype(np.float32)))

    # ground plane y = +1.5 (camera looks slightly down), procedural texture
    ng = int(n_target * 0.40)
    gx = rng.uniform(-8, 8, ng)
    gz = rng.uniform(-8, 8, ng)
    gy = 1.5 + 0.06 * np.sin(1.7 * gx) * np.cos(2.3 * gz) + rng.normal(0, 0.01, ng)
    checker = ((np.floor(gx * 1.5) + np.floor(gz * 1.5)) % 2)
    tex = 0.5 + 0.5 * np.sin(3.1 * gx) * np.sin(2.7 * gz)
    col = np.stack([0.25 + 0.5 * checker,
                    0.35 + 0.4 * tex,
                    0.30 + 0.35 * (1 - checker) * tex], -1)
    if not clean:
        col += rng.normal(0, 0.05, col.shape)
    add(np.stack([gx, gy, gz], -1),
        rng.uniform(0.03, 0.09, (ng, 3)), np.clip(col, 0, 1),
        rng.uniform(0.7, 0.98, ng))

    # blob clusters (objects)
    n_clusters = 24
    nb = int(n_target * 0.35) // n_clusters
    for c in range(n_clusters):
        center = np.array([rng.uniform(-5, 5), rng.uniform(-0.8, 1.2),
                           rng.uniform(-5, 5)])
        radius = rng.uniform(0.3, 1.0)
        base = rng.rand(3)
        pts = center + rng.normal(0, radius / 2.2, (nb, 3))
        freq = 1.5 if clean else 7.0
        amp = 0.2 if clean else 0.35
        col = np.clip(base + amp * np.sin(freq * pts[:, :3]), 0, 1)
        add(pts, rng.uniform(0.02, 0.07, (nb, 3)) * (radius + 0.4), col,
            rng.uniform(0.6, 0.97, nb))

    # enclosing background shell: full-frame content behind the scene
    ns = int(n_target * 0.18)
    u = rng.normal(0, 1, (ns, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r_shell = rng.uniform(15.0, 17.0, ns)
    sp = u * r_shell[:, None]
    scol = np.stack([0.35 + 0.3 * np.sin(2.1 * sp[:, 0]) * np.cos(1.3 * sp[:, 1]),
                     0.40 + 0.25 * np.sin(1.7 * sp[:, 1] + 1.0),
                     0.45 + 0.3 * np.cos(1.9 * sp[:, 2])], -1)
    add(sp, rng.uniform(0.25, 0.6, (ns, 3)), np.clip(scol, 0, 1),
        rng.uniform(0.8, 0.99, ns))

    # thin wire structures (specular style): bright rods of closely spaced
    # tiny splats
    if specular:
        n_rods = 40
        per_rod = max(8, int(n_target * 0.05) // n_rods)
        for r in range(n_rods):
            a = np.array([rng.uniform(-6, 6), rng.uniform(-1.2, 1.3),
                          rng.uniform(-6, 6)])
            d = rng.normal(0, 1, 3)
            d /= np.linalg.norm(d)
            length = rng.uniform(1.0, 3.0)
            t = np.linspace(0, length, per_rod)[:, None]
            pts = a + t * d + rng.normal(0, 0.008, (per_rod, 3))
            base = np.clip(rng.rand(3) * 0.7 + 0.3, 0, 1)
            col = np.broadcast_to(base, (per_rod, 3)).copy()
            col += 0.1 * np.sin(4.0 * t)      # slow variation along the rod
            add(pts, np.full((per_rod, 3), 0.012, np.float32),
                np.clip(col, 0, 1), rng.uniform(0.85, 0.99, per_rod))

    # dust: the same tiny geometry in every style; clean styles only
    # smooth its colours
    nd = max(256, n_target - sum(p[0].shape[0] for p in parts))
    dx_ = rng.uniform(-7, 7, nd)
    dz_ = rng.uniform(-7, 7, nd)
    dy_ = rng.uniform(-1.5, 1.4, nd)
    if clean:
        dcol = np.clip(np.stack([0.4 + 0.25 * np.sin(0.9 * dx_),
                                 0.45 + 0.25 * np.sin(0.7 * dy_ + 2.0),
                                 0.5 + 0.25 * np.cos(0.8 * dz_)], -1), 0, 1)
    else:
        dcol = rng.rand(nd, 3)
    add(np.stack([dx_, dy_, dz_], -1),
        rng.uniform(0.01, 0.05, (nd, 3)), dcol,
        rng.uniform(0.3, 0.9, nd))

    xyz = np.concatenate([p[0] for p in parts])
    scale = np.concatenate([p[1] for p in parts])
    color = np.concatenate([p[2] for p in parts])
    opac = np.concatenate([p[3] for p in parts])
    quats = rng.randn(xyz.shape[0], 4).astype(np.float32)
    out = dict(xyz=xyz, scale=scale, color=color, opac=opac, quats=quats)

    if specular:
        # view-dependent materials, full degree-3 SH per point: the l=1
        # band a smooth directional gain toward v(x) with strength k(x),
        # l=2 and l=3 small higher-order lobes
        n = xyz.shape[0]
        C0, C1 = 0.28209479177387814, 0.4886025119029199
        px, py, pz = xyz.T
        shs = np.zeros((n, 16, 3), np.float32)
        shs[:, 0] = (color - 0.5) / C0
        k = (0.16 + 0.10 * np.sin(0.7 * px) * np.cos(0.6 * pz)).astype(np.float32)
        v = np.stack([np.sin(0.5 * px + 1.3),
                      0.4 * np.cos(0.4 * py),
                      np.cos(0.5 * pz)], -1)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-6
        # radiance ≈ DC + k·dot(dir, v) in the PlenOctree basis signs
        for c, gain in enumerate((1.0, 0.75, 1.15)):
            shs[:, 1, c] = -(k * gain) * v[:, 1] / C1
            shs[:, 2, c] = (k * gain) * v[:, 2] / C1
            shs[:, 3, c] = -(k * gain) * v[:, 0] / C1
        ph = np.stack([px, py, pz, px + pz, py - pz], -1)   # [N, 5]
        for c, phase in enumerate((0.0, 2.1, 4.2)):
            shs[:, 4:9, c] = (0.04 * np.sin(1.3 * ph + phase)).astype(np.float32)
        shs[:, 9:16, 0] = 0.015 * np.sin(0.9 * px)[:, None]
        shs[:, 9:16, 1] = 0.015 * np.cos(0.8 * py)[:, None]
        shs[:, 9:16, 2] = 0.015 * np.sin(0.7 * pz + 0.5)[:, None]
        out["shs"] = shs
    return out


def orbit_cameras(n_views: int, width: int, height: int, fovx_deg: float,
                  seed: int = 1):
    """[(R world→camera, t, fovx, fovy)] of ``n_views`` cameras on a
    wobbling orbit looking at the scene's centre."""
    from .utils import graphics
    rng = np.random.RandomState(seed)
    fovx = math.radians(fovx_deg)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    cams = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views + rng.normal(0, 0.02)
        r = 9.0 + 2.0 * math.sin(2.3 * a) + rng.normal(0, 0.2)
        eye = np.array([r * math.sin(a),
                        -1.2 - 0.8 * math.cos(1.7 * a),
                        -r * math.cos(a)])
        target = np.array([rng.normal(0, 0.3), 0.5, rng.normal(0, 0.3)])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        Rw2c = np.stack([right, np.cross(fwd, right), fwd])
        cams.append((Rw2c, -Rw2c @ eye, fovx, fovy))
    return cams


def write_dataset(out_dir: str, width: int, height: int, n_views: int,
                  n_gt: int, n_init: int, seed: int, log,
                  style: str = "speckle", *, tile_w: int = 32,
                  tile_h: int = 16, backend: str = "stream",
                  device="cuda") -> dict:
    """Render the GT views on ``device`` and write a COLMAP-layout dataset
    (``images/view_NNNN.png``, ``sparse/0/{cameras,images,points3D}.bin``)
    under ``out_dir``. Returns {"seconds": wall time, "render_seconds":
    the time in the renders}."""
    import torch
    from PIL import Image

    from .data.colmap import (CameraIntrinsics, ImageExtrinsics,
                              rotmat2qvec, write_cameras_binary,
                              write_images_binary, write_points3d_binary)
    from .ops.preprocess import CameraView, preprocess
    from .ops.rasterize import RasterConfig, rasterize
    from .utils import graphics
    from .utils.transforms import normalize

    t_start = time.time()
    gt = build_gt_scene(n_gt, seed, style=style)
    cams = orbit_cameras(n_views, width, height, 65.0, seed + 1)
    cfg = RasterConfig(tile_w=tile_w, tile_h=tile_h, tile_capacity=1024,
                       max_tiles_per_gaussian=32, tile_batch=64,
                       backend=backend)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    means, scales, opac = dev(gt["xyz"]), dev(gt["scale"]), dev(gt["opac"])
    quats = normalize(dev(gt["quats"]))
    colors = dev(gt["color"])
    shs = dev(gt["shs"]) if "shs" in gt else None

    @torch.no_grad()
    def render_one(cam: CameraView):
        if shs is not None:
            # view-dependent GT: full degree-3 SH evaluation per view
            p = preprocess(means, opac, cam, width, height, scales=scales,
                           rotations=quats, shs=shs, sh_degree=3,
                           tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        else:
            p = preprocess(means, opac, cam, width, height, scales=scales,
                           rotations=quats, colors_precomp=colors,
                           tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        img, _ = rasterize(p, width, height,
                           torch.zeros(3, device=device), cfg)
        return torch.clamp(img, 0.0, 1.0)

    img_dir = os.path.join(out_dir, "images")
    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(sparse, exist_ok=True)

    fx = graphics.fov2focal(cams[0][2], width)
    fy = graphics.fov2focal(cams[0][3], height)
    write_cameras_binary(
        {1: CameraIntrinsics(id=1, model="PINHOLE", width=width,
                             height=height,
                             params=np.array([fx, fy, width / 2, height / 2]))},
        os.path.join(sparse, "cameras.bin"))

    images = {}
    render_s = 0.0
    P = graphics.projection_matrix(0.01, 100.0, cams[0][2], cams[0][3])
    for i, (R, t, fovx, fovy) in enumerate(cams):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        view = CameraView(dev(w2c), dev((P @ w2c).astype(np.float32)),
                          dev(np.linalg.inv(w2c)[:3, 3]),
                          dev(math.tan(fovx / 2)), dev(math.tan(fovy / 2)))
        t0 = time.time()
        img = render_one(view).cpu().numpy()
        render_s += time.time() - t0
        name = f"view_{i:04d}.png"
        Image.fromarray((img.transpose(1, 2, 0) * 255).astype(np.uint8)).save(
            os.path.join(img_dir, name))
        images[i + 1] = ImageExtrinsics(
            id=i + 1, qvec=rotmat2qvec(R), tvec=t.astype(np.float64),
            camera_id=1, name=name)
        if i % 20 == 0:
            log(f"rendered {i + 1}/{n_views} GT views "
                f"({time.time() - t_start:.0f}s)")
    write_images_binary(images, os.path.join(sparse, "images.bin"))

    # sparse init: subsample GT with noise (a COLMAP-like point cloud)
    rng = np.random.RandomState(seed + 2)
    idx = rng.choice(gt["xyz"].shape[0], n_init, replace=False)
    pts = gt["xyz"][idx] + rng.normal(0, 0.02, (n_init, 3)).astype(np.float32)
    rgb = (np.clip(gt["color"][idx] + rng.normal(0, 0.03, (n_init, 3)), 0, 1)
           * 255).astype(np.uint8)
    write_points3d_binary(pts, rgb, os.path.join(sparse, "points3D.bin"))
    log(f"dataset written to {out_dir} ({n_views} views, {n_init} init pts)")
    return {"seconds": time.time() - t_start, "render_seconds": render_s}


def _card(device: str) -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    if not str(device).startswith("cuda"):
        return {"device": str(device)}
    import torch

    from .tools.measure import card
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": [card()]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--width", type=int, default=1237)
    ap.add_argument("--height", type=int, default=822)
    ap.add_argument("--views", type=int, default=120)
    ap.add_argument("--gt_points", type=int, default=150_000)
    ap.add_argument("--init_points", type=int, default=54_000)
    ap.add_argument("--iterations", type=int, default=30_000)
    ap.add_argument("--max_capacity", type=int, default=1_000_000)
    ap.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    ap.add_argument("--percent_dense", type=float, default=0.01)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sanity configuration (160x120, 12 views, "
                         "300 iterations)")
    ap.add_argument("--grow_dir", action="store_true",
                    help="learnable grow-direction mode")
    ap.add_argument("--growdirs_lr", type=float, default=0.01)
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="resume from the newest chkpnt*.npz in <out>/model "
                         "(--no-resume starts afresh)")
    ap.add_argument("--divergence_psnr_drop", type=float, default=3.0,
                    help="abort and checkpoint when the test PSNR sits this "
                         "many dB below its best for 3 evals in a row "
                         "(0 = off)")
    ap.add_argument("--scene_style", choices=("speckle", "clean", "specular"),
                    default="speckle")
    ap.add_argument("--fast", action="store_true",
                    help="train in fast-math mode (evals stay exact)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.width, args.height = 160, 120
        args.views, args.gt_points, args.init_points = 12, 3000, 500
        args.iterations = 300

    import torch

    from .train.config import (ModelConfig, OptimizationConfig,
                               PipelineConfig, TrainRunConfig)
    from .train.loop import train

    os.makedirs(args.out, exist_ok=True)
    logf = open(os.path.join(args.out, "train.log"), "a", buffering=1)

    def log(msg):
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        logf.write(line + "\n")

    card = _card(args.device)
    log(f"device: {card}")
    dataset = os.path.join(args.out, "dataset")
    dataset_s = None
    if not os.path.exists(os.path.join(dataset, "sparse", "0",
                                       "points3D.bin")):
        dataset_s = write_dataset(dataset, args.width, args.height,
                                  args.views, args.gt_points,
                                  args.init_points, seed=0, log=log,
                                  style=args.scene_style,
                                  device=args.device)

    model_cfg = ModelConfig(source_path=dataset,
                            model_path=os.path.join(args.out, "model"),
                            eval=True, resolution=1, grow_dir=args.grow_dir)
    opt_cfg = OptimizationConfig(
        iterations=args.iterations,
        densify_grad_threshold=args.densify_grad_threshold,
        percent_dense=args.percent_dense, max_capacity=args.max_capacity,
        growdirs_lr=args.growdirs_lr)
    # the flagship's tiles (32x16) with a generous top tier of tile budgets
    pipe_cfg = PipelineConfig(tile_w=32, tile_h=16,
                              max_tiles_per_gaussian=512,
                              tier_budgets=(4, 12, 64),
                              tier_fracs=(0.25, 0.1, 0.01),
                              fast_math=args.fast)
    start_checkpoint = ""
    if args.resume:
        cands = [(int(m.group(1)), p)
                 for p in glob.glob(os.path.join(args.out, "model",
                                                 "chkpnt*.npz"))
                 for m in [re.search(r"chkpnt(\d+)\.npz$",
                                     os.path.basename(p))] if m]
        if cands:
            it, best = max(cands)
            if it >= args.iterations:
                log(f"resume: checkpoint {best} is at iteration {it} >= "
                    f"--iterations {args.iterations}; nothing to do")
                return None
            start_checkpoint = best
            log(f"resuming from {start_checkpoint}")

    mile = [1000, 3000, 5000, 7000, 10_000, 15_000, 20_000, 22_000,
            24_000, 25_000, 26_000, 28_000, 30_000, 35_000, args.iterations]
    run_cfg = TrainRunConfig(
        test_iterations=sorted({m for m in mile if m <= args.iterations}),
        save_iterations=[args.iterations],
        checkpoint_iterations=[m for m in (7000, 15_000, 22_000, 30_000,
                                           36_000)
                               if m < args.iterations],
        start_checkpoint=start_checkpoint,
        divergence_psnr_drop=args.divergence_psnr_drop)

    if str(args.device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, aux, scene, history = train(model_cfg, opt_cfg, pipe_cfg,
                                        run_cfg, log_fn=log,
                                        device=args.device)
    wall = time.time() - t0

    ply = os.path.join(args.out, "model", "point_cloud",
                       f"iteration_{args.iterations}", "point_cloud.ply")
    if os.path.exists(ply):
        gz = os.path.join(args.out, "model", "point_cloud_final.ply.gz")
        with open(ply, "rb") as fi, gzip.open(gz, "wb",
                                              compresslevel=6) as fo:
            shutil.copyfileobj(fi, fo)
        log(f"retained final model: {gz} ({os.path.getsize(gz) / 1e6:.1f} MB)")
    # step times: the loop's rate over each 10-iteration window
    step_ms = [1e3 / r for _, r in history["iter_time"]]
    recipe = "grow" if args.grow_dir else "base"
    summary = {
        "workload": f"{args.width}x{args.height}, {args.views} views, "
                    f"{args.init_points} init pts, {args.iterations} iters",
        "recipe": {"grow_dir": args.grow_dir, "fast": args.fast,
                   "scene_style": args.scene_style,
                   "max_capacity": args.max_capacity,
                   "growdirs_lr": args.growdirs_lr},
        "card": card,
        "dataset_seconds": dataset_s,
        "wall_seconds": wall,
        "final_alive": int(aux.alive.sum()),
        "psnr_test": history["psnr_test"],
        "psnr_train": history.get("psnr_train", {}),
        "n_alive": history["n_alive"],
        "densify_rounds": len(history.get("densify", [])),
        "step_ms_median": float(np.median(step_ms)) if step_ms else None,
        "step_ms_quartiles": ([float(np.percentile(step_ms, q))
                               for q in (25, 75)] if step_ms else None),
        "iter_time": history["iter_time"][-20:],
        "loss_tail": history["loss"][-20:],
        "nonfinite_grad_rows": sum(v for _, v in
                                   history.get("nonfinite_grad_rows", [])),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                              if str(args.device).startswith("cuda")
                              else None),
        "reference": REFERENCE[recipe],
    }
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log(f"DONE in {wall / 3600:.3f} h: final alive {summary['final_alive']}, "
        f"PSNR {history['psnr_test']}")
    return summary


if __name__ == "__main__":
    main()
