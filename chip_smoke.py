#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Drives the port's serving path (``mvs_gaussian_splatting_tpu_torch``: PLY
load → measured eval raster layout → ``render``) on the retained 115,320-
Gaussian ``runs/specfinal`` model at its full 1237×822 resolution, on its 15
held-out test views, and holds the result against that run's ground truth
and against the JAX package's own renders of the same views. Phases, one
JSON line each:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: ``csrc/*.cu`` → ``build/torch_kernels/libgs_kernels.so`` with
   nvcc, and the kernel's ``-Xptxas -v`` register / shared-memory line;
3. kernel vs plain version: ``stream_fwd`` against
   ``composite_stream_plain`` on one real view's stream and on a random
   stream made from ``--seed`` (the 32 heaviest tiles plus 32 drawn with a
   seeded RNG, through ``tile_ids``), max abs ≤ 2e-4 on both outputs;
4. the slice: every test view rendered under ``torch.no_grad()``,
   quantised as ``save_image`` does; PSNR against ground truth (mean within
   0.02 dB of results.json, each view within 0.05 dB of per_view.json) and
   against the JAX package's renders (≥ 45 dB each), zero capacity
   overflow, one kernel launch per view; render times and peak memory.
   This layout's 16M slot limit clips the model's widest splats, as the
   JAX package's run did, and counts them in overflow_tiles;
4b. the same views on the clip-free layout (the 16M slot limit lifted):
   zero tile and capacity overflow;
5. per view: stage times of the render path (CUDA events), the kernel's
   time over repeated launches, its plain version's time and the least
   time the card could take (bytes over 3.35 TB/s, operations over
   67 TFLOP/s f32), printed as the ``kernels`` line;

and last ``{"ok": true, "device": {...}}``. A failed check raises after
the measurements and exits non-zero without printing those two lines;
without a card it exits non-zero before printing any result.
It writes nothing into the tree but the gitignored ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "runs", "specfinal", "model")
VIEWS = os.path.join(MODEL, "test", "ours_25000")
TOL = 2e-4                    # kernel vs plain version, max abs
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM, f32 outside the tensor cores
FLOPS_PER_PAIR = 20           # per (entry, pixel) pair visited
KERNEL_SOURCE = "mvs_gaussian_splatting_tpu_torch/csrc/stream_fwd.cu"
REPLACES = "mvs_gaussian_splatting_tpu/ops/pallas/stream.py:89"


def emit(obj):
    print(json.dumps(obj), flush=True)


def psnr(a: np.ndarray, b: np.ndarray):
    """PSNR of two uint8 images over all values, as eval/metrics computes
    it; None where they are identical."""
    mse = float(np.mean((a.astype(np.float64) / 255.0
                         - b.astype(np.float64) / 255.0) ** 2))
    return (20 * np.log10(1.0 / np.sqrt(mse)) if mse > 0 else None), mse


def load_png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random stream and tile subsets")
    args = ap.parse_args(argv)
    t_start = time.time()

    # 1. card
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from mvs_gaussian_splatting_tpu_torch import kernels
    from mvs_gaussian_splatting_tpu_torch.cli.render import (
        adaptive_eval_config, eval_raster_config, measure_tile_needs,
        params_from_ply, quantize_image)
    from mvs_gaussian_splatting_tpu_torch.data.cameras import camera_from_json
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        activated, get_features)
    from mvs_gaussian_splatting_tpu_torch.ops import stream
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import (
        assemble_stream_output, bin_and_pack_stream)
    from mvs_gaussian_splatting_tpu_torch.ops.render import render
    from mvs_gaussian_splatting_tpu_torch.train.config import PipelineConfig
    dev = torch.device("cuda")

    # 2. build
    t0 = time.time()
    kernels.build(force=True)
    kernels.library()
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "library": os.path.relpath(kernels.LIBRARY, ROOT),
          "ptxas": kernels.ptxas_report("stream_fwd")})

    # the model, its cameras and the measured eval layout
    t0 = time.time()
    with open(os.path.join(MODEL, "results.json")) as f:
        want_mean = json.load(f)["ours_25000"]["PSNR"]
    with open(os.path.join(MODEL, "per_view.json")) as f:
        want_view = json.load(f)["ours_25000"]["PSNR"]
    with open(os.path.join(MODEL, "cameras.json")) as f:
        cams = sorted((camera_from_json(e) for e in json.load(f)),
                      key=lambda c: c.image_name)
    test_cams = [c for i, c in enumerate(cams) if i % 8 == 0]  # llffhold 8
    params = params_from_ply(os.path.join(MODEL, "point_cloud_final.ply.gz"),
                             3, device=dev)
    n = int(params.xyz.shape[0])
    cfg_base = eval_raster_config(PipelineConfig(), n_gaussians=n)
    # the offline render measured needs over train and test views alike
    needs = measure_tile_needs(params, cams, cfg_base.tile_w, cfg_base.tile_h)
    layout = []
    cfg = adaptive_eval_config(cfg_base, needs, log=layout.append)
    bg = torch.zeros(3, device=dev)
    w, h = test_cams[0].width, test_cams[0].height
    tiles_x, tiles_y = -(-w // cfg.tile_w), -(-h // cfg.tile_h)
    emit({"phase": "setup", "gaussians": n, "cameras": len(cams),
          "test_views": [c.image_name for c in test_cams],
          "width": w, "height": h, "layout": layout,
          "max_tiles_per_gaussian": cfg.max_tiles_per_gaussian,
          "tier_budgets": list(cfg.tier_budgets),
          "tier_fracs": list(cfg.tier_fracs),
          "instance_cap": cfg.instance_cap,
          "seconds": round(time.time() - t0, 2)})

    def view_stream(cam):
        """(bins, attrs) of one view: render()'s front half."""
        with torch.no_grad():
            s, r, o = activated(params)
            p = preprocess(params.xyz, o, cam.view(dev), cam.width,
                           cam.height, scales=s, rotations=r,
                           shs=get_features(params), sh_degree=3,
                           tile_w=cfg.tile_w, tile_h=cfg.tile_h)
            return bin_and_pack_stream(p, tiles_x, tiles_y, cfg)

    def subset(counts_np, rng, k=32):
        heavy = np.argsort(-counts_np, kind="stable")[:k]
        rest = np.setdiff1d(np.arange(len(counts_np)), heavy)
        return np.concatenate([heavy, rng.choice(rest, min(k, len(rest)),
                                                 replace=False)])

    def kernel_vs_plain(attrs, seg_start, counts, bg_t, tile_ids, tx):
        out, tfin = stream.composite_stream(attrs, seg_start, counts, bg_t,
                                            tile_ids, tx, cfg.tile_w,
                                            cfg.tile_h)
        torch.cuda.synchronize()
        ref, rtfin = stream.composite_stream_plain(
            attrs, seg_start, counts, bg_t, tile_ids, tx, cfg.tile_w,
            cfg.tile_h)
        return (float((out - ref).abs().max()),
                float((tfin - rtfin).abs().max()))

    # 3. kernel vs plain version
    rng = np.random.RandomState(args.seed)
    bins, attrs = view_stream(test_cams[0])
    sel = subset(bins.counts.cpu().numpy(), rng)
    ids = torch.tensor(sel, dtype=torch.int32, device=dev)
    real = kernel_vs_plain(attrs, bins.seg_start[ids.long()].contiguous(),
                           bins.counts[ids.long()].contiguous(), bg, ids,
                           tiles_x)
    real_entries = int(bins.counts[ids.long()].sum())
    del bins, attrs
    syn = stream.random_stream(args.seed)
    sel = subset(syn["counts"], rng)
    gpu = {k: torch.from_numpy(syn[k]).to(dev)
           for k in ("attrs", "seg_start", "counts", "bg")}
    idx = torch.from_numpy(sel).to(dev)
    synthetic = kernel_vs_plain(
        gpu["attrs"], gpu["seg_start"][idx].contiguous(),
        gpu["counts"][idx].contiguous(), gpu["bg"],
        idx.to(torch.int32), syn["tiles_x"])
    gaps = {"real_view_out": real[0], "real_view_final_T": real[1],
            "synthetic_out": synthetic[0], "synthetic_final_T": synthetic[1]}
    emit({"phase": "kernel_vs_plain", "tolerance": TOL, "max_abs": gaps,
          "real_view": test_cams[0].image_name, "real_tiles": len(sel),
          "real_entries": real_entries,
          "synthetic_counts": {"empty": int((syn["counts"] == 0).sum()),
                               "one": int((syn["counts"] == 1).sum()),
                               "over_10_batches": int(
                                   (syn["counts"] > 2560).sum())}})
    # checks are collected and raised after the last measurement
    faults = []
    if max(gaps.values()) > TOL:
        faults.append(f"kernel disagrees with its plain version: {gaps}")

    # 4. the slice: the main path, counted from zero
    torch.cuda.reset_peak_memory_stats()
    stream.launches = 0
    with torch.no_grad():                      # warm-up view
        render(test_cams[0].view(dev), w, h, params, bg, sh_degree=3,
               raster_config=cfg)
    torch.cuda.synchronize()
    rows = []
    for k, cam in enumerate(test_cams):
        before = stream.launches
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=cfg)
        img = out["render"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        q = quantize_image(img)
        name = f"{k:05d}.png"
        p_gt, _ = psnr(q, load_png(os.path.join(VIEWS, "gt", name)))
        p_jax, mse_jax = psnr(q, load_png(os.path.join(VIEWS, "renders",
                                                       name)))
        rows.append({"view": name, "ms": round(ms, 3), "psnr_gt": p_gt,
                     "psnr_gt_want": want_view[name], "psnr_vs_jax": p_jax,
                     "mse_vs_jax": mse_jax,
                     "launches": stream.launches - before,
                     "overflow_tiles": int(out["overflow_tiles"]),
                     "overflow_capacity": int(out["overflow_capacity"]),
                     "instance_load": int(out["instance_load"]),
                     "finite": bool(torch.isfinite(img).all())})
    launches = stream.launches
    peak = torch.cuda.max_memory_allocated()
    mean_gt = float(np.mean([r["psnr_gt"] for r in rows]))
    emit({"phase": "slice", "views": rows, "mean_psnr_gt": mean_gt,
          "mean_psnr_gt_want": want_mean, "launches": launches,
          "render_ms_mean": float(np.mean([r["ms"] for r in rows])),
          "peak_memory_bytes": peak})
    if abs(mean_gt - want_mean) > 0.02:
        faults.append(f"mean PSNR {mean_gt} vs {want_mean}")
    for r in rows:
        if abs(r["psnr_gt"] - r["psnr_gt_want"]) > 0.05:
            faults.append(f"{r['view']}: PSNR {r['psnr_gt']} vs "
                          f"{r['psnr_gt_want']}")
        if r["psnr_vs_jax"] is not None and r["psnr_vs_jax"] < 45.0:
            faults.append(f"{r['view']}: {r['psnr_vs_jax']} dB vs JAX render")
        # The reference layout's 16M-slot limit clips this model's widest
        # splats on purpose (runs/specfinal/NOTE.md), counted in
        # overflow_tiles; zero tile overflow is held on the clip-free
        # layout below.
        if r["overflow_capacity"]:
            faults.append(f"{r['view']}: capacity overflow "
                          f"{r['overflow_capacity']}")
        if r["launches"] != 1 or not r["finite"]:
            faults.append(f"{r['view']}: {r['launches']} kernel launches, "
                          f"finite {r['finite']}")

    # 4b. the same views on the clip-free layout (slot limit lifted)
    free_log = []
    free = adaptive_eval_config(cfg_base, needs, log=free_log.append,
                                slot_limit=1 << 28)   # memory guard only
    torch.cuda.reset_peak_memory_stats()
    free_rows = []
    for k, cam in enumerate(test_cams):
        before = stream.launches
        with torch.no_grad():
            out = render(cam.view(dev), cam.width, cam.height, params, bg,
                         sh_degree=3, raster_config=free)
        q = quantize_image(out["render"])
        p_gt, _ = psnr(q, load_png(os.path.join(VIEWS, "gt", f"{k:05d}.png")))
        free_rows.append({
            "psnr_gt": p_gt, "launches": stream.launches - before,
            "overflow_tiles": int(out["overflow_tiles"]),
            "overflow_capacity": int(out["overflow_capacity"]),
            "instance_load": int(out["instance_load"]),
            "finite": bool(torch.isfinite(out["render"]).all())})
    emit({"phase": "clip_free", "layout": free_log,
          "instance_cap": free.instance_cap, "views": free_rows,
          "mean_psnr_gt": float(np.mean([r["psnr_gt"] for r in free_rows])),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    for k, r in enumerate(free_rows):
        if (r["overflow_tiles"] or r["overflow_capacity"]
                or r["launches"] != 1 or not r["finite"]):
            faults.append(f"clip-free view {k}: {r}")

    # 5. stage times, kernel time, plain time and bound per view
    per_view = []
    reps = 5
    tile_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32, device=dev)
    for cam in test_cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.no_grad():
            ev[0].record()
            s, r, o = activated(params)
            p = preprocess(params.xyz, o, cam.view(dev), cam.width,
                           cam.height, scales=s, rotations=r,
                           shs=get_features(params), sh_degree=3,
                           tile_w=cfg.tile_w, tile_h=cfg.tile_h)
            ev[1].record()
            bins, attrs = bin_and_pack_stream(p, tiles_x, tiles_y, cfg)
            ev[2].record()
            call = (attrs, bins.seg_start, bins.counts, bg, tile_ids,
                    tiles_x, cfg.tile_w, cfg.tile_h)
            out, tfin = stream.composite_stream(*call)
            ev[3].record()
            assemble_stream_output(out, tfin, bins, p, tiles_x, tiles_y,
                                   cfg.tile_w, cfg.tile_h, cam.width,
                                   cam.height)
            ev[4].record()
        torch.cuda.synchronize()
        stages = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
                  enumerate(("preprocess", "bin_and_pack", "composite",
                             "assemble"))}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            stream.composite_stream(*call)
        stop.record()
        torch.cuda.synchronize()
        k_ms = start.elapsed_time(stop) / reps
        start.record()
        ref, rtfin, visits = stream.composite_stream_plain(
            *call, count_visits=True)
        stop.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(stop)
        err = max(float((out - ref).abs().max()),
                  float((tfin - rtfin).abs().max()))
        t = tiles_x * tiles_y
        entries = int(bins.counts.sum())
        nbytes = 9 * 4 * entries + 3 * 4 * t + 3 * 4 + 16 * t * cfg.tile_w \
            * cfg.tile_h
        flops = FLOPS_PER_PAIR * visits
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / F32_FLOPS_PER_S * 1e3
        per_view.append({"stages_ms": stages, "ms": k_ms, "plain_ms": p_ms,
                         "err": err,
                         "bytes": nbytes, "flops": flops, "bytes_ms": b_ms,
                         "flops_ms": f_ms, "entries": entries,
                         "visits": visits})
        del bins, attrs, out, tfin, ref, rtfin, p
    full_err = max(v["err"] for v in per_view)
    emit({"phase": "timing", "reps": reps, "views": per_view,
          "seconds_total": round(time.time() - t_start, 1)})
    if full_err > TOL:
        faults.append(f"kernel vs plain on full views: {full_err}")
    if faults:
        raise AssertionError("chip smoke failed: " + "; ".join(faults))
    mean = {k: float(np.mean([v[k] for v in per_view]))
            for k in ("ms", "plain_ms", "bytes_ms", "flops_ms")}
    bound = float(np.mean([max(v["bytes_ms"], v["flops_ms"])
                           for v in per_view]))
    emit({"kernels": [{
        "name": "stream_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(max(gaps.values()), full_err),
        "ms": mean["ms"], "plain_ms": mean["plain_ms"],
        "bound_ms": bound,
        "bound_by": ("bytes" if mean["bytes_ms"] >= mean["flops_ms"]
                     else "operations"),
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
