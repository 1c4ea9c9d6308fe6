"""Where the stream kernels' time goes, on the card: the split of B1's,
B3f's and B3b's time by section, their event counts, the tail of the last
wave, the instructions of the loop that holds the exp, and the issue-rate
floor those give.

    python -m mvs_gaussian_splatting_tpu_torch.profile_kernels \\
        [--csrc DIR] [--views N] [--out FILE]

Builds ``csrc/*.cu`` twice, with and without ``-DGS_SECTION_CLOCKS``
(``csrc/sections.cuh``: per-warp ``clock64()`` cycles by section, per-warp
event counts, each CTA's start and end ``%globaltimer``), into libraries of
their own beside the real one, and runs each kernel on the retained
``runs/specfinal`` model's streams: B3f and B3b on the flagship's training
layout (32×16 tiles, 512 tiles per Gaussian, tiers (4, 12, 64) at
(0.25, 0.1, 0.01)), B1 on the offline eval layout (16×16). ``--csrc``
points it at another tree's kernels with the same entry points and
counters. ``chip_smoke.py`` calls
:func:`kernel_split` on its own streams. Needs a card; the section
library is a measuring build only, never the one the port runs.

Sections: the forward's ``stage`` (the batch's loads, cull boxes and
stores), ``composite`` (the loop over the batch), ``epilogue`` (the output
writes) and ``wait_batch`` (the barrier that opens each batch); the fast
backward's ``stage``, ``replay`` (B3f's walk, dpower and w), ``mma`` (the
transposes through shared memory and the TF32 products), ``cross_warp``
(the sum over the tile's warps), ``closed_form`` (the per-entry gradients
written) and its three barriers' waits: ``wait_batch`` (opening a batch),
``wait_groups`` (after the products) and ``wait_sum`` (after the sum). A
warp waiting at a barrier is idle while the other CTA on its SM may issue.
Counts, per warp: the
warp-steps (one entry against one warp with a live lane), those with a
contributing (forward) or included (backward) lane, the live (entry,
pixel) pairs, the warp-steps the cull skipped, and the contributing
(entry, pixel) pairs (α ≥ 1/255).

The issue-rate floor: the SASS instructions of the innermost loop that
holds the exp's ``MUFU.EX2``, per exp (``cuobjdump -sass``), times the
warp-steps the cull let through, over (SMs × 4 issues per clock × the SM
clock ``nvidia-smi`` reads under load). It leaves out the culled
warp-steps' few instructions and, for B3b, the products and sums.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from . import kernels

SECTIONS = {
    "stream_fwd": ("stage", "composite", "epilogue", "wait_batch"),
    "stream_bwd_fast": ("stage", "replay", "mma", "cross_warp",
                        "closed_form", "wait_batch", "wait_groups",
                        "wait_sum"),
}
COUNTS = ("warp_steps", "warp_steps_contributing", "lane_pairs",
          "warp_steps_culled", "pairs_contributing")
ENTRY = {"stream_fwd": "gs_stream_fwd",
         "stream_fwd_fast": "gs_stream_fwd_fast",
         "stream_bwd_fast": "gs_stream_bwd_fast"}
SETTER = {"stream_fwd": "gs_stream_fwd_sections",
          "stream_fwd_fast": "gs_stream_fwd_sections",
          "stream_bwd_fast": "gs_stream_bwd_fast_sections"}
MANGLED = {"stream_fwd": "stream_fwd_kernelILb0E",
           "stream_fwd_fast": "stream_fwd_kernelILb1E",
           "stream_bwd_fast": "stream_bwd_fast_kernel"}
ISSUES_PER_CLOCK = 4          # warp schedulers per SM (Hopper)
DEFINES = ("GS_SECTION_CLOCKS",)


def build(csrc: Path = kernels.CSRC, name: str = "libgs_kernels"):
    """(main, sections): ``csrc`` built without and with the section clocks,
    both at once, into ``build/profile`` beside the real library."""
    out = kernels.BUILD_DIR.parent / "profile"
    paths = [out / f"{name}.so", out / f"{name}_sections.so"]
    errors = []

    def one(path, defines):
        try:
            kernels.build(True, csrc=Path(csrc), library=path,
                          defines=defines)
        except Exception as e:   # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(p, d)) for p, d in
               zip(paths, ((), DEFINES))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return tuple(kernels.load(p) for p in paths) + tuple(paths)


def launch(lib, kernel: str, call, bwd=None, order=None):
    """One launch of ``kernel`` from ``lib`` on ``call`` = (attrs,
    seg_start, counts, bg, tile_ids, tiles_x, tile_w, tile_h); ``bwd`` =
    (out, final_t, g_out, g_tfin) for the backward; ``order`` the tile
    order (int64; by default heaviest first, as the wrappers pass it).
    Returns its outputs."""
    from .ops.stream import heaviest_first
    attrs, seg_start, counts, bg, tile_ids, tiles_x, tile_w, tile_h = call
    t, p = seg_start.shape[0], tile_w * tile_h
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, ENTRY[kernel])
    if order is None:
        order = heaviest_first(counts)
    head = (attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
            counts.data_ptr(), tile_ids.data_ptr(), order.data_ptr())
    if bwd is None:
        out = torch.empty((t, p, 3), device=attrs.device)
        final_t = torch.empty((t, p), device=attrs.device)
        err = fn(*head, bg.data_ptr(), out.data_ptr(), final_t.data_ptr(), t,
                 tiles_x, tile_w, tile_h, stream)
        res = (out, final_t)
    else:
        gattrs = torch.zeros_like(attrs)
        err = fn(*head, *(a.data_ptr() for a in bwd), gattrs.data_ptr(), t,
                 tiles_x, tile_w, tile_h, stream)
        res = (gattrs,)
    if err:
        raise RuntimeError(f"{ENTRY[kernel]} launch failed: CUDA error {err}")
    return res


def _ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def tail(tiles: np.ndarray) -> dict:
    """The last wave from each CTA's [start, end] ns: the span, the drain
    (last end − last start: the time the card runs out of new tiles), the
    mean and longest CTA, and the most CTAs resident at once."""
    start, end = tiles[:, 0].astype(np.float64), tiles[:, 1].astype(np.float64)
    span = end.max() - start.min()
    events = np.concatenate([np.stack([start, np.ones_like(start)], 1),
                             np.stack([end, -np.ones_like(end)], 1)])
    events = events[np.lexsort((events[:, 1], events[:, 0]))]
    dur = end - start
    return {"span_us": span / 1e3, "drain_us": (end.max() - start.max()) / 1e3,
            "drain_share": float((end.max() - start.max()) / span),
            "cta_us_mean": float(dur.mean() / 1e3),
            "cta_us_max": float(dur.max() / 1e3),
            "resident_max": int(np.cumsum(events[:, 1]).max()),
            "heaviest_start_share": float(
                (start[dur.argmax()] - start.min()) / span)}


def kernel_split(main, sections, kernel: str, call, bwd=None, reps=5):
    """``kernel`` from the ``main`` and ``sections`` libraries on one
    stream: both times, the section split (share of the warps' cycles), the
    counts, the tail, and whether the two builds agree to the bit."""
    dev = call[0].device
    t = call[1].shape[0]
    buf = torch.zeros(16, dtype=torch.int64, device=dev)
    tiles = torch.zeros((t, 2), dtype=torch.int64, device=dev)
    err = getattr(sections, SETTER[kernel])(buf.data_ptr(), tiles.data_ptr())
    if err:
        raise RuntimeError(f"{SETTER[kernel]} failed: CUDA error {err}")
    got = launch(sections, kernel, call, bwd)
    torch.cuda.synchronize()
    cyc = buf.cpu().numpy()
    tiles_np = tiles.cpu().numpy()
    want = launch(main, kernel, call, bwd)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    names = SECTIONS["stream_bwd_fast" if "bwd" in kernel else "stream_fwd"]
    total = float(cyc[:len(names)].sum())
    stream_order = torch.arange(t, device=dev)
    res = {"ms": _ms(lambda: launch(main, kernel, call, bwd), reps),
           "ms_stream_order": _ms(lambda: launch(
               main, kernel, call, bwd, stream_order), reps),
           "ms_sections_build": _ms(
               lambda: launch(sections, kernel, call, bwd), reps),
           "split": {n: float(cyc[i]) / total for i, n in enumerate(names)},
           "warp_cycles": total,
           "counts": {n: int(cyc[8 + i]) for i, n in enumerate(COUNTS)},
           "tail": tail(tiles_np), "bit_equal_to_main": same}
    del got, want
    return res


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)")


def sass_loops(path: Path, dump: Path | None = None) -> dict:
    """Per kernel of :data:`MANGLED`: the innermost loop (a backward
    ``BRA``'s range) that holds a ``MUFU.EX2``, its instruction count and
    the exps in it, from ``cuobjdump -sass``; ``dump`` keeps the text."""
    text = subprocess.run([_cuobjdump(), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(text)
    funcs, name = {}, None
    pending = []
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = {"insns": [], "labels": {}}
            pending = []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            funcs[name]["insns"].append((addr, m.group(2)))
            for lab in pending:
                funcs[name]["labels"][lab] = addr
            pending = []
    out = {}
    for key, mangled in MANGLED.items():
        fn = next((v for k, v in funcs.items() if mangled in k), None)
        if fn is None:
            continue
        insns = [(a, i) for a, i in fn["insns"] if not i.startswith("NOP")]
        best = None
        for addr, ins in insns:
            m = _BRA.search(ins)
            if not m:
                continue
            tgt = m.group(1)
            tgt = (fn["labels"].get(tgt) if tgt.startswith(".L")
                   else int(tgt, 16))
            if tgt is None or tgt > addr:
                continue
            body = [i for a, i in insns if tgt <= a <= addr]
            exps = sum("MUFU.EX2" in i for i in body)
            if exps and (best is None or len(body) < best[0]):
                best = (len(body), exps, sum(i.split()[0].startswith("LDS")
                                             or " LDS" in i for i in body))
        out[key] = ({"loop_instructions": best[0], "exps": best[1],
                     "lds": best[2], "per_entry": best[0] / best[1]}
                    if best else None)
    return out


def sm_clock_mhz(busy) -> dict:
    """``nvidia-smi``'s SM clock (MHz), read while ``busy()`` keeps the card
    at work, and its maximum."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        busy()
        torch.cuda.synchronize()
    now, top = (float(v) for v in proc.stdout.read().split(","))
    return {"sm_mhz": now, "sm_max_mhz": top}


def issue_floor_ms(per_entry: float, warp_steps: int, mhz: float) -> float:
    """Instructions over (SMs × 4 per clock × the SM clock), in ms."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_entry * warp_steps / (sms * ISSUES_PER_CLOCK * mhz * 1e6) * 1e3


def occupancy(lib, tile_w: int, tile_h: int) -> dict:
    """Resident CTAs per SM and registers per thread of B1/B3f and B3b at
    ``tile_w`` × ``tile_h``, from the library's own launch configuration."""
    res = {}
    for key, fn, args in (
            ("stream_fwd", "gs_stream_fwd_occupancy", (0,)),
            ("stream_fwd_fast", "gs_stream_fwd_occupancy", (1,)),
            ("stream_bwd_fast", "gs_stream_bwd_fast_occupancy", (0,))):
        if not hasattr(lib, fn):
            continue
        ctas, regs = ctypes.c_int(0), ctypes.c_int(0)
        err = getattr(lib, fn)(*args, tile_w, tile_h, ctypes.byref(ctas),
                               ctypes.byref(regs))
        if err:
            raise RuntimeError(f"{fn} failed: CUDA error {err}")
        res[key] = {"ctas_per_sm": ctas.value, "registers": regs.value}
    return res


def _streams(n_views: int):
    """(training calls, eval calls) of the retained model's first
    ``n_views`` test views, at the training and the offline eval layout."""
    from .cli.render import (adaptive_eval_config, eval_raster_config,
                             measure_tile_needs, params_from_ply)
    from .data.cameras import camera_from_json
    from .models.gaussians import activated, get_features
    from .ops.preprocess import preprocess
    from .ops.rasterize import bin_and_pack_stream
    from .ops.render import render
    from .train.config import PipelineConfig
    from .train.loop import _instance_bucket, raster_config_from_pipe
    model = Path(__file__).resolve().parent.parent / "runs" / "specfinal" \
        / "model"
    dev = torch.device("cuda")
    with open(model / "cameras.json") as f:
        cams = sorted((camera_from_json(e) for e in json.load(f)),
                      key=lambda c: c.image_name)
    test = [c for i, c in enumerate(cams) if i % 8 == 0][:n_views]
    params = params_from_ply(str(model / "point_cloud_final.ply.gz"), 3,
                             device=dev)
    n = params.xyz.shape[0]
    train_cfg = raster_config_from_pipe(PipelineConfig(
        tile_w=32, tile_h=16, max_tiles_per_gaussian=512,
        tier_budgets=(4, 12, 64), tier_fracs=(0.25, 0.1, 0.01)))
    base = eval_raster_config(PipelineConfig(), n_gaussians=n)
    eval_cfg = adaptive_eval_config(
        base, measure_tile_needs(params, cams, base.tile_w, base.tile_h),
        log=lambda *_: None)
    bg = torch.zeros(3, device=dev)
    train, evals = [], []
    for cam in test:
        view = cam.view(dev)
        w, h = cam.width, cam.height
        with torch.no_grad():
            for cfg, dst in ((train_cfg, train), (eval_cfg, evals)):
                if dst is train:
                    probe = render(view, w, h, params, bg, sh_degree=3,
                                   raster_config=cfg)
                    cfg = cfg._replace(instance_cap=_instance_bucket(
                        int(probe["instance_load"]
                            + probe["overflow_capacity"]), n, cfg))
                    del probe
                tx, ty = -(-w // cfg.tile_w), -(-h // cfg.tile_h)
                s, r, o = activated(params)
                pre = preprocess(params.xyz, o, view, w, h, scales=s,
                                 rotations=r, shs=get_features(params),
                                 sh_degree=3, tile_w=cfg.tile_w,
                                 tile_h=cfg.tile_h)
                bins, attrs = bin_and_pack_stream(pre, tx, ty, cfg)
                dst.append((attrs, bins.seg_start, bins.counts, bg,
                            torch.arange(tx * ty, dtype=torch.int32,
                                         device=dev),
                            tx, cfg.tile_w, cfg.tile_h))
    return train, evals


def backward_inputs(main, call, seed=0):
    """(out, final_t, g_out, g_tfin) for B3b on ``call``: B3f's outputs
    from ``main`` and cotangents made from ``seed``."""
    out, tfin = launch(main, "stream_fwd_fast", call)
    rng = np.random.RandomState(seed)
    g = (rng.randn(*out.shape), rng.randn(*tfin.shape))
    return (out, tfin) + tuple(torch.from_numpy(a.astype(np.float32)).to(
        out.device) for a in g)


def profile(main, sections, main_path, train, evals, dump=None) -> dict:
    """Every stream kernel's split on the given streams (means over them:
    ``train`` at the training layout, ``evals`` at the eval layout), its
    SASS loop in the library at ``main_path``, the SM clock under load and
    the issue-rate floor."""
    sass = sass_loops(main_path, dump)
    train = [(c, backward_inputs(main, c, k)) for k, c in enumerate(train)]
    runs = {"stream_fwd": [kernel_split(main, sections, "stream_fwd", c)
                           for c in evals],
            "stream_fwd_fast": [kernel_split(main, sections,
                                             "stream_fwd_fast", c)
                                for c, _ in train],
            "stream_bwd_fast": [kernel_split(main, sections,
                                             "stream_bwd_fast", c, b)
                                for c, b in train]}
    call, b = train[0]
    clock = sm_clock_mhz(lambda: launch(main, "stream_bwd_fast", call, b))
    res = {"clock": clock}
    for key, rows in runs.items():
        res[key] = aggregate(rows, sass.get(key), clock["sm_mhz"])
    return res


def aggregate(rows, loop, mhz) -> dict:
    """One kernel's :func:`kernel_split` results over several streams
    (means), with its SASS loop (:func:`sass_loops`) and the issue-rate
    floor at ``mhz``."""
    counts = {n: int(np.mean([r["counts"][n] for r in rows])) for n in COUNTS}
    passed = counts["warp_steps"] - counts["warp_steps_culled"]
    return {
        "views": len(rows),
        "ms": float(np.mean([r["ms"] for r in rows])),
        "ms_stream_order": float(np.mean([r["ms_stream_order"]
                                          for r in rows])),
        "ms_sections_build": float(np.mean([r["ms_sections_build"]
                                            for r in rows])),
        "split": {n: float(np.mean([r["split"][n] for r in rows]))
                  for n in rows[0]["split"]},
        "counts": counts,
        "tail": {n: float(np.mean([r["tail"][n] for r in rows]))
                 for n in rows[0]["tail"]},
        "bit_equal_to_main": all(r["bit_equal_to_main"] for r in rows),
        "sass_loop": loop,
        "issue_floor_ms": (issue_floor_ms(loop["per_entry"], passed, mhz)
                           if loop else None)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=kernels.CSRC,
                    help="kernel sources carrying the section counters")
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON here (and the SASS beside it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    main_lib, sec_lib, main_path, _ = build(
        args.csrc, "libgs_" + Path(args.csrc).resolve().name)
    train, evals = _streams(args.views)
    dump = args.out.with_suffix(".sass.txt") if args.out else None
    res = {"card": smi, "csrc": str(args.csrc),
           "ptxas": {k: kernels.ptxas_report(m, main_path.with_suffix(".log"))
                     for k, m in MANGLED.items()},
           "occupancy_32x16": occupancy(main_lib, 32, 16),
           **profile(main_lib, sec_lib, main_path, train, evals, dump)}
    text = json.dumps(res)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
