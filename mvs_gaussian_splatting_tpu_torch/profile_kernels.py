"""Where the composite kernels' time goes, on the card: the split of B1's,
B3f's, B3b's, B2's, B4's and B5's time by section, their event counts, the
tail of the last wave, the instructions of the loop that holds the exp, and
the issue-rate floor those give.

    python -m mvs_gaussian_splatting_tpu_torch.profile_kernels \\
        [--csrc DIR] [--baseline DIR ...] [--kernels K,...] [--views N] \\
        [--out FILE]

Builds ``csrc/*.cu`` twice, with and without ``-DGS_SECTION_CLOCKS``
(``csrc/sections.cuh``: per-warp ``clock64()`` cycles by section, per-warp
event counts, each CTA's start and end ``%globaltimer``), into libraries of
their own beside the real one, and runs each kernel on the retained
``runs/specfinal`` model's streams: B3f, B3b and B2 (given B1's outputs) on
the flagship's training layout (32×16 tiles, 512 tiles per Gaussian, tiers
(4, 12, 64) at (0.25, 0.1, 0.01)), B4 and B5 on padded tables holding the
same tiles' entries (K the longest segment, rounded up to 32), B1 on the
offline eval layout (16×16) and, where B4 runs too, on the training streams
(``stream_fwd_on_train``: the entries B4 walks). ``chip_smoke.py`` calls
:func:`kernel_split` on its own streams. Needs a card; the section library
is a measuring build only, never the one the port runs.

``--csrc`` points it at another tree's kernels with the same entry points;
``--baseline`` names a further tree (repeatable), profiled in turns with
it on the same streams in one process (the baselines, csrc, then back in
reverse): an A/B, or an ablation, inside one call; each tree's libraries
are named after the two directories above its ``csrc``. ``--kernels``
profiles a subset; ``--tile WxH`` another training tile (64x32: two parts
a tile). An older tree is run with its own signatures and kernel
names (:data:`LEGACY`, :data:`MANGLED`): one from before B4's redesign
(2a469fe and earlier) has a B4 that takes no tile order; one from before the
exact backwards' redesign (ab6b601 and earlier) also B2 and B5 that take
none and carry no section counters (times and SASS loop, no split).
Against the parent commit, from the checkout's root (``build/`` is
gitignored and reaches the card)::

    mkdir -p build/parent
    git archive <parent> mvs_gaussian_splatting_tpu_torch/csrc \\
        | tar -x -C build/parent
    python -m mvs_gaussian_splatting_tpu_torch.profile_kernels \\
        --baseline build/parent/mvs_gaussian_splatting_tpu_torch/csrc \\
        --out chiprun_out/ab.json

Times: ``ms`` is the kernel alone (CUDA events over 5 launches into
buffers of an earlier launch); ``wrapper_ms`` (backward kernels) adds what
its tree's wrapper does around it: the output allocated and zero-filled
(B5 since its redesign writes every slot itself: allocated only) and the
``g_bg`` reduction.

Sections: the forward's (B1, B3f, B4) ``stage`` (the batch's loads, cull
boxes and stores), ``composite`` (the loop over the batch), ``epilogue``
(the output writes) and ``wait_batch`` (the barrier that opens each
batch); the fast backward's ``stage``, ``replay`` (B3f's walk, dpower and
w), ``mma`` (the transposes through shared memory and the TF32 products),
``cross_warp`` (the sum over the tile's warps), ``closed_form`` (the
per-entry gradients written) and its three barriers' waits:
``wait_batch`` (opening a batch), ``wait_groups`` (after the products) and
``wait_sum`` (after the sum); the exact backward's (B2, B5) ``stage``,
``replay`` (the cull test and each pixel's alpha and T where the cull
passes), ``gradient`` (each pixel's gradient, the butterfly sum over the
warp and its store, and the culled warp-steps), ``cross_warp`` (the sum
over the tile's warps and the writes), ``wait_batch`` and ``wait_sum``.
A warp waiting at a barrier is idle while the other CTAs on its SM may
issue. Counts, per warp: the warp-steps (one entry against one
warp with a live lane), those with a contributing (forward) or included
(backward) lane, the live (entry, pixel) pairs, the warp-steps the cull
skipped, and the contributing (entry, pixel) pairs (α ≥ 1/255).

The issue-rate floor: the SASS instructions of the innermost loop that
holds the exp's ``MUFU.EX2``, per exp (``cuobjdump -sass``), times the
warp-steps the cull let through, over (SMs × 4 issues per clock × the SM
clock ``nvidia-smi`` reads under load). It leaves out the culled
warp-steps' few instructions and, for B3b, the products and sums; for B2
and B5 the loop holds the gradient and the warp's sum too, which a
warp-step with no included lane skips.
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

_FWD = ("stage", "composite", "epilogue", "wait_batch")
SECTIONS = {
    "stream_fwd": _FWD, "stream_fwd_fast": _FWD, "padded_fwd": _FWD,
    "stream_bwd_fast": ("stage", "replay", "mma", "cross_warp",
                        "closed_form", "wait_batch", "wait_groups",
                        "wait_sum"),
    "stream_bwd": ("stage", "replay", "gradient", "cross_warp",
                   "wait_batch", "wait_sum"),
}
SECTIONS["padded_bwd"] = SECTIONS["stream_bwd"]
COUNTS = ("warp_steps", "warp_steps_contributing", "lane_pairs",
          "warp_steps_culled", "pairs_contributing")
ENTRY = {"stream_fwd": "gs_stream_fwd",
         "stream_fwd_fast": "gs_stream_fwd_fast",
         "stream_bwd_fast": "gs_stream_bwd_fast",
         "stream_bwd": "gs_stream_bwd",
         "padded_fwd": "gs_padded_fwd",
         "padded_bwd": "gs_padded_bwd"}
SETTER = {"stream_fwd": "gs_stream_fwd_sections",
          "stream_fwd_fast": "gs_stream_fwd_sections",
          "stream_bwd_fast": "gs_stream_bwd_fast_sections",
          "stream_bwd": "gs_stream_bwd_sections",
          "padded_fwd": "gs_padded_fwd_sections",
          "padded_bwd": "gs_padded_bwd_sections"}
# substrings of each kernel's mangled name, the one-part instantiation (the
# main path's) of this tree first, then those of older trees: before the
# forward body was shared (2a469fe and earlier) and before the exact
# backwards' redesign (ab6b601 and earlier)
MANGLED = {"stream_fwd": ("fwd_kernelIN2gs11StreamSlotsELb0ELb0E",
                          "stream_fwd_kernelILb0E"),
           "stream_fwd_fast": ("fwd_kernelIN2gs11StreamSlotsELb1ELb0E",
                               "stream_fwd_kernelILb1E"),
           "stream_bwd_fast": ("stream_bwd_fast_kernelILb0E",
                               "22stream_bwd_fast_kernelE"),
           "stream_bwd": ("15StreamGradSlotsELb0E",
                          "exact_bwd_kernelINS_11StreamSlots",
                          "17stream_bwd_kernel"),
           "padded_fwd": ("fwd_kernelIN2gs11PaddedSlotsELb0ELb0E",
                          "17padded_fwd_kernel"),
           "padded_bwd": ("15PaddedGradSlotsELb0E",
                          "exact_bwd_kernelINS_11PaddedSlots",
                          "17padded_bwd_kernel")}


def parts_mangled(kernel: str) -> str:
    """The multi-part instantiation's name substring (its last template
    flag set) of ``kernel`` in this tree."""
    name = MANGLED[kernel][0]
    at = name.rindex("Lb0E")
    return name[:at] + "Lb1E" + name[at + 4:]


# (entry point, its first argument) of each kernel's occupancy report
OCCUPANCY = {"stream_fwd": ("gs_stream_fwd_occupancy", 0),
             "stream_fwd_fast": ("gs_stream_fwd_occupancy", 1),
             "stream_bwd_fast": ("gs_stream_bwd_fast_occupancy", 0),
             "stream_bwd": ("gs_stream_bwd_occupancy", 0),
             "padded_fwd": ("gs_padded_fwd_occupancy", 0),
             "padded_bwd": ("gs_padded_bwd_occupancy", 0)}
# Kernels as an older tree builds them, for the A/B against it; such a tree
# lacks their occupancy reports (:func:`legacy`). B4 before its redesign
# (2a469fe and earlier) takes no tile order; B2 and B5 before theirs
# (ab6b601 and earlier) take none either and leave the slots they do not
# visit to a zero-filled output. Their ``argtypes`` are here; their names
# in :data:`MANGLED`.
_P, _I = ctypes.c_void_p, ctypes.c_int
LEGACY = {"stream_bwd": {"argtypes": [_P, ctypes.c_longlong] + [_P] * 8
                         + [_I] * 4 + [_P]},
          "padded_fwd": {"argtypes": [_P] * 7 + [_I] * 5 + [_P]},
          "padded_bwd": {"argtypes": [_P] * 10 + [_I] * 5 + [_P]}}
# backward kernels that write every slot of their output themselves, so
# their wrapper allocates it unfilled
WRITES_EVERY_SLOT = ("padded_bwd",)
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


def legacy(lib, kernel: str):
    """``kernel``'s :data:`LEGACY` record where ``lib`` is a tree from
    before that kernel's redesign, else None."""
    if kernel in LEGACY and not hasattr(lib, OCCUPANCY[kernel][0]):
        return LEGACY[kernel]
    return None


def _ptrs(tensors):
    return tuple(a.data_ptr() for a in tensors)


def launch(lib, kernel: str, call, bwd=None, order=None, into=None):
    """One launch of ``kernel`` from ``lib`` on ``call``: a stream (attrs,
    seg_start, counts, bg, tile_ids, tiles_x, tile_w, tile_h), or for B4 and
    B5 padded tables (planes, rgb, valid, counts, bg, tiles_x, tile_w,
    tile_h); ``bwd`` = (out, final_t, g_out, g_tfin) for a backward;
    ``order`` the tile order (int64; by default heaviest first, as the
    wrappers pass it); ``into`` the outputs of an earlier launch on the same
    call, written again (a backward's own outputs start zeroed). Returns its
    outputs."""
    from .ops.stream import heaviest_first
    if kernel.startswith("padded"):
        planes, rgb, valid, counts, bg, tiles_x, tile_w, tile_h = call
        t, k_cap = valid.shape
        lead = _ptrs((planes, rgb, valid, counts))
        dims = (t, k_cap, tiles_x, tile_w, tile_h)
        grads = (planes, rgb)
    else:
        attrs, seg_start, counts, bg, tile_ids, tiles_x, tile_w, tile_h = call
        t = seg_start.shape[0]
        lead = (attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
                counts.data_ptr(), tile_ids.data_ptr())
        dims = (t, tiles_x, tile_w, tile_h)
        grads = (attrs,)
    fn = getattr(lib, ENTRY[kernel])
    old = legacy(lib, kernel)
    if old:
        fn.argtypes = old["argtypes"]
    elif order is None:
        # held until the launch: freed earlier, its block could be handed
        # to the outputs below and zero-filled before the kernel reads it
        order = heaviest_first(counts)
    ordered = () if old else (order.data_ptr(),)
    stream = torch.cuda.current_stream().cuda_stream
    if bwd is None:
        p = tile_w * tile_h
        res = into or (torch.empty((t, p, 3), device=bg.device),
                       torch.empty((t, p), device=bg.device))
        err = fn(*lead, *ordered, bg.data_ptr(), *_ptrs(res), *dims, stream)
    else:
        res = into or tuple(torch.zeros_like(a) for a in grads)
        err = fn(*lead, *ordered, *_ptrs(bwd), *_ptrs(res), *dims, stream)
    if err:
        raise RuntimeError(f"{ENTRY[kernel]} launch failed: CUDA error {err}")
    return res


def wrapped(lib, kernel: str, call, bwd):
    """A backward kernel with what its tree's wrapper does around it: the
    outputs allocated, zero-filled unless the kernel writes every slot
    itself (:data:`WRITES_EVERY_SLOT`), and g_bg = Σ g_out·final_T."""
    alloc = (torch.empty_like if kernel in WRITES_EVERY_SLOT
             and not legacy(lib, kernel) else torch.zeros_like)
    outs = call[:2] if kernel.startswith("padded") else call[:1]
    into = tuple(alloc(a) for a in outs)
    torch.einsum("tpc,tp->c", bwd[2], bwd[1])
    return launch(lib, kernel, call, bwd, into=into)


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
    stream or set of tables: its time alone (and for a backward through its
    wrapper's work), in stream order where it takes an order, and where
    ``sections`` has the kernel's counters the section split (share of the
    warps' cycles), the counts, the tail, and whether the two builds agree
    to the bit."""
    dev = call[0].device
    t = call[3].shape[0] if kernel.startswith("padded") else call[1].shape[0]
    want = launch(main, kernel, call, bwd)
    res = {"ms": _ms(lambda: launch(main, kernel, call, bwd, into=want),
                     reps)}
    if bwd is not None:
        res["wrapper_ms"] = _ms(lambda: wrapped(main, kernel, call, bwd),
                                reps)
    if not legacy(main, kernel):
        stream_order = torch.arange(t, device=dev)
        res["ms_stream_order"] = _ms(lambda: launch(
            main, kernel, call, bwd, stream_order, into=want), reps)
    if not hasattr(sections, SETTER[kernel]):
        return res
    buf = torch.zeros(16, dtype=torch.int64, device=dev)
    tiles = torch.zeros((t, 2), dtype=torch.int64, device=dev)
    err = getattr(sections, SETTER[kernel])(buf.data_ptr(), tiles.data_ptr())
    if err:
        raise RuntimeError(f"{SETTER[kernel]} failed: CUDA error {err}")
    got = launch(sections, kernel, call, bwd)
    torch.cuda.synchronize()
    cyc = buf.cpu().numpy()
    names = SECTIONS[kernel]
    total = float(cyc[:len(names)].sum())
    res.update(
        ms_sections_build=_ms(lambda: launch(sections, kernel, call, bwd,
                                             into=got), reps),
        split={n: float(cyc[i]) / total for i, n in enumerate(names)},
        warp_cycles=total,
        counts={n: int(cyc[8 + i]) for i, n in enumerate(COUNTS)},
        tail=tail(tiles.cpu().numpy()),
        bit_equal_to_main=all(bool(torch.equal(a, b))
                              for a, b in zip(got, want)))
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
    for key, names in MANGLED.items():
        fn = next((v for name in names for k, v in funcs.items()
                   if name in k), None)
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
                                             or " LDS" in i for i in body),
                        sum("SHFL" in i for i in body))
        out[key] = ({"loop_instructions": best[0], "exps": best[1],
                     "lds": best[2], "shfl": best[3],
                     "per_entry": best[0] / best[1]}
                    if best else None)
    return out


def ptxas(log: Path) -> dict:
    """Each kernel's ``-Xptxas -v`` lines (registers, spills) in ``log``:
    the one-part instantiation's under its name, the multi-part one's (this
    tree only) under ``<name>_parts``."""
    res = {}
    for key, names in MANGLED.items():
        for name in names:
            lines = kernels.ptxas_report(name, log)
            if lines:
                res[key] = lines
                break
        lines = kernels.ptxas_report(parts_mangled(key), log)
        if lines:
            res[f"{key}_parts"] = lines
    return res


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


def tile_warps(tile_w: int, tile_h: int, max_side: int = 1024) -> int:
    """Warps of a tile's CTA: one per 8×4 pixel block of its (largest) part,
    or per 32 pixels in row order where the blocks would need more than
    1,024 threads (``csrc/stream_common.cuh:tile_threads``, ``tile_parts``;
    ``max_side`` as :func:`ops.stream.tile_parts` takes it)."""
    from .ops.stream import tile_parts
    w, h, _, _ = tile_parts(tile_w, tile_h, max_side)
    blocks = -(-w // 8) * -(-h // 4)
    return blocks if blocks * 32 <= 1024 else -(-(w * h) // 32)


def occupancy(lib, tile_w: int, tile_h: int) -> dict:
    """Resident CTAs per SM, registers per thread and resident warps per SM
    of each kernel with an occupancy report at ``tile_w`` × ``tile_h`` (the
    instantiation that shape runs, one part or parts), from the library's
    own launch configuration."""
    from .ops.stream import FAST_BWD_SIDE
    res = {}
    for key, (fn, mode) in OCCUPANCY.items():
        if not hasattr(lib, fn):
            continue
        ctas, regs = ctypes.c_int(0), ctypes.c_int(0)
        err = getattr(lib, fn)(mode, tile_w, tile_h, ctypes.byref(ctas),
                               ctypes.byref(regs))
        if err:
            raise RuntimeError(f"{fn} failed: CUDA error {err}")
        side = FAST_BWD_SIDE if key == "stream_bwd_fast" else 1024
        res[key] = {"ctas_per_sm": ctas.value, "registers": regs.value,
                    "warps_per_sm": ctas.value * tile_warps(tile_w, tile_h,
                                                            side)}
    return res


def tables_from_stream(call):
    """Padded tables holding a stream's segments (tile t's entries in slots
    [0, counts[t]) of row t, K the longest segment rounded up to 32, every
    slot below counts valid): B4 and B5 then walk the entries B1 and B2
    walk. The stream's tile t must be the image's tile t."""
    attrs, seg_start, counts, bg, _, tiles_x, tile_w, tile_h = call
    k = int(counts.max())
    k += (-k) % 32
    slot = torch.arange(k, device=attrs.device)
    live = slot[None, :] < counts.long()[:, None]                 # [T, K]
    cols = torch.where(live, seg_start.long()[:, None] + slot, 0)
    rows = torch.where(live[None], attrs[:9, cols], 0.0)           # [9, T, K]
    return (rows[:6].contiguous(), rows[6:9].permute(1, 2, 0).contiguous(),
            live.to(torch.float32), counts, bg, tiles_x, tile_w, tile_h)


def _streams(n_views: int, tile_w: int = 32, tile_h: int = 16):
    """(training calls, eval calls) of the retained model's first
    ``n_views`` test views, at the training layout (``tile_w`` ×
    ``tile_h`` tiles) and the offline eval layout."""
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
        tile_w=tile_w, tile_h=tile_h, max_tiles_per_gaussian=512,
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


def backward_inputs(main, call, seed=0, forward="stream_fwd_fast"):
    """(out, final_t, g_out, g_tfin) for a backward on ``call``: the outputs
    of ``forward`` from ``main`` (B3f for B3b, B1 for B2, B4 for B5) and
    cotangents made from ``seed``."""
    out, tfin = launch(main, forward, call)
    rng = np.random.RandomState(seed)
    g = (rng.randn(*out.shape), rng.randn(*tfin.shape))
    return (out, tfin) + tuple(torch.from_numpy(a.astype(np.float32)).to(
        out.device) for a in g)


def profile(main, sections, main_path, train, evals, dump=None,
            only=tuple(ENTRY)) -> dict:
    """The split of each composite kernel in ``only`` on the given streams
    (means over them: ``train`` at the training layout, ``evals`` at the
    eval layout), its SASS loop in the library at ``main_path``, the SM
    clock under load and the issue-rate floor."""
    sass = sass_loops(main_path, dump)
    runs = {key: [] for key in only}
    for c in evals if "stream_fwd" in only else ():
        runs["stream_fwd"].append(kernel_split(main, sections, "stream_fwd",
                                               c))
    for k, c in enumerate(train):
        if {"stream_fwd", "padded_fwd"} <= set(only):
            runs.setdefault("stream_fwd_on_train", []).append(kernel_split(
                main, sections, "stream_fwd", c))
        if "stream_fwd_fast" in only:
            runs["stream_fwd_fast"].append(kernel_split(
                main, sections, "stream_fwd_fast", c))
        if "stream_bwd_fast" in only:
            runs["stream_bwd_fast"].append(kernel_split(
                main, sections, "stream_bwd_fast", c,
                backward_inputs(main, c, k)))
        if "stream_bwd" in only:
            runs["stream_bwd"].append(kernel_split(
                main, sections, "stream_bwd", c,
                backward_inputs(main, c, k, "stream_fwd")))
        if {"padded_fwd", "padded_bwd"} & set(only):
            tables = tables_from_stream(c)
            if "padded_fwd" in only:
                runs["padded_fwd"].append(kernel_split(
                    main, sections, "padded_fwd", tables))
            if "padded_bwd" in only:
                runs["padded_bwd"].append(kernel_split(
                    main, sections, "padded_bwd", tables,
                    backward_inputs(main, tables, k, "padded_fwd")))
            del tables
    call = train[0]
    b = backward_inputs(main, call)
    clock = sm_clock_mhz(lambda: launch(main, "stream_bwd_fast", call, b))
    res = {"clock": clock}
    for key, rows in runs.items():
        res[key] = aggregate(rows, sass.get(key.split("_on_")[0]),
                             clock["sm_mhz"])
    return res


def aggregate(rows, loop, mhz) -> dict:
    """One kernel's :func:`kernel_split` results over several streams
    (means), with its SASS loop (:func:`sass_loops`) and, where the rows
    carry counts, the issue-rate floor at ``mhz``."""
    res = {"views": len(rows), "sass_loop": loop}
    for key in ("ms", "wrapper_ms", "ms_stream_order", "ms_sections_build"):
        if key in rows[0]:
            res[key] = float(np.mean([r[key] for r in rows]))
    if "counts" not in rows[0]:
        return res
    counts = {n: int(np.mean([r["counts"][n] for r in rows])) for n in COUNTS}
    passed = counts["warp_steps"] - counts["warp_steps_culled"]
    res.update(
        split={n: float(np.mean([r["split"][n] for r in rows]))
               for n in rows[0]["split"]},
        counts=counts,
        tail={n: float(np.mean([r["tail"][n] for r in rows]))
              for n in rows[0]["tail"]},
        bit_equal_to_main=all(r["bit_equal_to_main"] for r in rows),
        issue_floor_ms=(issue_floor_ms(loop["per_entry"], passed, mhz)
                        if loop else None))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=kernels.CSRC,
                    help="kernel sources carrying the section counters")
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="another tree's kernel sources, profiled in turns "
                         "with --csrc on the same streams (repeatable: one "
                         "pass over all trees, then one back)")
    ap.add_argument("--kernels", default=",".join(ENTRY),
                    help="comma-separated kernels to profile (default all: "
                         + ", ".join(ENTRY) + ")")
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--tile", default="32x16",
                    help="the training layout's tile, WxH (default the "
                         "flagship's 32x16; a tile of more than 1,024 "
                         "pixels runs the kernels' parts)")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON here (and the SASS beside it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = [*args.baseline, args.csrc]
    if args.baseline:
        trees += trees[::-1]
    libs = {}
    for csrc in trees:
        if csrc not in libs:   # named by the tree's two parent directories
            tag = "_".join(Path(csrc).resolve().parts[-3:-1])
            libs[csrc] = (tag,) + build(csrc, "libgs_" + tag)
    unknown = set(args.kernels.split(",")) - set(ENTRY)
    if unknown:
        raise SystemExit(f"unknown kernels {sorted(unknown)}")
    tile = tuple(int(v) for v in args.tile.split("x"))
    shapes = sorted({(16, 16), (32, 16), tile})
    train, evals = _streams(args.views, *tile)
    runs = []
    for csrc in trees:
        tag, main_lib, sec_lib, main_path, _ = libs[csrc]
        dump = (args.out.with_name(f"{args.out.stem}_{tag}.sass.txt")
                if args.out else None)
        runs.append({"csrc": str(csrc),
                     "ptxas": ptxas(main_path.with_suffix(".log")),
                     "occupancy": {f"{tw}x{th}": occupancy(main_lib, tw, th)
                                   for tw, th in shapes},
                     **profile(main_lib, sec_lib, main_path, train, evals,
                               dump, tuple(args.kernels.split(",")))})
    text = json.dumps({"card": smi, "runs": runs})
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
