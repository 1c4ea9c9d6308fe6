"""The 1080p forward+backward step's time, component by component.

Counterpart of the JAX repository's ``profile_step.py``: each stage of
``tools/bench.py``'s step timed alone on the card by CUDA events, on the
bench scene, printed as one JSON line of milliseconds by component::

    python -m mvs_gaussian_splatting_tpu_torch.tools.profile_step [--fast]
        [--workload fern|bicycle] [--iters N] [--device cpu]

Components: preprocess; the depth argsort; binning
(``bin_instances_stream``, its own argsort included); the pack (the
depth-order gather and the per-instance gather into the packed
``[16, CAP + 128]`` stream) and the pack forward+backward; the pack's
transpose alone (the CAP-row ``index_add_`` scatter into the ``[N, 16]``
table) and the depth unsort (the ``[N]``-row scatter); the composite
kernel forward (B1, or B3f with ``--fast``) and forward+backward (B2 or
B3b); the raster half forward+backward without preprocess; the full
forward and the full forward+backward. ``stages_sum_ms`` adds preprocess,
binning, the pack's forward+backward and the kernel's forward+backward,
beside the full step (the rest is preprocess's backward, the assembly and
the loss). ``--workload`` takes ``tools/train_bench.py``'s sizes; the
instance capacity is ``auto_instance_cap``'s. On the card a component's
time is the CUDA events' span of a burst of its calls, so where the host
enqueues slower than the card computes, the host's gaps count; on the CPU
the times are the host's, of the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.binning import auto_instance_cap, bin_instances_stream
from ..ops.preprocess import preprocess
from ..ops.rasterize import _gather_inst_rows, rasterize
from ..ops.stream import ROWS, composite_stream
from ..utils.transforms import normalize
from . import measure
from .bench import HEIGHT, N, WIDTH, build_scene, loss_and_grads, \
    raster_config
from .train_bench import WORKLOADS

STAGES = ("preprocess", "binning", "pack_fwd_bwd", "kernel_fwd_bwd")


def run(width: int = WIDTH, height: int = HEIGHT, n: int = N,
        fast: bool = False, iters: int = 10, device="cuda") -> dict:
    device = torch.device(device)
    cfg = raster_config(fast)
    cap = auto_instance_cap(
        n, cfg.max_tiles_per_gaussian, cfg.tile_w, cfg.tile_h,
        cfg.tier_budgets, cfg.tier_fracs)
    cfg = cfg._replace(instance_cap=cap)
    cam, arrays = build_scene(n, width, height, device=device)
    means, log_scales, quats, opac_logit, shs = arrays
    bg = torch.zeros(3, device=device)
    tiles_x, tiles_y = -(-width // cfg.tile_w), -(-height // cfg.tile_h)
    ms = {}

    def timed(name, fn):
        ms[name] = measure.event_ms(fn, iters, device)

    def pre(xyz=means):
        return preprocess(xyz, torch.sigmoid(opac_logit), cam, width, height,
                          scales=torch.exp(log_scales),
                          rotations=normalize(quats), shs=shs, sh_degree=3,
                          tile_w=cfg.tile_w, tile_h=cfg.tile_h)

    def binning(p):
        return bin_instances_stream(
            p, tiles_x, tiles_y, cfg.max_tiles_per_gaussian, cap,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            tier_budgets=cfg.tier_budgets, tier_fracs=cfg.tier_fracs)

    def pack(p, xy, bins):
        table = torch.cat([xy, p.conic, p.opacity[:, None], p.rgb,
                           xy.new_zeros((n, ROWS - 9))], dim=1)
        return _gather_inst_rows(table[bins.order.long()], bins.inst_rank,
                                 bins.inst_valid)

    def grad_of(fn, leaf):
        leaf = leaf.detach().requires_grad_(True)
        return torch.autograd.grad(fn(leaf), leaf)[0]

    with torch.no_grad():
        timed("preprocess", pre)
        p = pre()
        depth_key = torch.where(p.mask, p.depth, torch.inf)
        timed("depth_argsort",
              lambda: torch.sort(depth_key, stable=True).indices)
        timed("binning", lambda: binning(p))
        bins = binning(p)
        timed("pack", lambda: pack(p, p.xy, bins))
        attrs = pack(p, p.xy, bins)
    timed("pack_fwd_bwd",
          lambda: grad_of(lambda xy: pack(p, xy, bins).sum(), p.xy))
    rng = np.random.RandomState(9)
    wrand = torch.tensor(rng.rand(ROWS, attrs.shape[1]).astype(np.float32),
                         device=device)
    table16 = torch.tensor(rng.rand(n, ROWS).astype(np.float32),
                           device=device)
    worder = torch.tensor(rng.rand(n, ROWS).astype(np.float32),
                          device=device)
    order = bins.order.long()
    timed("pack_transpose_scatter", lambda: grad_of(
        lambda t: (_gather_inst_rows(t, bins.inst_rank, bins.inst_valid)
                   * wrand).sum(), table16))
    timed("unsort_scatter",
          lambda: grad_of(lambda t: (t[order] * worder).sum(), table16))
    tile_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32,
                            device=device)

    def kernel(a):
        return composite_stream(a, bins.seg_start, bins.counts, bg, tile_ids,
                                tiles_x, cfg.tile_w, cfg.tile_h, fast)

    with torch.no_grad():
        timed("kernel_fwd", lambda: kernel(attrs))
    timed("kernel_fwd_bwd",
          lambda: grad_of(lambda a: kernel(a)[0].mean(), attrs))
    timed("raster_fwd_bwd", lambda: grad_of(
        lambda xy: rasterize(p._replace(xy=xy), width, height, bg,
                             cfg)[0].mean(), p.xy))

    def full_fwd():
        with torch.no_grad():
            return rasterize(pre(), width, height, bg, cfg)[0].mean()

    timed("full_fwd", full_fwd)
    timed("full_fwd_bwd",
          lambda: loss_and_grads(arrays, cam, width, height, cfg, bg))
    counts = bins.counts.cpu().numpy().astype(np.int64)
    starts = bins.seg_start.cpu().numpy().astype(np.int64)
    chunks = int((((starts % 128) + counts + 127) // 128).sum())
    return {
        "metric": "step_components_ms",
        "workload": f"{width}x{height}, {n} gaussians, "
                    f"{'fast' if fast else 'exact'}",
        "device": measure.device_name(device),
        "card": measure.card() if device.type == "cuda" else None,
        "clock": ("CUDA events" if device.type == "cuda" else "host")
                 + f", mean of {iters} after a warm-up",
        "instances": int(counts.sum()),
        "window_chunks": chunks,
        "instance_cap": cap,
        "overflow_capacity": int(bins.overflow_capacity),
        "components_ms": ms,
        "stages": list(STAGES),
        "stages_sum_ms": sum(ms[k] for k in STAGES),
        "full_fwd_bwd_ms": ms["full_fwd_bwd"],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="fast-math compositing (B3f/B3b)")
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default=None,
                    help="a train_bench workload's size instead of 1080p")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    size = (WIDTH, HEIGHT, N)
    if args.workload:
        size = tuple(WORKLOADS[args.workload][k]
                     for k in ("width", "height", "n"))
    result = run(*size, fast=args.fast, iters=args.iters,
                 device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
