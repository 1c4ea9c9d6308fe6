"""Full training steps at the reference's workloads, on one card.

Counterpart of the JAX repository's ``train_bench.py``: the port's whole
step (``train/step.py``: render, L1 + D-SSIM, backward to every
parameter, Adam, the densification statistics) at a late-training point
count, printed as one JSON line::

    python -m mvs_gaussian_splatting_tpu_torch.tools.train_bench
        [--workload fern|bicycle] [--exact] [--visible_frac F]
        [--visible_cap] [--iters N] [--device cpu]

The workloads are the reference's (``WORKLOADS``): LLFF fern at r = 4
(504×378, 250,000 Gaussians), whose reference run trains at about 35
it/s late in training on one Ampere GPU, and MipNeRF-360 bicycle at r = 4
(1237×822, 500,000 Gaussians assumed), about 10-19 it/s there; those
rates are the reference's, on its hardware, and ``vs_baseline`` divides
by them. The scene is ``tools/bench.py``'s synthetic cloud.

The instance capacity, the visible cap (``--visible_cap``) and the tier
fractions are calibrated from the first step's measured load, as the
training loop's buckets do, and dropped again if the calibrated layout
clips more than the first step did. The timed window is a burst of
``--iters`` chained steps ending in a device synchronise (the loss read).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.gaussians import GaussianAux, GaussianParams
from ..train.config import OptimizationConfig
from ..train.optim import adam_init
from ..train.step import make_train_step
from . import measure
from .bench import build_scene, load_cap, raster_config

WORKLOADS = {
    "fern": dict(width=504, height=378, n=250_000, base=35.0,
                 base_note="reference ~35 it/s late-training, 1x Ampere "
                           "(slurm-36838919.out)"),
    "bicycle": dict(width=1237, height=822, n=500_000, base=15.0,
                    base_note="reference ~10-19 it/s, 1x Ampere "
                              "(slurm-37710266.out); 500K assumed "
                              "late-training count"),
}
STEP = 20_000             # the iteration the learning rates are taken at
SPATIAL_LR_SCALE = 4.4
PROFILE_STEPS = 3


def setup(width: int, height: int, n: int, visible_frac: float = 1.0,
          device="cuda"):
    """(camera, params, adam, aux, gt, bg) of the bench scene; with
    ``visible_frac`` < 1 the cloud's tail is moved behind the camera, as a
    360° capture's out-of-frustum points are."""
    cam, (means, log_scales, quats, opac_logit, shs) = build_scene(
        n, width, height, device=device)
    if visible_frac < 1.0:
        rng = np.random.RandomState(7)
        out = rng.choice(n, int(n * (1.0 - visible_frac)), replace=False)
        out = torch.as_tensor(out, device=means.device)
        means = means.clone()
        means[out, 2] = -means[out, 2].abs() - 1.0
    params = GaussianParams(xyz=means, f_dc=shs[:, :1].contiguous(),
                            f_rest=shs[:, 1:].contiguous(),
                            scaling=log_scales, rotation=quats,
                            opacity=opac_logit[:, None].contiguous())
    zeros = torch.zeros((n,), device=means.device)
    aux = GaussianAux(alive=torch.ones((n,), dtype=torch.bool,
                                       device=means.device),
                      max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
                      denom=zeros.clone())
    gt = torch.tensor(np.random.RandomState(1).rand(3, height, width)
                      .astype(np.float32), device=means.device)
    return (cam, params, adam_init(params), aux, gt,
            torch.zeros(3, device=means.device))


def calibration(m, n: int, visible_cap: bool):
    """(instance_cap, visible_cap, tier_fracs) from a step's metrics: the
    load plus 12 % (CHUNK-aligned), the visible count plus 15 %, and each
    tier's measured demand plus 15 % of the rows binning sees."""
    vis_cap = 0
    if visible_cap:
        vis_cap = int(int(m.mask_visible) * 1.15)
        if vis_cap >= n:
            vis_cap = 0
    counts = [int(c) for c in m.tier_need_counts.cpu()]
    rows = vis_cap if vis_cap else n
    fracs = tuple(min(1.0, 1.15 * c / rows) for c in counts)
    return load_cap(int(m.instance_load)), vis_cap, fracs


def run(workload: str = "fern", exact: bool = False,
        visible_frac: float = 1.0, visible_cap: bool = False,
        iters: int = 20, device="cuda", width: int = 0, height: int = 0,
        n: int = 0) -> dict:
    """The bench's JSON record. ``width``/``height``/``n`` (0: the
    workload's) shrink it for tests."""
    device = torch.device(device)
    wl = WORKLOADS[workload]
    width, height, n = (width or wl["width"], height or wl["height"],
                        n or wl["n"])
    cfg = raster_config(fast=not exact)
    cam, params, adam, aux, gt, bg = setup(width, height, n, visible_frac,
                                           device)
    step_fn = make_train_step(OptimizationConfig(), cfg, SPATIAL_LR_SCALE)
    state = {"s": (params, adam, aux)}
    layout = {"instance_cap": 0, "visible_cap": 0, "tier_fracs": ()}

    def step():
        p, a, x = state["s"]
        p, a, x, m = step_fn(p, a, x, cam, gt, bg, STEP, True, width=width,
                             height=height, sh_degree=3, **layout)
        state["s"] = (p, a, x)
        return m

    measure.reset_peak(device)
    m0 = step()
    first_loss = float(m0.loss)
    base_tiles = int(m0.overflow_tiles)
    inst_cap, vis_cap, fracs = calibration(m0, n, visible_cap)
    layout.update(instance_cap=inst_cap, visible_cap=vis_cap,
                  tier_fracs=fracs)
    for _ in range(2):
        m = step()
    # overflow_tiles drifts a few counts as Adam moves splats across tier
    # thresholds: only a material rise counts as clipping by calibration
    tol = base_tiles + max(256, base_tiles // 10)
    if (int(m.overflow_capacity) or int(m.overflow_visible)
            or int(m.overflow_tiles) > tol):
        layout.update(instance_cap=0, visible_cap=0, tier_fracs=())
        for _ in range(2):
            m = step()
    ms = measure.host_ms(step, iters, device, warmup=0)
    prof = measure.busy(step, PROFILE_STEPS, device)
    m = step()
    it_s = 1e3 / ms
    where = "card" if device.type == "cuda" else "cpu"
    return {
        "metric": f"{workload}_r4_train_it_s",
        "value": it_s,
        "unit": (f"full train steps/s ({width}x{height}, {n // 1000}K "
                 f"gaussians, 1 {where})"),
        "vs_baseline": it_s / wl["base"],
        "extra": {
            "ms_per_step": ms,
            "timing": f"host clock, {iters} chained steps ending in a "
                      "synchronise",
            "device_ms_per_step": prof["device_ms_per_step"],
            "busy_share": prof["busy_share"],
            "backend": "stream" + ("" if exact else "+fast"),
            "device": measure.device_name(device),
            "card": measure.card() if device.type == "cuda" else None,
            "baseline": wl["base_note"],
            "visible_frac": visible_frac,
            "visible_cap": layout["visible_cap"],
            "instance_cap": layout["instance_cap"],
            "tier_fracs": list(layout["tier_fracs"]),
            "mask_visible": int(m.mask_visible),
            "overflow_visible": int(m.overflow_visible),
            "overflow_capacity": int(m.overflow_capacity),
            "overflow_tiles": int(m.overflow_tiles),
            "overflow_tiles_first_step": base_tiles,
            "instance_load": int(m.instance_load),
            "nonfinite_grad_rows": int(m.nonfinite_grad_rows),
            "loss_first": first_loss,
            "loss_last": float(m.loss),
            "finite": bool(all(torch.isfinite(t).all()
                               for t in state["s"][0] if t is not None)),
            "max_memory_allocated": measure.peak_memory(device),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--exact", action="store_true",
                    help="exact compositing (fast math is the training "
                         "default)")
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="fern")
    ap.add_argument("--visible_frac", type=float, default=1.0,
                    help="fraction of the cloud inside the camera's "
                         "frustum (a 360° capture sits at ~0.4-0.7 for "
                         "any one camera); 1.0 keeps all of it visible")
    ap.add_argument("--visible_cap", action="store_true",
                    help="visible-prefix compaction (RasterConfig."
                         "visible_cap) calibrated from the measured "
                         "visible count")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    result = run(args.workload, args.exact, args.visible_frac,
                 args.visible_cap, args.iters, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
