"""Every multi-device mode on one canonical workload, against its count of
ranks.

Counterpart of the JAX repository's ``scaling_bench.py``. The workload:
2 cameras at 256×256 and a model of capacity 8,192 with 4,096 alive; an
iteration is one full train step over both cameras (L1 + D-SSIM,
backward, Adam, statistics) — the per-camera modes (``tile_train``,
``gauss_train``) take the two cameras one after the other, the batch
modes (``camera_dp_b2``, ``grid_train_2xT``) both at once — or, for the
forward legs (``tile_stream_fwd``, ``gauss_stream_fwd``), two renders of
an 8,192-Gaussian bench scene; ``replicated_adam_tail`` is the scrub and
Adam step on a replicated state. Every train leg does the same work at
every rank count (strong scaling). Each leg records its milliseconds per
iteration on rank 0, ``overhead_vs_d1`` against its family's one-rank
time, its first loss, its overflow counters, and the collectives each
rank issues per iteration with the bytes it sends (counted by
``parallel/mesh.py``).

``--devices N`` means N ranks, one process each: gloo ranks started here
on the CPU (``--device cpu``), NCCL ranks on cards started by a launcher
(``torchrun --nproc_per_node N -m ...``); without one, a card runs the
legs at one rank::

    python -m mvs_gaussian_splatting_tpu_torch.tools.scaling_bench
        [--devices N] [--iters K] [--device cpu]

Reading the CPU numbers: the ranks share this host's cores, so a
perfectly sharded mode stays flat as D grows and ``overhead_vs_d1``
measures the replicated compute and the collectives a mode adds, not a
speedup. The legs composite with the auto instance capacity: the JAX
bench's ``instance_cap=0`` clips every instance (ROADMAP C15).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.rasterize import RasterConfig
from . import measure

W = H = 256
CAP = 8192
N_INIT = 4096
COUNTS = (1, 2, 4, 8)


def _canonical(width, height, capacity, n_init):
    return (f"2 cams x {width}x{height} x cap {capacity} ({n_init} alive), "
            "stream backend")


def _legs(world: int, device, iters: int, width: int, height: int,
          capacity: int, n_init: int) -> dict:
    """Every leg at every rank count up to ``world``; every rank of the
    group calls it. Returns rank 0's records."""
    from ..models.gaussians import init_from_pcd
    from ..ops.preprocess import preprocess
    from ..parallel.data_parallel import make_batch_train_step
    from ..parallel.gauss_stream import make_gauss_sharded_stream
    from ..parallel.gauss_train import make_gauss_train_step, shard_state
    from ..parallel.grid_train import make_grid_train_step
    from ..parallel.mesh import grid_mesh, make_mesh
    from ..parallel.tile_stream import make_tile_sharded_stream
    from ..parallel.tile_train import make_tile_train_step
    from ..train.config import OptimizationConfig
    from ..train.optim import adam_init, adam_update, group_lrs, scrub_grads
    from ..utils.transforms import normalize
    from .bench import build_scene
    from .graft_entry import _camera

    counts = [d for d in COUNTS if d <= world]
    # every mesh first, in one order on every rank
    meshes = {(axis, d): make_mesh(d, axes=(axis,))
              for axis in ("tile", "gauss", "data") for d in counts}
    for d in counts:
        if d >= 2:
            meshes[("grid", d)] = grid_mesh(2, d // 2)

    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.8, 0.8, (n_init, 3)).astype(np.float32)
    cols = rng.rand(n_init, 3).astype(np.float32)

    def fresh():
        params, aux = init_from_pcd(pts, cols, capacity, device=device)
        return params, adam_init(params), aux

    cam_a = _camera(width, height, 0.0, device)
    cam_b = _camera(width, height, 0.4, device)
    gt = torch.zeros((3, height, width), device=device) + 0.5
    gts = torch.stack([gt, gt])
    bg = torch.zeros(3, device=device)
    opt_cfg = OptimizationConfig()
    stream_cfg = RasterConfig(tile_capacity=256, max_tiles_per_gaussian=16,
                              tile_batch=16, backend="stream")
    kw = dict(width=width, height=height, sh_degree=0)
    results = {}

    def record(leg, mesh, d, make_run, baseline, **notes):
        """Times ``make_run()``'s run (→ (loss or None, overflow
        counters)) on the members of ``mesh``."""
        if not mesh.member:
            return
        run = make_run()
        first = run()
        measure.sync(device)
        before = {k: list(v) for k, v in mesh.collectives.items()}
        ms = measure.host_ms(run, iters, device, warmup=0)
        coll = {op: {"calls": (c[0] - before.get(op, [0, 0])[0]) / iters,
                     "bytes": (c[1] - before.get(op, [0, 0])[1]) / iters}
                for op, c in mesh.collectives.items()
                if c[0] > before.get(op, [0, 0])[0]}
        loss, overflow = first
        entry = {"ms": ms, "collectives_per_iteration": coll,
                 "overflow": overflow}
        if loss is not None:
            entry["loss"] = loss
        base = results.get(baseline, {}).get("by_devices", {}).get("1")
        if base is not None:
            entry["overhead_vs_d1"] = ms / base["ms"]
        results.setdefault(leg, {"by_devices": {}, **notes})
        results[leg]["by_devices"][str(d)] = entry

    def overflow_of(m):
        return {"tiles": int(m.overflow_tiles),
                "capacity": int(m.overflow_capacity)}

    def per_camera(make_step, mesh, shard=None):
        step = make_step(opt_cfg, stream_cfg, 1.0, mesh)
        states = {k: fresh() for k in ("a", "b")}
        if shard is not None:
            states = {k: shard(*s, mesh) for k, s in states.items()}

        def run():
            losses, over = [], {}
            for k, cam in (("a", cam_a), ("b", cam_b)):
                p, a, x, m = step(*states[k], cam, gt, bg, 1, False, **kw)
                states[k] = (p, a, x)
                losses.append(m.loss)
                over = overflow_of(m)
            return float(sum(losses)), over
        return run

    def batched(make_step, mesh):
        step = make_step(opt_cfg, stream_cfg, 1.0, mesh)
        state = {"s": fresh()}

        def run():
            p, a, x, m = step(*state["s"], [cam_a, cam_b], gts, bg, 1, False,
                              **kw)
            state["s"] = (p, a, x)
            return float(m.loss), overflow_of(m)
        return run

    for d in counts:
        record("tile_train", meshes[("tile", d)], d,
               lambda: per_camera(make_tile_train_step, meshes[("tile", d)]),
               "tile_train", scaling="strong (tiles of each frame)")
    for d in counts:
        record("gauss_train", meshes[("gauss", d)], d,
               lambda: per_camera(make_gauss_train_step,
                                  meshes[("gauss", d)], shard=shard_state),
               "tile_train",
               scaling=f"strong (cap {capacity} sharded over gauss axis)")
    for d in counts:
        if d >= 2:
            record("grid_train_2xT", meshes[("grid", d)], d,
                   lambda: batched(make_grid_train_step,
                                   meshes[("grid", d)]),
                   "tile_train",
                   scaling="strong (2 cams on data axis x tiles)")
    for d in (1, 2):
        if d in counts:
            record("camera_dp_b2", meshes[("data", d)], d,
                   lambda: batched(make_batch_train_step,
                                   meshes[("data", d)]),
                   "camera_dp_b2", scaling="B=2 sharded over data axis")

    cam_s, (means_s, ls_s, q_s, ol_s, shs_s) = build_scene(
        capacity, width, height, seed=2, device=device)

    def forward(make_fn, mesh, axis):
        n_dev = mesh.shape[axis]
        fn = make_fn(mesh, axis, width, height, stream_cfg, round_robin=True)
        rows = slice(None)
        if make_fn is make_gauss_sharded_stream:
            i, m = mesh.coords[axis], capacity // n_dev
            rows = slice(i * m, (i + 1) * m)

        @torch.no_grad()
        def run():
            for _ in range(2):             # 2 renders: 2 cameras' worth
                p = preprocess(means_s[rows], torch.sigmoid(ol_s[rows]),
                               cam_s, width, height,
                               scales=torch.exp(ls_s[rows]),
                               rotations=normalize(q_s[rows]),
                               shs=shs_s[rows], sh_degree=1,
                               tile_w=stream_cfg.tile_w,
                               tile_h=stream_cfg.tile_h)
                img, aux = fn(p, bg)
            return None, {"tiles": int(aux["overflow_tiles"]),
                          "capacity": int(aux["overflow_capacity"]),
                          "image_mean": float(img.mean())}
        return run

    for d in counts:
        record("tile_stream_fwd", meshes[("tile", d)], d,
               lambda: forward(make_tile_sharded_stream, meshes[("tile", d)],
                               "tile"),
               "tile_stream_fwd", scaling="forward-only, tiles sharded")
    for d in counts:
        record("gauss_stream_fwd", meshes[("gauss", d)], d,
               lambda: forward(make_gauss_sharded_stream,
                               meshes[("gauss", d)], "gauss"),
               "tile_stream_fwd",
               scaling=f"forward-only, {capacity} gaussians sharded")

    def tail(mesh):
        params, adam, aux = fresh()
        grads = type(params)(*[None if p is None else torch.ones_like(p)
                               for p in params])
        state = {"s": (params, adam)}

        @torch.no_grad()
        def run():
            p, a = state["s"]
            g, _ = scrub_grads(grads)
            lrs = group_lrs(opt_cfg, 1, 1.0, p)
            state["s"] = adam_update(g, a, p, lrs, alive=aux.alive)
            return None, {}
        return run

    for d in counts:
        record("replicated_adam_tail", meshes[("data", d)], d,
               lambda: tail(meshes[("data", d)]), "replicated_adam_tail",
               scaling="replicated update, no sharded axis")
    return results


def _rank_legs(rank: int, world: int, iters, width, height, capacity,
               n_init) -> dict:
    return _legs(world, torch.device("cpu"), iters, width, height, capacity,
                 n_init)


def run(devices: int = 8, device="cuda", iters: int = 3, width: int = W,
        height: int = H, capacity: int = CAP, n_init: int = N_INIT) -> dict:
    """The bench's JSON record. On the CPU, outside a process group, it
    starts ``devices`` gloo ranks; otherwise it runs on every rank of the
    current group (``devices`` must be its size)."""
    import torch.distributed as dist

    from ..parallel.multihost import world_size
    device = torch.device(device)
    if device.type == "cpu" and not dist.is_initialized():
        from ..parallel.multihost import spawn
        legs = spawn(_rank_legs, devices, iters, width, height, capacity,
                     n_init)[0]
        reading = ("gloo ranks sharing this host's cores: flat ms vs D = "
                   "perfectly sharded; overhead_vs_d1 = replicated compute "
                   "+ collectives the mode adds, not a speedup")
    else:
        if devices != world_size():
            raise ValueError(f"--devices {devices} on {device.type} needs a "
                             f"process group of {devices} ranks (one per "
                             f"card, e.g. torchrun); this one has "
                             f"{world_size()}")
        legs = _legs(devices, device, iters, width, height, capacity, n_init)
        reading = (f"{devices} rank(s), one card each, NCCL"
                   if devices > 1 else "one rank on one card: every "
                   "collective is the identity")
    return {
        "metric": "canonical_workload_scaling",
        "workload": _canonical(width, height, capacity, n_init),
        "iteration_definition": "one full train step over BOTH cameras "
                                "(batch modes: B=2 at once; per-camera "
                                "modes: 2 sequential steps); forward legs: "
                                "2 renders",
        "reading": reading,
        "legs": legs,
        "device": measure.device_name(device),
        "card": measure.card() if device.type == "cuda" else None,
        "devices": devices,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: 8 on the CPU, the launcher's "
                         "world size on cards)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from ..parallel import multihost
    multihost.initialize()
    device = (multihost.device() if args.device == "cuda"
              else torch.device(args.device))
    devices = args.devices or (multihost.world_size()
                               if device.type == "cuda" else 8)
    result = run(devices, device, args.iters)
    if multihost.rank() == 0:
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
