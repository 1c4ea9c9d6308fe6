"""Gaussian-sharded training chained into compression and the exact
offline render, as one pipeline.

Counterpart of the JAX repository's
``scripts/sharded_compress_pipeline.py``: train a synthetic scene with the
Gaussian-sharded train step (``parallel/gauss_train.py``) over N ranks,
save the model through the PLY path, compress it with ``cli/compress.py``'s
codebook quantizer, render both models offline with the exact operator
(B1 on a card), and record the fidelity delta and the size ratio::

    python -m mvs_gaussian_splatting_tpu_torch.tools.sharded_compress_pipeline
        [--out runs/torch_shardcompress] [--devices N] [--iters K]
        [--capacity C] [--num_codes K] [--device cpu]

On the CPU, N gloo ranks are started here; on cards the ranks come from a
launcher (``torchrun``), one per card, or the pipeline runs at one rank.
Writes ``<out>/point_cloud/iteration_<K>/`` and ``<out>/results.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from ..ops.rasterize import RasterConfig
from . import measure

ATTRIBUTES = ("f_rest", "scaling", "rotation")
INSTANCE_CAP = 1 << 15     # each rank's instance slots in training


def _pipeline(out_dir: str, n_dev: int, width: int, height: int,
              capacity: int, iters: int, num_codes: int, device, log):
    """The pipeline on every rank of the group; rank 0 returns the
    result, the others None."""
    from ..cli.compress import compress, decompress
    from ..cli.render import params_from_ply
    from ..models.gaussians import compact, init_from_pcd
    from ..models.ply import save_gaussian_ply
    from ..ops.render import render
    from ..parallel.gauss_train import (gather_state, make_gauss_train_step,
                                        shard_state)
    from ..parallel.mesh import make_mesh
    from ..train.config import OptimizationConfig
    from ..train.optim import adam_init
    from ..utils.losses import psnr, ssim
    from .graft_entry import _camera

    mesh = make_mesh(n_dev, axes=("gauss",))
    if not mesh.member:
        return None
    rng = np.random.RandomState(0)
    # ground truth: a blobby soup rendered by the exact renderer
    n_true = capacity // 2
    true_xyz = rng.uniform(-1.0, 1.0, (n_true, 3)).astype(np.float32)
    true_rgb = rng.rand(n_true, 3).astype(np.float32)
    true_params, true_aux = init_from_pcd(true_xyz, true_rgb, n_true,
                                          device=device)
    eval_cfg = RasterConfig(backend="stream", tile_capacity=512,
                            max_tiles_per_gaussian=64)
    bg = torch.zeros(3, device=device)

    @torch.no_grad()
    def rp(params, alive, cam):
        out = render(cam, width, height, params, bg, sh_degree=0,
                     alive=alive, raster_config=eval_cfg)
        return torch.clamp(out["render"], 0.0, 1.0)

    train_cams = [_camera(width, height, 2 * math.pi * i / 10, device)
                  for i in range(10)]
    test_cams = [_camera(width, height, 2 * math.pi * (i + 0.5) / 4, device)
                 for i in range(4)]
    gts_train = [rp(true_params, true_aux.alive, c) for c in train_cams]
    gts_test = [rp(true_params, true_aux.alive, c) for c in test_cams]

    def psnr_of(params, alive):
        return float(np.mean([float(psnr(rp(params, alive, c), g)[0])
                              for c, g in zip(test_cams, gts_test)]))

    # noisy init, Gaussian-sharded training
    init_xyz = (true_xyz[: n_true // 2]
                + rng.normal(0, 0.05, (n_true // 2, 3))).astype(np.float32)
    init_rgb = np.clip(true_rgb[: n_true // 2]
                       + rng.normal(0, 0.1, (n_true // 2, 3)), 0, 1)
    params, aux = init_from_pcd(init_xyz, init_rgb.astype(np.float32),
                                capacity, device=device)
    train_cfg = RasterConfig(backend="stream", tile_capacity=256,
                             max_tiles_per_gaussian=16,
                             instance_cap=INSTANCE_CAP)
    step = make_gauss_train_step(OptimizationConfig(), train_cfg, 1.0, mesh)
    psnr_init = psnr_of(params, aux.alive)
    p, a, x = shard_state(params, adam_init(params), aux, mesh)
    measure.sync(device)
    t0 = time.perf_counter()
    overflow = 0
    for i in range(iters):
        k = i % len(train_cams)
        p, a, x, m = step(p, a, x, train_cams[k], gts_train[k], bg, i + 1,
                          False, width=width, height=height, sh_degree=0)
        overflow += int(m.overflow_capacity)
    measure.sync(device)
    wall = time.perf_counter() - t0
    params, _, aux = gather_state(p, a, x, mesh)
    if mesh.rank != 0:
        return None
    psnr_trained = psnr_of(params, aux.alive)

    # save through the PLY path, compress and decompress through the CLI's
    # functions
    it_dir = os.path.join(out_dir, "point_cloud", f"iteration_{iters}")
    os.makedirs(it_dir, exist_ok=True)
    ply = os.path.join(it_dir, "point_cloud.ply")
    save_gaussian_ply(ply, compact(params, aux))
    npz = compress(out_dir, iters, num_codes, ATTRIBUTES, sh_degree=3,
                   device=device)
    deq_ply = decompress(npz)
    raw_size, npz_size = os.path.getsize(ply), os.path.getsize(npz)

    # offline render of both with the exact operator
    trained = params_from_ply(ply, 3, device)
    dequant = params_from_ply(deq_ply, 3, device)
    alive_all = torch.ones((trained.xyz.shape[0],), dtype=torch.bool,
                           device=device)

    def metrics_of(pp):
        ps, ss = [], []
        for c, g in zip(test_cams, gts_test):
            img = rp(pp, alive_all, c)
            ps.append(float(psnr(img, g)[0]))
            ss.append(float(ssim(img, g)))
        return float(np.mean(ps)), float(np.mean(ss))

    psnr_raw, ssim_raw = metrics_of(trained)
    psnr_cmp, ssim_cmp = metrics_of(dequant)
    result = {
        "pipeline": "gauss-sharded train -> PLY -> cli/compress -> "
                    "offline render (exact)",
        "mesh": f"{n_dev} rank(s), axis 'gauss', "
                f"{'NCCL' if device.type == 'cuda' else 'gloo'}",
        "scene": f"{width}x{height}, {n_true} GT / {capacity} capacity, "
                 f"{iters} iters",
        "device": measure.device_name(device),
        "card": measure.card() if device.type == "cuda" else None,
        "train_wall_s": wall,
        "train_overflow_capacity": overflow,
        "psnr_init": psnr_init,
        "psnr_trained_loop_eval": psnr_trained,
        "psnr_offline_raw_ply": psnr_raw,
        "psnr_offline_compressed": psnr_cmp,
        "ssim_offline_raw_ply": ssim_raw,
        "ssim_offline_compressed": ssim_cmp,
        "compression_delta_db": psnr_raw - psnr_cmp,
        "num_codes": num_codes,
        "raw_ply_bytes": raw_size,
        "compressed_npz_bytes": npz_size,
        "size_ratio": raw_size / max(npz_size, 1),
    }
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(result, f, indent=2)
    log(json.dumps(result, indent=2))
    return result


def _rank_pipeline(rank: int, world: int, *args):
    return _pipeline(*args, torch.device("cpu"), lambda *_: None)


def run(out_dir: str, n_dev: int = 8, width: int = 128, height: int = 128,
        capacity: int = 4096, iters: int = 300, num_codes: int = 256,
        device="cuda", log=print) -> dict:
    """The pipeline's result (also written to ``<out_dir>/results.json``).
    On the CPU, outside a process group, ``n_dev`` gloo ranks run it;
    otherwise every rank of the current group calls this."""
    import torch.distributed as dist
    device = torch.device(device)
    args = (out_dir, n_dev, width, height, capacity, iters, num_codes)
    if device.type == "cpu" and not dist.is_initialized() and n_dev > 1:
        from ..parallel.multihost import spawn
        result = spawn(_rank_pipeline, n_dev, *args)[0]
        log(json.dumps(result, indent=2))
        return result
    return _pipeline(*args, device, log)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/torch_shardcompress")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: 8 on the CPU, the launcher's "
                         "world size on cards)")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--num_codes", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from ..parallel import multihost
    multihost.initialize()
    device = (multihost.device() if args.device == "cuda"
              else torch.device(args.device))
    devices = args.devices or (multihost.world_size()
                               if device.type == "cuda" else 8)
    return run(args.out, n_dev=devices, iters=args.iters,
               capacity=args.capacity, num_codes=args.num_codes,
               device=device)


if __name__ == "__main__":
    main()
