"""A two-process tile-sharded train step against the same step in one
process.

Counterpart of the JAX repository's ``scripts/multihost_dryrun.py``: the
multi-process path a cluster takes (``parallel/multihost.initialize()``
from ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, as ``torchrun`` sets them) runs one tile-sharded train
step split over two processes, and its loss is held to the same step run
by a single process (the unsharded mesh of one rank). Collectives cross
the process boundary through gloo on the CPU, NCCL on cards (one card a
process: two cards).

Roles (one file, three modes)::

    python -m mvs_gaussian_splatting_tpu_torch.tools.multihost_dryrun
        [--out runs/torch_multihost_dryrun.json] [--device cpu]
                                         # parent: spawns the other two
        ... --single --out F             # the one-process step
        ... --worker --out F             # a rank of the two-process step

The parent writes ``{"ok", "loss_single_process", "loss_two_process",
"rel_diff", "config"}`` to ``--out``; ``ok`` is ``rel_diff < 1e-5``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from ..ops.preprocess import CameraView
from ..ops.rasterize import RasterConfig
from ..utils import graphics

PACKAGE = __package__.rsplit(".", 1)[0]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REL_TOL = 1e-5
SIZE = 64


def run_one_step(device) -> float:
    """One tile-sharded train step of the micro-scene over every rank of
    the process group (a world of one needs no group): its loss."""
    from ..models.gaussians import init_from_pcd
    from ..parallel.mesh import make_mesh
    from ..parallel.tile_train import make_tile_train_step
    from ..train.config import OptimizationConfig
    from ..train.optim import adam_init

    w = h = SIZE
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.6, 0.6, (96, 3)).astype(np.float32) + [0, 0, 4.0]
    params, aux = init_from_pcd(pts.astype(np.float32),
                                rng.rand(96, 3).astype(np.float32), 128,
                                sh_degree=1, device=device)
    gt = torch.tensor(rng.rand(3, h, w).astype(np.float32),
                      device=device) * 0.5 + 0.25
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    cam = CameraView(t(np.eye(4)), t(P), t(np.zeros(3)),
                     t(math.tan(fovx / 2)), t(math.tan(fovy / 2)))
    cfg = RasterConfig(max_tiles_per_gaussian=16, backend="stream")
    step = make_tile_train_step(OptimizationConfig(), cfg, 1.0,
                                make_mesh(axes=("tile",)))
    _, _, _, m = step(params, adam_init(params), aux, cam, gt,
                      torch.zeros(3, device=device), 1, True, width=w,
                      height=h, sh_degree=1)
    return float(m.loss)


def _device(name: str):
    from ..parallel import multihost
    return multihost.device() if name == "cuda" else torch.device(name)


def main_worker(args) -> None:
    import torch.distributed as dist

    from ..parallel import multihost
    multihost.initialize()
    if multihost.world_size() != 2:
        raise RuntimeError(f"a worker expects a world of 2, got "
                           f"{multihost.world_size()}")
    try:
        loss = run_one_step(_device(args.device))
        print(f"WORKER{multihost.rank()} loss={loss:.10f}", flush=True)
        if multihost.rank() == 0 and args.out:
            with open(args.out, "w") as f:
                json.dump({"loss": loss}, f)
    finally:
        dist.destroy_process_group()


def main_single(args) -> None:
    loss = run_one_step(_device(args.device))
    print(f"SINGLE loss={loss:.10f}", flush=True)
    with open(args.out, "w") as f:
        json.dump({"loss": loss}, f)


def _env(**extra) -> dict:
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update({k: str(v) for k, v in extra.items()})
    return env


def main_parent(args, timeout: float = 600.0) -> dict:
    with socket.socket() as s:               # a free port for the store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    tmp = os.path.abspath(args.out) + ".tmp"
    base = [sys.executable, "-m", f"{PACKAGE}.tools.multihost_dryrun",
            "--device", args.device]

    def spawn(extra, env):
        return subprocess.Popen(base + extra, env=env, cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    procs = []
    try:
        single = spawn(["--single", "--out", tmp + ".single"], _env())
        procs.append(single)
        sout, _ = single.communicate(timeout=timeout)
        print(sout, end="")
        if single.returncode != 0:
            raise RuntimeError(f"single-process run failed:\n{sout}")
        with open(tmp + ".single") as f:
            loss_single = json.load(f)["loss"]
        workers = [spawn(["--worker", "--out", tmp + ".multi"],
                         _env(RANK=r, WORLD_SIZE=2, LOCAL_RANK=r,
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
                   for r in range(2)]
        procs += workers
        outs = [w.communicate(timeout=timeout)[0] for w in workers]
        print("".join(outs), end="")
        if any(w.returncode != 0 for w in workers):
            raise RuntimeError("worker failed:\n" + "\n".join(outs))
        with open(tmp + ".multi") as f:
            loss_multi = json.load(f)["loss"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for suf in (".single", ".multi"):
            if os.path.exists(tmp + suf):
                os.remove(tmp + suf)
    rel = abs(loss_multi - loss_single) / max(abs(loss_single), 1e-12)
    result = {
        "ok": bool(rel < REL_TOL),
        "loss_single_process": loss_single,
        "loss_two_process": loss_multi,
        "rel_diff": rel,
        "config": (f"2 processes x 1 {args.device} rank each, tile-sharded "
                   f"train step, multihost.initialize() + "
                   f"{'NCCL' if args.device == 'cuda' else 'gloo'}"),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="a rank of the two-process step (from the "
                         "environment)")
    ap.add_argument("--single", action="store_true",
                    help="the one-process step")
    ap.add_argument("--out", default=os.path.join(
        "runs", "torch_multihost_dryrun.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.worker:
        return main_worker(args)
    if args.single:
        return main_single(args)
    result = main_parent(args)
    if not result["ok"]:
        raise SystemExit(f"two-process loss differs: {result}")
    return result


if __name__ == "__main__":
    main()
