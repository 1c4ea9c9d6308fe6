"""Entry points for a harness: a forward render to compile-check, and a
multi-device dry run of every parallel training mode.

Counterpart of the JAX repository's ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, args)``, a forward render at 128×128 of
  512 synthetic Gaussians (capacity 2,048, SH degree 3) through the
  stream backend: B1 on a card, its plain version on the CPU;
- :func:`dryrun_multichip` runs, over ``n`` ranks at 32×32 from 128
  Gaussians (capacity 256), one step of each multi-device mode: the
  camera-batched step, the gradients of the tile-sharded and of the
  Gaussian-sharded stream composites, the tile-parallel, grid and
  Gaussian-parallel train steps, and the camera-batched grow step; it
  asserts finite losses and gradients and prints one line per mode.
  The two camera-batched steps composite as the JAX dry run's do, with
  the padded plain compositor, on the CPU, and through the stream
  kernels on a card; every other mode runs the stream backend.

The port is one process per device (``parallel/multihost.py``): on the
CPU ``dryrun_multichip(n)`` starts ``n`` gloo ranks; on a card it runs in
this process over the ranks the process group already has (one, without
a launcher)::

    python -m mvs_gaussian_splatting_tpu_torch.tools.graft_entry
        [--devices N] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..models.gaussians import init_from_pcd
from ..ops.preprocess import CameraView
from ..ops.rasterize import RasterConfig
from ..ops.render import render
from ..utils import graphics

ENTRY_SIZE = 128
ENTRY_CONFIG = RasterConfig(tile_capacity=256, max_tiles_per_gaussian=32,
                            tile_batch=32, backend="stream")
DRYRUN_SIZE = 32


def _synthetic(n: int, capacity: int, seed: int = 0, device="cuda"):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    return init_from_pcd(pts, cols, capacity, sh_degree=3, device=device)


def _synthetic_grow(n: int, capacity: int, seed: int = 0, device="cuda"):
    rng = np.random.RandomState(seed)
    flags = {"grow_dir": True, "continous_dir": False, "grow_distance": False,
             "learn_split_distance": False, "learn_split_scale": False}
    params, aux = init_from_pcd(
        rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
        rng.rand(n, 3).astype(np.float32), capacity, sh_degree=3,
        extras=flags, num_dirs=16, device=device)
    alive = aux.alive.to(torch.float32)
    return params, aux._replace(xyz_grad_accum=alive.clone(),
                                denom=alive.clone())


def _camera(width: int, height: int, angle: float = 0.0,
            device="cuda") -> CameraView:
    """A camera 4 units from the origin on a horizontal orbit, looking at
    it."""
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, width), height)
    eye = np.array([4.0 * math.sin(angle), 0.0, -4.0 * math.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd])
    w2v = np.eye(4, dtype=np.float32)
    w2v[:3, :3] = r_w2c
    w2v[:3, 3] = -r_w2c @ eye
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return CameraView(t(w2v), t((P @ w2v).astype(np.float32)),
                      t(np.linalg.inv(w2v)[:3, 3]), t(math.tan(fovx / 2)),
                      t(math.tan(fovy / 2)))


def entry(device="cuda"):
    """(fn, (params, alive, camera, bg)): ``fn`` renders the image
    [3, 128, 128]."""
    width = height = ENTRY_SIZE
    params, aux = _synthetic(512, 2048, device=device)
    cam = _camera(width, height, device=device)
    bg = torch.zeros(3, device=device)

    @torch.no_grad()
    def fn(params, alive, cam, bg):
        return render(cam, width, height, params, bg, sh_degree=3,
                      alive=alive, raster_config=ENTRY_CONFIG)["render"]

    return fn, (params, aux.alive, cam, bg)


def _finite(t: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"non-finite {what} in dryrun")


def _legs(n_devices: int, device, log=print) -> dict:
    """Every mode's step over the first ``n_devices`` ranks of the process
    group (every rank calls it: the meshes' groups are made by all).
    Returns the losses by mode."""
    from ..models.grow import GrowConfig
    from ..ops.preprocess import preprocess
    from ..parallel.data_parallel import make_batch_train_step
    from ..parallel.gauss_stream import make_gauss_sharded_stream
    from ..parallel.gauss_train import make_gauss_train_step, shard_state
    from ..parallel.grid_train import make_grid_train_step
    from ..parallel.mesh import grid_mesh, make_mesh
    from ..parallel.multihost import world_size
    from ..parallel.tile_stream import make_tile_sharded_stream
    from ..parallel.tile_train import make_tile_train_step
    from ..train.config import OptimizationConfig
    from ..train.grow_step import make_spec_batch_train_step
    from ..train.optim import adam_init
    from ..utils.sphere import sphere_points
    from ..utils.transforms import normalize

    if n_devices > world_size():
        raise ValueError(f"dryrun_multichip({n_devices}) needs a process "
                         f"group of {n_devices} ranks, this one has "
                         f"{world_size()}")
    w = h = DRYRUN_SIZE
    # every mesh first, in one order on every rank
    mesh = make_mesh(n_devices)
    ts_mesh = make_mesh(n_devices, axes=("tile",))
    gs_mesh = make_mesh(n_devices, axes=("gauss",))
    n_tile2 = max(1, n_devices // 2)
    g2_mesh = (grid_mesh(2, n_tile2) if n_devices >= 2 else None)
    if not mesh.member:
        return {}
    say = log if mesh.rank == 0 else (lambda *_: None)
    losses = {}
    opt_cfg = OptimizationConfig()
    stream_cfg = RasterConfig(max_tiles_per_gaussian=8, backend="stream")
    # the camera-batched legs: on the CPU the JAX dry run's padded plain
    # compositor, which the tests hold against the JAX step; on a card
    # the stream kernels, as training runs them
    raster_cfg = (RasterConfig(tile_capacity=64, max_tiles_per_gaussian=8,
                               tile_batch=8, backend="jnp")
                  if torch.device(device).type == "cpu" else stream_cfg)
    zeros3 = torch.zeros(3, device=device)

    params, aux = _synthetic(128, 256, device=device)
    adam = adam_init(params)
    step = make_batch_train_step(opt_cfg, raster_cfg, 1.0, mesh)
    cams = [_camera(w, h, 2 * math.pi * i / n_devices, device)
            for i in range(n_devices)]
    gts = torch.zeros((n_devices, 3, h, w), device=device) + 0.5
    new_params, _, _, m = step(params, adam, aux, cams, gts, zeros3, 1, True,
                               width=w, height=h, sh_degree=0)
    losses["batch"] = float(m.loss)
    _finite(m.loss, "loss")
    say(f"dryrun_multichip({n_devices}): loss={losses['batch']:.4f} "
        f"visible={int(m.n_visible)} OK")

    cam0 = _camera(w, h, device=device)

    def stream_grad(fn, rows):
        xyz = new_params.xyz[rows].detach().requires_grad_(True)
        p = preprocess(xyz, torch.sigmoid(new_params.opacity[rows, 0]), cam0,
                       w, h, scales=torch.exp(new_params.scaling[rows]),
                       rotations=normalize(new_params.rotation[rows]),
                       colors_precomp=torch.zeros_like(xyz) + 0.5)
        img, _ = fn(p, zeros3)
        return torch.autograd.grad(img.mean(), xyz)[0]

    fn = make_tile_sharded_stream(ts_mesh, "tile", w, h, stream_cfg)
    _finite(stream_grad(fn, slice(None)), "tile-stream grads")
    say(f"dryrun tile-sharded stream({n_devices}): grads finite OK")

    cap = new_params.xyz.shape[0]
    i = gs_mesh.coords["gauss"]
    block = slice(i * cap // n_devices, (i + 1) * cap // n_devices)
    gfn = make_gauss_sharded_stream(gs_mesh, "gauss", w, h, stream_cfg)
    _finite(stream_grad(gfn, block), "gauss-stream grads")
    say(f"dryrun gauss-sharded stream({n_devices}): grads finite OK")

    gt1 = torch.zeros((3, h, w), device=device) + 0.5
    tt_step = make_tile_train_step(opt_cfg, stream_cfg, 1.0, ts_mesh)
    p2, aux2 = _synthetic(128, 256, seed=2, device=device)
    _, _, _, m = tt_step(p2, adam_init(p2), aux2, cam0, gt1, zeros3, 1,
                         True, width=w, height=h, sh_degree=0)
    losses["tile_train"] = float(m.loss)
    _finite(m.loss, "tile-train loss")
    say(f"dryrun tile-parallel train({n_devices}): "
        f"loss={losses['tile_train']:.4f} OK")

    if g2_mesh is not None and g2_mesh.member:
        gr_step = make_grid_train_step(opt_cfg, stream_cfg, 1.0, g2_mesh)
        p3, aux3 = _synthetic(128, 256, seed=3, device=device)
        _, _, _, m = gr_step(p3, adam_init(p3), aux3,
                             [_camera(w, h, 0.0, device),
                              _camera(w, h, 0.5, device)],
                             torch.zeros((2, 3, h, w), device=device) + 0.5,
                             zeros3, 1, True, width=w, height=h, sh_degree=0)
        losses["grid_train"] = float(m.loss)
        _finite(m.loss, "grid-train loss")
        say(f"dryrun grid train 2x{n_tile2}: "
            f"loss={losses['grid_train']:.4f} OK")

    gt_step = make_gauss_train_step(opt_cfg, stream_cfg, 1.0, gs_mesh)
    p4, aux4 = _synthetic(128, 256, seed=4, device=device)
    _, _, _, m = gt_step(*shard_state(p4, adam_init(p4), aux4, gs_mesh),
                         cam0, gt1, zeros3, 1, True, width=w, height=h,
                         sh_degree=0)
    losses["gauss_train"] = float(m.loss)
    _finite(m.loss, "gauss-train loss")
    say(f"dryrun gauss-parallel train({n_devices}): "
        f"loss={losses['gauss_train']:.4f} OK")

    gp, gaux = _synthetic_grow(128, 256, device=device)
    grow_cfg = GrowConfig(grow_dir=True, num_dirs=16)
    spec_step = make_spec_batch_train_step(
        opt_cfg, raster_cfg, 1.0, grow_cfg, sphere_points(16), 16, 10.0,
        mesh)
    gen = torch.Generator(device=device).manual_seed(0)
    _, _, _, m = spec_step(gp, adam_init(gp), gaux, cams, gts, zeros3, 600,
                           True, width=w, height=h, sh_degree=0,
                           generator=gen)
    losses["grow_spec_batch"] = float(m.loss)
    _finite(m.loss, "spec loss")
    say(f"dryrun grow-spec batched({n_devices}): "
        f"loss={losses['grow_spec_batch']:.4f} OK")
    return losses


def _rank_legs(rank: int, world: int, n_devices: int) -> dict:
    return _legs(n_devices, torch.device("cpu"))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One step of every mode over ``n_devices`` ranks; returns rank 0's
    losses by mode. On the CPU, outside a process group, it starts
    ``n_devices`` gloo ranks; otherwise every rank of the current group
    calls it."""
    import torch.distributed as dist
    device = torch.device(device)
    if device.type == "cpu" and not dist.is_initialized() and n_devices > 1:
        from ..parallel.multihost import spawn
        return spawn(_rank_legs, n_devices, n_devices)[0]
    return _legs(n_devices, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the dry run (the CPU starts them; on "
                         "cards, launch this many processes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from ..parallel import multihost
    multihost.initialize()
    device = (multihost.device() if args.device == "cuda"
              else torch.device(args.device))
    fn, fargs = entry(device)
    img = fn(*fargs)
    print("entry: render", tuple(img.shape), "mean", float(img.mean()))
    dryrun_multichip(args.devices, device)


if __name__ == "__main__":
    main()
