"""Rank bodies of the port's multi-rank CPU tests (``tests/test_torch_*``
twins of the JAX package's parallel tests).

This module imports no JAX: ``parallel.multihost.spawn`` starts each rank
as a fresh process that re-imports the module of the function it runs.
Every rank builds the same inputs from seeds with numpy (the test process
builds the JAX side's from the same functions), creates every mesh it
will use in one order, runs each case of one test file on the meshes of
1, 2 and 4 ranks it is a member of, and returns numpy results keyed by
(case, mesh size).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mvs_gaussian_splatting_tpu_torch.ops.preprocess import (CameraView,
                                                             preprocess)
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.parallel import mesh as pmesh
from mvs_gaussian_splatting_tpu_torch.parallel import multihost
from mvs_gaussian_splatting_tpu_torch.utils import graphics
from mvs_gaussian_splatting_tpu_torch.utils.transforms import normalize

SIZES = (1, 2, 4)


# ---- inputs, shared with the JAX side -------------------------------------

def camera_np(w: int, h: int, shift: float = 0.0):
    """(viewmatrix, projmatrix, campos, tanfovx, tanfovy) as numpy: a
    camera at the origin looking down +z, moved ``shift`` along x."""
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    V = np.eye(4, dtype=np.float32)
    V[0, 3] = shift
    c = np.linalg.inv(V)[:3, 3].astype(np.float32)
    return (V, (P @ V).astype(np.float32), c,
            np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))


def torch_camera(cam) -> CameraView:
    return CameraView(*(torch.tensor(np.asarray(a)) for a in cam))


def splats_np(n: int, seed: int):
    """(means, scales, quats, opacities, colours) in front of the camera."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(2, 6, n)
    means = np.stack([rng.uniform(-0.8, 0.8, n) * z,
                      rng.uniform(-0.6, 0.6, n) * z, z], -1).astype(np.float32)
    return (means, rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32),
            rng.randn(n, 4).astype(np.float32),
            rng.uniform(0.3, 0.95, n).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def cotangent_np(w: int, h: int, seed: int):
    return np.random.RandomState(seed).rand(3, h, w).astype(np.float32)


def torch_processed(leaves, cam, w: int, h: int, tile=16):
    means, scales, quats, opac, cols = leaves
    return preprocess(means, opac, cam, w, h, scales=scales,
                      rotations=normalize(quats), colors_precomp=cols,
                      tile_w=tile, tile_h=tile)


def leaves_of(arrays, grad: bool):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# ---- tile_stream ------------------------------------------------------------

TS_W, TS_H = 80, 48           # 5×3 = 15 tiles: pad tiles at 2 and 4 ranks
TS_CFG = RasterConfig(max_tiles_per_gaussian=16, backend="stream")


def _tile_stream_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.parallel.tile_stream import (
        make_tile_sharded_stream)
    cam = torch_camera(camera_np(TS_W, TS_H))
    for rr in (False, True):
        for fast in (False, True):
            cfg = TS_CFG._replace(fast_math=fast)
            fn = make_tile_sharded_stream(mesh, "tile", TS_W, TS_H, cfg,
                                          round_robin=rr)
            key = ("rr" if rr else "strips") + ("_fast" if fast else "")
            leaves = leaves_of(splats_np(100, 0), False)
            img, aux = fn(torch_processed(leaves, cam, TS_W, TS_H),
                          torch.tensor([0.2, 0.3, 0.4]))
            out[("image_" + key, n)] = (img.numpy(),
                                        int(aux["overflow_capacity"]))
            leaves = leaves_of(splats_np(80, 7), True)
            img, _ = fn(torch_processed(leaves, cam, TS_W, TS_H),
                        torch.zeros(3))
            (img * torch.tensor(cotangent_np(TS_W, TS_H, 1))).sum().backward()
            out[("grads_" + key, n)] = [a.grad.numpy() for a in leaves]


# ---- train-step states, shared with the JAX side -------------------------

def step_state(n: int = 96, capacity: int = 128, seed: int = 0,
               moments: bool = True, sh_degree: int = 1):
    """:func:`step_state_at` on n points in front of the camera."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32) + [0, 0, 4.0]
    return step_state_at(pts, rng.rand(n, 3).astype(np.float32), capacity,
                         sh_degree, seed=seed + 1, moments=moments)


def step_state_at(pts, cols, capacity: int = 128, sh_degree: int = 3,
                  extras=None, num_dirs: int = 16, seed: int = 1,
                  moments: bool = True):
    """numpy (params, mu, nu, aux) of ``init_from_pcd`` on ``pts``, with
    prior Adam moments (random, small) when ``moments``: Adam's first step
    from zero moments moves every parameter by ±lr, so a gradient that is 0
    up to rounding could flip a step."""
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
        init_from_pcd
    params, aux = init_from_pcd(pts, cols, capacity, sh_degree=sh_degree,
                                extras=extras, num_dirs=num_dirs,
                                device="cpu")
    rng = np.random.RandomState(seed)
    p = {k: v.numpy() for k, v in params._asdict().items() if v is not None}
    x = {k: v.numpy() for k, v in aux._asdict().items()}
    if moments:
        mu = {k: (rng.randn(*v.shape) * 1e-3).astype(np.float32)
              for k, v in p.items()}
        nu = {k: (rng.rand(*v.shape) * 1e-5).astype(np.float32)
              for k, v in p.items()}
    else:
        mu = {k: np.zeros_like(v) for k, v in p.items()}
        nu = {k: np.zeros_like(v) for k, v in p.items()}
    return p, mu, nu, x


def torch_state(p, mu, nu, aux, count: int = 0):
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        aux_from_numpy, params_from_numpy)
    from mvs_gaussian_splatting_tpu_torch.train.optim import adam_from_numpy
    return (params_from_numpy(p, "cpu"),
            adam_from_numpy(count, mu, nu, "cpu"), aux_from_numpy(aux, "cpu"))


def step_result(new_params, new_adam, new_aux, metrics):
    """numpy results of one step: params, mu, aux, metrics."""
    def d(tree):
        return {k: v.numpy() for k, v in tree._asdict().items()
                if v is not None}
    return {"params": d(new_params), "mu": d(new_adam.mu),
            "aux": d(new_aux),
            "metrics": {k: float(v) for k, v in metrics._asdict().items()
                        if v is not None and v.numel() == 1}}


def gts_np(b: int, w: int, h: int, seed: int = 0):
    return (np.random.RandomState(seed + 50).rand(b, 3, h, w) * 0.5
            + 0.25).astype(np.float32)


def orbit_camera_np(w: int, h: int, angle: float):
    """A camera on a circle of radius 4 about the origin, looking at it."""
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
    eye = np.array([4.0 * math.sin(angle), 0.0, -4.0 * math.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    r = np.stack([right, np.cross(fwd, right), fwd])
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = r
    V[:3, 3] = -r @ eye
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    return (V, (P @ V).astype(np.float32),
            np.linalg.inv(V)[:3, 3].astype(np.float32),
            np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))


def run_steps(step, state, cams, gts, bg, iters: int = 1, **kw):
    """``iters`` steps from ``state`` → (result of the last, losses)."""
    params, adam, aux = state
    losses = []
    for i in range(iters):
        params, adam, aux, m = step(params, adam, aux, cams, gts, bg, i + 1,
                                    True, **kw)
        losses.append(float(m.loss))
    return step_result(params, adam, aux, m), losses


# ---- tile_parallel (padded tables, the jnp compositor) --------------------

TP_CFG = RasterConfig(tile_capacity=128, tile_batch=8, backend="jnp")


def _tile_parallel_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
        _assemble_image
    from mvs_gaussian_splatting_tpu_torch.parallel.tile_parallel import \
        make_tile_sharded_composite
    w, h = TS_W, TS_H
    fn = make_tile_sharded_composite(mesh, "tile", w, h, TP_CFG)
    cam = torch_camera(camera_np(w, h))
    leaves = leaves_of(splats_np(120, 0), False)
    tiles, _, _ = fn(torch_processed(leaves, cam, w, h),
                     torch.tensor([0.2, 0.3, 0.4]))
    out[("image", n)] = _assemble_image(tiles, w // 16, h // 16, 16, 16, w,
                                        h).numpy()
    proc = torch_processed(leaves_of(splats_np(80, 3), False), cam, w, h)
    xy = proc.xy.detach().requires_grad_()
    tiles, _, _ = fn(proc._replace(xy=xy), torch.zeros(3))
    (tiles ** 2).sum().backward()
    out[("grad_xy", n)] = xy.grad.numpy()


# ---- tile_train -------------------------------------------------------------

TT_W = TT_H = 64
TT_CFG = RasterConfig(max_tiles_per_gaussian=16, backend="stream")


def _tile_train_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.parallel.tile_train import \
        make_tile_train_step
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    step = make_tile_train_step(OptimizationConfig(), TT_CFG, 1.0, mesh,
                                axis="tile")
    cam = torch_camera(camera_np(TT_W, TT_H))
    gt = torch.tensor(gts_np(1, TT_W, TT_H)[0])
    kw = dict(width=TT_W, height=TT_H, sh_degree=1)
    out[("step", n)] = run_steps(step, torch_state(*step_state(), count=20),
                                 cam, gt, torch.zeros(3), **kw)[0]
    if n == 2:     # two ranks busy, not four: the CPU is shared
        out[("losses", n)] = run_steps(
            step, torch_state(*step_state(moments=False)), cam, gt,
            torch.zeros(3), iters=25, **kw)[1]


# ---- data_parallel ------------------------------------------------------------

DP_W = DP_H = 32
DP_B = 8
DP_CFG = RasterConfig(tile_capacity=64, max_tiles_per_gaussian=8,
                      tile_batch=8, backend="jnp")


def dp_cameras(b: int = DP_B):
    return [orbit_camera_np(DP_W, DP_H, 2 * math.pi * i / 8)
            for i in range(b)]


def dp_state():
    rng = np.random.RandomState(0)
    return step_state_at(rng.uniform(-0.8, 0.8, (96, 3)).astype(np.float32),
                         rng.rand(96, 3).astype(np.float32))


GROW_FLAGS = {"grow_dir": True, "continous_dir": False,
              "grow_distance": False, "learn_split_distance": False,
              "learn_split_scale": False}


def grow_state():
    """24 points in 64 slots with the grow_dir extras and a hot gradient
    statistic, so that speculation selects candidates."""
    rng = np.random.RandomState(3)
    p, mu, nu, x = step_state_at(
        rng.uniform(-0.8, 0.8, (24, 3)).astype(np.float32),
        rng.rand(24, 3).astype(np.float32), capacity=64, extras=GROW_FLAGS)
    x["xyz_grad_accum"] = np.where(x["alive"], 1.0, 0.0).astype(np.float32)
    x["denom"] = np.where(x["alive"], 1.0, 0.0).astype(np.float32)
    return p, mu, nu, x


def spec_steps(mesh=None, spec_size: int = 8):
    """(single speculative step, batched one, grow config, raster config)
    of the JAX test's ``TestSpecBatchStep``."""
    from mvs_gaussian_splatting_tpu_torch.models.grow import GrowConfig
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    from mvs_gaussian_splatting_tpu_torch.train.grow_step import (
        make_spec_batch_train_step, make_spec_train_step)
    from mvs_gaussian_splatting_tpu_torch.utils.sphere import sphere_points
    cfg = GrowConfig(**GROW_FLAGS, num_dirs=16)
    raster = RasterConfig(tile_capacity=128, max_tiles_per_gaussian=16,
                          tile_batch=8, backend="jnp")
    opt = OptimizationConfig()
    dirs = sphere_points(16)
    single = make_spec_train_step(opt, raster, 1.0, cfg, dirs, spec_size,
                                  10.0)
    batched = (make_spec_batch_train_step(opt, raster, 1.0, cfg, dirs,
                                          spec_size, 10.0, mesh)
               if mesh is not None else None)
    return single, batched


def _data_parallel_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.parallel.data_parallel import \
        make_batch_train_step
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    step = make_batch_train_step(OptimizationConfig(), DP_CFG, 1.0, mesh)
    cams = [torch_camera(c) for c in dp_cameras()]
    gts = torch.tensor(gts_np(DP_B, DP_W, DP_H))
    kw = dict(width=DP_W, height=DP_H, sh_degree=0)
    out[("batch", n)] = run_steps(step, torch_state(*dp_state(), count=20),
                                  cams, gts, torch.zeros(3), **kw)[0]
    # the 1/B statistic: eight copies of one camera
    out[("copies", n)] = run_steps(
        step, torch_state(*dp_state(), count=20), [cams[1]] * DP_B,
        gts[1:2].expand(DP_B, -1, -1, -1).contiguous(), torch.zeros(3),
        **kw)[0]


def _spec_batch_cases(mesh, out, n):
    _, batched = spec_steps(mesh)
    gcams = [torch_camera(orbit_camera_np(DP_W, DP_H, 0.3 + 0.2 * i))
             for i in range(4)]
    out[("spec4", n)] = spec_step_result(batched, gcams)


def spec_step_result(step, cams):
    """One batched speculative step of :func:`grow_state` at iteration 600
    (a list of cameras) or the single one (one camera)."""
    params, adam, aux = torch_state(*grow_state(), count=20)
    kw = dict(width=DP_W, height=DP_H, sh_degree=0)
    if isinstance(cams, list):
        gts = torch.full((len(cams), 3, DP_H, DP_W), 0.4)
    else:
        gts = torch.full((3, DP_H, DP_W), 0.4)
    return step_result(*step(params, adam, aux, cams, gts, torch.zeros(3),
                             600, True, **kw))


# ---- grid_train -------------------------------------------------------------

GRID_B = 2
GRID_CFG = TT_CFG


def grid_cameras():
    return [camera_np(TT_W, TT_H, 0.0), camera_np(TT_W, TT_H, 0.25)]


def _grid_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.parallel.data_parallel import \
        make_batch_train_step
    from mvs_gaussian_splatting_tpu_torch.parallel.grid_train import \
        make_grid_train_step
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    opt = OptimizationConfig()
    cams = [torch_camera(c) for c in grid_cameras()]
    gts = torch.tensor(gts_np(GRID_B, TT_W, TT_H))
    kw = dict(width=TT_W, height=TT_H, sh_degree=1)
    step = make_grid_train_step(opt, GRID_CFG, 1.0, mesh)
    out[("step", n)] = run_steps(step, torch_state(*step_state(), count=20),
                                 cams, gts, torch.zeros(3), **kw)[0]
    # the camera-batched step on the jnp compositor, over the data axis
    dp_cfg = RasterConfig(max_tiles_per_gaussian=16, backend="jnp",
                          tile_capacity=256, tile_batch=16)
    dstep = make_batch_train_step(opt, dp_cfg, 1.0, mesh, axis="data")
    out[("dp_step", n)] = run_steps(dstep,
                                    torch_state(*step_state(), count=20),
                                    cams, gts, torch.zeros(3), **kw)[0]
    if n == 2:     # the 2×1 grid: its steps equal the 2×2 grid's
        out[("losses", n)] = run_steps(
            step, torch_state(*step_state(moments=False)), cams, gts,
            torch.zeros(3), iters=32, **kw)[1]


# ---- gauss_stream -----------------------------------------------------------

GS_W, GS_H = 80, 48           # 15 tiles: pad tiles at 2 and 4 ranks
GS_CFG = RasterConfig(max_tiles_per_gaussian=16, backend="stream")


def _gauss_stream_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.parallel.gauss_stream import \
        make_gauss_sharded_stream
    cam = torch_camera(camera_np(GS_W, GS_H))
    i = mesh.coords["gauss"]

    def shard(arrays):
        m = arrays[0].shape[0] // n
        return [a[i * m:(i + 1) * m] for a in arrays]

    for rr in (True, False):
        key = "rr" if rr else "strips"
        fn = make_gauss_sharded_stream(mesh, "gauss", GS_W, GS_H, GS_CFG,
                                       round_robin=rr)
        leaves = leaves_of(shard(splats_np(152, 0)), False)
        img, aux = fn(torch_processed(leaves, cam, GS_W, GS_H),
                      torch.tensor([0.2, 0.3, 0.4]))
        out[("image_" + key, n)] = (img.numpy(), int(aux["overflow_quota"]),
                                    int(aux["overflow_capacity"]))
        full = splats_np(104, 7)
        leaves = leaves_of(full, True)
        img, _ = fn(torch_processed(shard(leaves), cam, GS_W, GS_H),
                    torch.zeros(3))
        (img * torch.tensor(cotangent_np(GS_W, GS_H, 1))).sum().backward()
        # each rank's backward fills its own rows: their sum is the whole
        out[("grads_" + key, n)] = [
            pmesh.all_reduce(a.grad, mesh, "gauss").numpy() for a in leaves]


def _gauss_quota_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.parallel.gauss_stream import \
        make_gauss_sharded_stream
    if n != 4:
        return
    cam = torch_camera(camera_np(GS_W, GS_H))
    i = mesh.coords["gauss"]
    fn = make_gauss_sharded_stream(mesh, "gauss", GS_W, GS_H, GS_CFG,
                                   quota=128)
    arrays = splats_np(1600, 3)
    m = arrays[0].shape[0] // n
    leaves = leaves_of([a[i * m:(i + 1) * m] for a in arrays], False)
    img, aux = fn(torch_processed(leaves, cam, GS_W, GS_H), torch.zeros(3))
    out[("quota", n)] = (bool(torch.isfinite(img).all()),
                         int(aux["overflow_quota"]))


# ---- gauss_train ------------------------------------------------------------

def _gauss_train_cases(mesh, out, n):
    from mvs_gaussian_splatting_tpu_torch.parallel.gauss_train import (
        gather_state, make_gauss_train_step, shard_state)
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    step = make_gauss_train_step(OptimizationConfig(), TT_CFG, 1.0, mesh)
    cam = torch_camera(camera_np(TT_W, TT_H))
    gt = torch.tensor(gts_np(1, TT_W, TT_H)[0])
    kw = dict(width=TT_W, height=TT_H, sh_degree=1)

    def run(state, iters):
        params, adam, aux = shard_state(*state, mesh)
        losses = []
        for it in range(iters):
            params, adam, aux, m = step(params, adam, aux, cam, gt,
                                        torch.zeros(3), it + 1, True, **kw)
            losses.append(float(m.loss))
        return step_result(*gather_state(params, adam, aux, mesh), m), losses

    out[("step", n)] = run(torch_state(*step_state(), count=20), 1)[0]
    if n == 2:
        out[("losses", n)] = run(torch_state(*step_state(moments=False)),
                                 30)[1]


# ---- multihost: ranks that join through the environment ------------------

def _yield_cpu() -> None:
    """One thread, at a lower priority: a test file's ranks run beside the
    other test workers and should not slow them."""
    import os
    torch.set_num_threads(1)
    os.nice(10)


def niced(fn, *args, **kwargs):
    """A future of ``fn(*args, **kwargs)`` run in a thread at a lower
    priority (on Linux a thread's nice value is its own, and the processes
    it starts inherit it): the ranks a tool spawns then run beside the
    other test workers without slowing them, as :func:`_yield_cpu`'s do."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    def call():
        os.nice(10)
        return fn(*args, **kwargs)

    pool = ThreadPoolExecutor(1)
    future = pool.submit(call)
    pool.shutdown(wait=False)
    return future


def _env_rank(r: int, world: int, port: int, queue) -> None:
    import os
    import traceback
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    _yield_cpu()
    try:
        import torch.distributed as dist
        multihost.initialize()
        try:
            queue.put((r, (multihost.rank(), multihost.world_size(),
                           dist.get_backend(), tile_step_loss()), None))
        finally:
            dist.destroy_process_group()
    except Exception:                         # noqa: BLE001 — reported
        queue.put((r, None, traceback.format_exc()))


def spawn_env(world: int = 2, timeout: float = 300.0):
    """Start ``world`` processes that know only ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (a port bound to 0
    and released), as ``torchrun`` starts them; each joins through
    ``multihost.initialize()`` and runs one tile-parallel step. Returns
    each rank's (rank, world, backend, loss)."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_env_rank, args=(r, world, port, queue),
                         daemon=True) for r in range(world)]
    return multihost.collect(procs, queue, timeout)


def tile_step_loss() -> float:
    """One tile-parallel step of :func:`step_state` over the whole world
    (a world of one needs no process group): its loss."""
    from mvs_gaussian_splatting_tpu_torch.parallel.tile_train import \
        make_tile_train_step
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    step = make_tile_train_step(OptimizationConfig(), TT_CFG, 1.0,
                                pmesh.make_mesh(axes=("tile",)))
    res, losses = run_steps(step, torch_state(*step_state(), count=20),
                            torch_camera(camera_np(TT_W, TT_H)),
                            torch.tensor(gts_np(1, TT_W, TT_H)[0]),
                            torch.zeros(3), width=TT_W, height=TT_H,
                            sh_degree=1)
    return losses[0]


# ---- the loop ---------------------------------------------------------------

LOOP_W, LOOP_H = 64, 48


def _pose(angle, radius=4.0):
    eye = np.array([radius * math.sin(angle), 0.0, -radius * math.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd])
    return r_w2c.T, -r_w2c @ eye


def write_scene(root: str, n: int = 120, views: int = 9) -> str:
    """A COLMAP scene of ``n`` Gaussians seen from ``views`` cameras at
    64×48 (rendered by the per-pixel oracle), with noisy init points, under
    ``root/scene``; returns its path."""
    import os
    from mvs_gaussian_splatting_tpu_torch.data.cameras import Camera
    from mvs_gaussian_splatting_tpu_torch.data.colmap import \
        write_pinhole_scene
    from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
        rasterize_reference
    w, h = LOOP_W, LOOP_H
    rng = np.random.RandomState(3)
    means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.2, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
    cams, imgs = [], []
    for v in range(views):
        R, T = _pose(2 * math.pi * v / views)
        cam = Camera(uid=v, colmap_id=v, R=R, T=T, fovx=fovx, fovy=fovy,
                     image=None, image_name=f"v{v:02d}", width=w, height=h)
        with torch.no_grad():
            pre = preprocess(torch.tensor(means), torch.tensor(opac),
                             cam.view("cpu"), w, h,
                             scales=torch.tensor(scales),
                             rotations=torch.tensor(quats),
                             colors_precomp=torch.tensor(cols))
            img = rasterize_reference(pre, w, h, torch.zeros(3)).numpy()
        cams.append(cam)
        imgs.append((np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(
            np.uint8))
    init = means + rng.randn(n, 3).astype(np.float32) * 0.05
    path = os.path.join(root, "scene")
    write_pinhole_scene(path, cams, imgs, init,
                        np.full((n, 3), 128, np.uint8))
    return path


def train_loop(scene: str, iterations: int = 6, grow: bool = False,
               densify: bool = False, **flags):
    """``train/loop.py:train`` on ``scene`` for a few exact-mode steps at
    32×16 tiles with ``flags`` (``data_parallel`` …) → (logs, history,
    params as numpy)."""
    from mvs_gaussian_splatting_tpu_torch.train.config import (
        ModelConfig, OptimizationConfig, PipelineConfig, TrainRunConfig)
    from mvs_gaussian_splatting_tpu_torch.train.loop import train
    model = ModelConfig(source_path=scene, model_path="", eval=True,
                        sh_degree=1, grow_dir=grow)
    opt = OptimizationConfig(
        iterations=iterations, position_lr_max_steps=iterations,
        densify_from_iter=1 if (densify or grow) else 100,
        densification_interval=3,
        densify_until_iter=iterations + 1 if (densify or grow) else 0,
        opacity_reset_interval=1 if grow else 3000)
    pipe = PipelineConfig(tile_w=32, tile_h=16, max_tiles_per_gaussian=16,
                          fast_math=False, spec_capacity=16)
    run = TrainRunConfig(test_iterations=[iterations], save_iterations=[],
                         log_every=100, **flags)
    logs = []
    params, aux, _, history = train(model, opt, pipe, run,
                                    log_fn=logs.append, device="cpu")
    return logs, history, {k: v.numpy() for k, v in params._asdict().items()
                           if v is not None}


def _loop_cases(mesh, out, n):
    import tempfile
    if n != 4:
        return
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_scene(tmp)
        out[("data_densify", n)] = train_loop(scene, iterations=8,
                                              densify=True, data_parallel=4)
        out[("tile", n)] = train_loop(scene, tile_parallel=4)
        out[("grid", n)] = train_loop(scene, data_parallel=2, tile_parallel=2)
        out[("gauss", n)] = train_loop(scene, gauss_parallel=4)


def _loop_diverged_cases(mesh, out, n):
    if n != 4:
        return
    # a rank that drew other numbers is caught
    from mvs_gaussian_splatting_tpu_torch.train.loop import \
        check_ranks_agree
    params, adam, _ = torch_state(*step_state())
    if mesh.rank == 1:
        params = params._replace(xyz=params.xyz + 1e-3)
    try:
        check_ranks_agree(params, adam, 7, "cpu")
        out[("diverged", n)] = None
    except RuntimeError as e:
        out[("diverged", n)] = str(e)


CASES = {"tile_stream": (_tile_stream_cases, ("tile",)),
         "tile_train": (_tile_train_cases, ("tile",)),
         "tile_parallel": (_tile_parallel_cases, ("tile",)),
         "data_parallel": (_data_parallel_cases, ("data",)),
         "spec_batch": (_spec_batch_cases, ("data",)),
         "grid": (_grid_cases, ("data", "tile")),
         "gauss_stream": (_gauss_stream_cases, ("gauss",)),
         "gauss_quota": (_gauss_quota_cases, ("gauss",)),
         "gauss_train": (_gauss_train_cases, ("gauss",)),
         "loop": (_loop_cases, ("data",)),
         "loop_diverged": (_loop_diverged_cases, ("data",))}


def rank_main(rank: int, world: int, file_key: str):
    """Run ``file_key``'s cases on every mesh of SIZES this rank is in (a
    2-D mesh of n ranks is (n, 1) or (2, 2), ``make_mesh``'s shapes)."""
    _yield_cpu()
    torch.manual_seed(0)
    cases, axes = CASES[file_key]
    meshes = {n: pmesh.make_mesh(n, axes=axes) for n in SIZES if n <= world}
    out = {}
    for n, mesh in meshes.items():
        if mesh.member:
            cases(mesh, out, n)
    return out


class Ranks:
    """``spawn(rank_main, world, file_key)`` started in a thread, so that a
    test file computes its JAX references while the ranks run; ``get()``
    waits for the ranks' results."""

    def __init__(self, file_key: str, world: int = 4, **kw):
        from concurrent.futures import ThreadPoolExecutor
        from mvs_gaussian_splatting_tpu_torch.parallel.multihost import spawn
        self._pool = ThreadPoolExecutor(1)
        self._future = self._pool.submit(spawn, rank_main, world, file_key,
                                         **kw)

    def get(self):
        res = self._future.result()
        self._pool.shutdown()
        return res
