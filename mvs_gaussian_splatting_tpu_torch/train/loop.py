"""The training driver, single device.

Port of the JAX package's ``train/loop.py``: host-side orchestration around
the train step: camera sampling, SH warm-up, learning-rate schedule,
densify / prune / opacity-reset cadence, capacity growth, the render-slice
and instance-cap buckets, eval sweeps, the divergence guard, checkpoints.

Training composites in the configuration's mode: fast math by default
(B3), exact with ``fast_math=False``; every eval is exact
(:func:`eval_config`). Grow mode (``model_cfg.grow_dir`` /
``continous_dir`` / ``grow_distance`` / ``learn_split_*``) trains through
``train/grow_step.py``'s speculative step inside its window and densifies
with ``densify_and_prune_grow``.

The multi-device modes (``parallel/``) run on the process group that
``parallel.multihost.initialize`` joined (world size 1 without one):
``data_parallel`` B cameras per step over min(world, B) ranks (with grow
mode's batched speculative step inside its window), ``tile_parallel`` one
camera's tiles over that many ranks, both at once on a (data, tile) grid,
and ``gauss_parallel`` the Gaussians sharded. Every rank runs this loop
with the same seeds, so camera draws, densification and every random draw
are the same on every rank; after each densify round a checksum of the
parameters and Adam state is compared across the ranks. Only rank 0
writes files.

The network viewer: once ``viewer.network_gui.init`` has opened a listener
(``cli/train.py --ip``), :func:`_gui_pump` serves its requests at the top
of every iteration, rendering the live state through the eval raster
configuration (B1 on a card) with the exact instance bound.
"""

from __future__ import annotations

import json
import math
import os
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.scene import Scene
from ..models.densify import (DensifyConfig, densify_and_prune,
                              densify_and_prune_grow, reset_opacity)
from ..models.gaussians import (GaussianParams, compact, compact_state,
                                init_from_pcd, num_alive, pad_capacity)
from ..models.grow import GrowConfig
from ..ops.rasterize import RasterConfig, widen_eval_budgets
from ..parallel import multihost
from ..utils.sphere import sphere_points
from ..utils.system import seed_everything
from ..viewer import network_gui
from .checkpoint import load_checkpoint, save_checkpoint
from .config import (ModelConfig, OptimizationConfig, PipelineConfig,
                     TrainRunConfig, save_cfg_args)
from .grow_step import make_spec_batch_train_step, make_spec_train_step
from .optim import AdamState, adam_init
from .step import make_eval_metrics, make_eval_render, make_train_step

PROFILE_WINDOW = (100, 120)


def raster_config_from_pipe(pipe: PipelineConfig) -> RasterConfig:
    return RasterConfig(backend=pipe.backend,
                        tile_w=pipe.tile_w, tile_h=pipe.tile_h,
                        tile_capacity=pipe.tile_capacity,
                        max_tiles_per_gaussian=pipe.max_tiles_per_gaussian,
                        tile_batch=pipe.tile_batch,
                        fast_math=pipe.fast_math,
                        tier_budgets=tuple(pipe.tier_budgets),
                        tier_fracs=tuple(pipe.tier_fracs))


def eval_config(raster_cfg: RasterConfig) -> RasterConfig:
    """The eval invariants: every surface that produces user-visible images
    or reported metrics composites in EXACT mode with the generous
    full-footprint tile budgets (ops.rasterize.widen_eval_budgets)."""
    return widen_eval_budgets(raster_cfg._replace(fast_math=False))


def eval_instance_cap(n_rows: int, eval_cfg: RasterConfig) -> int:
    """Exact tier-enumeration bound for an eval render over ``n_rows`` rows
    (CHUNK-aligned): makes global capacity overflow impossible by
    construction, as cli/render's eval configuration does."""
    from ..ops.binning import stream_instance_bound
    bound = stream_instance_bound(n_rows, eval_cfg.max_tiles_per_gaussian,
                                  eval_cfg.tier_budgets, eval_cfg.tier_fracs)
    return bound + (-bound) % 128


def adaptive_eval_layout(params, aux, cameras, eval_cfg: RasterConfig,
                         n_rows: int):
    """((d, budgets, fracs), instance_cap) for a clip-free in-loop eval:
    the tier layout sized from the measured per-Gaussian tile needs over
    the eval cameras, as cli/render's offline chain sizes it, so the
    loop's PSNR and the offline render's agree on the same model."""
    from ..cli.render import measure_tile_needs
    from ..ops.binning import adaptive_tier_layout, stream_instance_bound
    p = GaussianParams(*[None if a is None else a[:n_rows] for a in params])
    needs = measure_tile_needs(p, cameras, eval_cfg.tile_w, eval_cfg.tile_h)
    # dead slots never render: their projected rects must not inflate it
    needs = np.where(aux.alive[:n_rows].cpu().numpy(), needs, 0)
    d, budgets, fracs, n_clipped = adaptive_tier_layout(
        needs, eval_cfg.max_tiles_per_gaussian, eval_cfg.tier_budgets,
        eval_cfg.tier_fracs, quantize=True)
    if n_clipped:
        print(f"WARNING: eval adaptive budgets hit the slot limit — "
              f"{n_clipped} Gaussians render clipped")
    bound = stream_instance_bound(n_rows, d, budgets, fracs)
    return (d, tuple(budgets), tuple(fracs)), bound + (-bound) % 128


def make_parallel_step(opt_cfg, raster_cfg: RasterConfig,
                       run_cfg: TrainRunConfig, spatial_lr_scale: float,
                       log_fn: Callable[[str], None] = print):
    """The multi-device step the run's flags ask for, as the JAX loop
    dispatches (``train/loop.py:165-215``): (kind, mesh, step) with kind
    "batch" (data_parallel, or the grid when tile_parallel is set too),
    "tile" (tile_parallel) or "gauss" (gauss_parallel, whose step takes the
    state sharded by ``parallel/gauss_train.py:shard_state``); (None, None,
    None) when no flag is set. A mesh that asks for more ranks than
    the world has is an error, as is a rank outside the mesh."""
    from ..parallel.mesh import grid_mesh, make_mesh
    world = multihost.world_size()
    dp, tp, gp = (run_cfg.data_parallel, run_cfg.tile_parallel,
                  run_cfg.gauss_parallel)
    if dp > 0 and tp > 0:
        from ..parallel.grid_train import make_grid_train_step
        if tp > world:
            raise ValueError(f"grid_parallel needs {tp} ranks for its tile "
                             f"axis, the world has {world}")
        n_data = min(world // tp, dp)
        if dp % n_data:
            raise ValueError(f"grid_parallel: {dp} cameras do not divide "
                             f"over {n_data} data rows")
        mesh = grid_mesh(n_data, tp)
        step = make_grid_train_step(opt_cfg, raster_cfg, spatial_lr_scale,
                                    mesh)
        kind = "batch"
        log_fn(f"grid-parallel: {dp} cameras/step × {tp}-way tile sharding "
               f"({mesh.size} device(s))")
    elif dp > 0:
        from ..parallel.data_parallel import make_batch_train_step
        mesh = make_mesh(min(world, dp))
        step = make_batch_train_step(opt_cfg, raster_cfg, spatial_lr_scale,
                                     mesh)
        kind = "batch"
        log_fn(f"data-parallel: {dp} cameras/step over {mesh.size} "
               "device(s)")
    elif tp > 0:
        from ..parallel.tile_train import make_tile_train_step
        mesh = make_mesh(tp, axes=("tile",))
        step = make_tile_train_step(opt_cfg, raster_cfg, spatial_lr_scale,
                                    mesh)
        kind = "tile"
        log_fn(f"tile-parallel: 1 camera/step, tiles sharded over "
               f"{mesh.size} device(s)")
    elif gp > 0:
        from ..parallel.gauss_train import make_gauss_train_step
        mesh = make_mesh(gp, axes=("gauss",))
        step = make_gauss_train_step(opt_cfg, raster_cfg, spatial_lr_scale,
                                     mesh)
        kind = "gauss"
        log_fn(f"gauss-parallel: params sharded over {mesh.size} "
               "device(s), one all_to_all instance exchange per step")
    else:
        return None, None, None
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} lies outside the {mesh.size}-rank "
                         f"mesh: start {mesh.size} processes")
    return kind, mesh, step


def state_checksum(params, adam: AdamState) -> torch.Tensor:
    """[3] float64: the sums of every parameter, first and second moment,
    the same on every rank while the ranks agree."""
    def total(tree):
        return sum(float(a.double().sum()) for a in tree if a is not None)
    return torch.tensor([total(params), total(adam.mu), total(adam.nu)],
                        dtype=torch.float64)


def check_ranks_agree(params, adam: AdamState, iteration: int,
                      device) -> list:
    """All-gather :func:`state_checksum` over the world and raise if any
    rank's differs (a rank drew other random numbers, or reduced in
    another order). Returns the checksum; [] at world size 1."""
    import torch.distributed as dist
    if multihost.world_size() == 1:
        return []
    mine = state_checksum(params, adam).to(device)
    every = [torch.zeros_like(mine) for _ in range(multihost.world_size())]
    dist.all_gather(every, mine)
    if any(not torch.equal(e, mine) for e in every):
        raise RuntimeError(f"[ITER {iteration}] the ranks diverged: state "
                           f"checksums {[e.tolist() for e in every]}")
    return mine.tolist()


def train(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
          pipe_cfg: PipelineConfig, run_cfg: TrainRunConfig,
          scene: Optional[Scene] = None,
          log_fn: Callable[[str], None] = print, device="cuda",
          profile_dir: str = ""):
    """Run the optimization on ``device``. Returns (params, aux, scene,
    history); ``history`` is also written to ``<model_path>/history.json``.
    ``profile_dir``: write a torch.profiler trace of this run's iterations
    100-120 (counted from the checkpoint's iteration on a resume) there as
    ``trace.json``."""
    device = torch.device(device)
    seed_everything(run_cfg.seed)
    main_rank = multihost.rank() == 0
    if scene is None:
        scene = Scene(model_cfg)
    if model_cfg.model_path and main_rank:
        save_cfg_args(model_cfg.model_path, model_cfg)

    raster_cfg = raster_config_from_pipe(pipe_cfg)
    spatial_lr_scale = float(scene.cameras_extent)

    first_iter = 0
    active_sh = 0
    if run_cfg.start_checkpoint:
        params, adam, aux, first_iter, active_sh = load_checkpoint(
            run_cfg.start_checkpoint, device)
        # checkpoints taken mid-training may have alive holes: compact so
        # the render prefix-slice below is valid
        params, mu, nu, aux = compact_state(params, adam.mu, adam.nu, aux)
        adam = adam._replace(mu=mu, nu=nu)
        log_fn(f"resumed from {run_cfg.start_checkpoint} at iter {first_iter}")
    else:
        n0 = len(scene.info.points)
        capacity = max(1024, int(n0 * opt_cfg.initial_capacity_factor))
        capacity = 1 << math.ceil(math.log2(capacity))
        init_gen = torch.Generator(device=device)
        init_gen.manual_seed(run_cfg.seed)
        params, aux = init_from_pcd(scene.info.points, scene.info.colors,
                                    capacity, sh_degree=model_cfg.sh_degree,
                                    extras=model_cfg.extras(),
                                    num_dirs=model_cfg.num_dirs,
                                    device=device, generator=init_gen)
        adam = adam_init(params)
        log_fn(f"Number of points at initialisation : {n0} "
               f"(capacity {capacity})")

    train_step = make_train_step(opt_cfg, raster_cfg, spatial_lr_scale)
    kind, mesh, par_step = make_parallel_step(
        opt_cfg, raster_cfg, run_cfg, spatial_lr_scale, log_fn)
    eval_cfg = eval_config(raster_cfg)
    eval_render = make_eval_render(eval_cfg)
    eval_metrics = make_eval_metrics(eval_cfg)
    render_n = _render_bucket(int(num_alive(aux)), params.xyz.shape[0])
    # measured-load instance-cap bucket (stream backend only): 0 = the
    # a-priori auto heuristic; re-bucketed from metrics.instance_load at
    # every densify round, grown at once on an overflow signal
    stream_caps = raster_cfg.backend in ("stream", "auto")
    inst_cap = 0
    # visible-prefix compaction bucket, grown at once on overflow_visible
    use_vis = pipe_cfg.visible_compaction and stream_caps
    vis_cap = 0
    vis_max = 0

    # grow mode: the speculative step and the grow densification round
    grow_cfg = GrowConfig(**{k: getattr(model_cfg, k)
                             for k in GrowConfig._fields})
    has_grow = grow_cfg.grow_dir or grow_cfg.continous_dir
    spec_step = spec_batch_step = None
    spec_size = pipe_cfg.spec_capacity
    sphere_dirs = None
    if any(model_cfg.extras().values()):
        if grow_cfg.grow_dir:
            sphere_dirs = torch.as_tensor(
                sphere_points(grow_cfg.num_dirs), dtype=torch.float32,
                device=device)
        spec_step = make_spec_train_step(
            opt_cfg, raster_cfg, spatial_lr_scale, grow_cfg, sphere_dirs,
            spec_size, float(scene.cameras_extent))
        if kind == "batch":
            # grow mode with camera batches: the speculative set is
            # camera-independent, so it renders against every camera
            spec_batch_step = make_spec_batch_train_step(
                opt_cfg, raster_cfg, spatial_lr_scale, grow_cfg,
                sphere_dirs, spec_size, float(scene.cameras_extent), mesh)
    # the instance cap's bound counts the speculative rows too: the load it
    # buckets may be a speculative step's
    spec_rows = 2 * spec_size if spec_step is not None else 0

    densify_cfg = DensifyConfig(
        grad_threshold=opt_cfg.densify_grad_threshold,
        min_opacity=opt_cfg.min_opacity,
        percent_dense=opt_cfg.percent_dense,
        symmetric_split=model_cfg.symmetric_split)
    bg = (torch.ones(3, device=device) if model_cfg.white_background
          else torch.zeros(3, device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(run_cfg.seed + 1)

    tb_writer = _make_tb_writer(model_cfg.model_path if main_rank else "")
    viewpoint_stack: list = []
    history = {"loss": [], "psnr_test": {}, "n_alive": {}, "iter_time": []}
    best_test_psnr = -1.0
    diverged_evals = 0
    ema_loss = 0.0
    loss = float("nan")
    t_last = time.perf_counter()
    progress = (_make_progress(first_iter, opt_cfg.iterations) if main_rank
                else None)
    profiler = None
    # gauss_parallel keeps the rank's shard of (params, adam, aux) between
    # steps, made whole where the loop needs every row
    sharded = False

    def whole():
        nonlocal params, adam, aux, sharded
        if sharded:
            from ..parallel.gauss_train import gather_state
            params, adam, aux = gather_state(params, adam, aux, mesh)
            sharded = False

    def n_alive_now() -> int:
        n = num_alive(aux)
        if sharded:
            from ..parallel.mesh import all_reduce
            n = all_reduce(n.reshape(1).to(torch.int64), mesh)[0]
        return int(n)

    def draw_camera_batch(first_cam):
        """Fill the batch with cameras of the first one's size; a scene
        with too few pads the batch by repeating the drawn ones."""
        nonlocal viewpoint_stack
        size = first_cam.image.shape
        cams = [first_cam]
        tries = 0
        max_tries = 4 * len(scene.get_train_cameras())
        while len(cams) < run_cfg.data_parallel and tries < max_tries:
            if not viewpoint_stack:
                viewpoint_stack = scene.get_train_cameras().copy()
            c = viewpoint_stack.pop(random.randint(0,
                                                   len(viewpoint_stack) - 1))
            tries += 1
            if c.image.shape == size:
                cams.append(c)
        if len(cams) < run_cfg.data_parallel:
            if iteration == first_iter + 1:
                log_fn(f"data-parallel: only {len(cams)} cameras at "
                       f"{size[2]}x{size[1]} — padding batch with repeats")
            k = len(cams)
            cams = [cams[i % k] for i in range(run_cfg.data_parallel)]
        return cams

    for iteration in range(first_iter + 1, opt_cfg.iterations + 1):
        if profile_dir and iteration == first_iter + PROFILE_WINDOW[0]:
            profiler = _start_profiler(device)
        if (profiler is not None
                and iteration == first_iter + PROFILE_WINDOW[1]):
            _stop_profiler(profiler, profile_dir)
            profiler = None
            log_fn(f"[ITER {iteration}] profiler trace written to "
                   f"{profile_dir}")
        if network_gui.listener is not None:
            whole()
            _gui_pump(model_cfg, params, aux, eval_cfg, active_sh, iteration,
                      opt_cfg.iterations)
        if iteration % 1000 == 0 and active_sh < model_cfg.sh_degree:
            active_sh += 1

        if not viewpoint_stack:
            viewpoint_stack = scene.get_train_cameras().copy()
        cam = viewpoint_stack.pop(random.randint(0, len(viewpoint_stack) - 1))
        bg_it = (torch.rand(3, generator=gen, device=device)
                 if opt_cfg.random_background else bg)
        do_stats = iteration < opt_cfg.densify_until_iter
        # the speculative render's window: grow steps from one interval
        # before densification starts until it stops, past the first
        # opacity reset; learned split alone speculates on every step
        spec_now = spec_step is not None and (
            not has_grow
            or (iteration > (opt_cfg.densify_from_iter
                             - opt_cfg.densification_interval - 1)
                and iteration < opt_cfg.densify_until_iter
                and iteration > opt_cfg.opacity_reset_interval))
        step_kw = dict(width=cam.image.shape[2], height=cam.image.shape[1],
                       sh_degree=active_sh, render_n=render_n,
                       instance_cap=inst_cap)
        if kind == "gauss" and not spec_now:
            if not sharded:
                from ..parallel.gauss_train import shard_state
                params, adam, aux = shard_state(params, adam, aux, mesh)
                sharded = True
            params, adam, aux, metrics = par_step(
                params, adam, aux, cam.view(device), cam.device_image(device),
                bg_it, iteration, do_stats, **step_kw)
        else:
            whole()
        if kind == "batch":
            cams = draw_camera_batch(cam)
            views = [c.view(device) for c in cams]
            gts = torch.stack([c.device_image(device) for c in cams])
            if spec_now:
                params, adam, aux, metrics = spec_batch_step(
                    params, adam, aux, views, gts, bg_it, iteration,
                    do_stats, generator=gen, **step_kw)
            else:
                params, adam, aux, metrics = par_step(
                    params, adam, aux, views, gts, bg_it, iteration,
                    do_stats, **step_kw)
        elif spec_now:
            params, adam, aux, metrics = spec_step(
                params, adam, aux, cam.view(device), cam.device_image(device),
                bg_it, iteration, do_stats, generator=gen, **step_kw)
        elif kind == "tile":
            params, adam, aux, metrics = par_step(
                params, adam, aux, cam.view(device), cam.device_image(device),
                bg_it, iteration, do_stats, **step_kw)
        elif kind is None:
            params, adam, aux, metrics = train_step(
                params, adam, aux, cam.view(device), cam.device_image(device),
                bg_it, iteration, do_stats, visible_cap=vis_cap, **step_kw)

        eval_now = (iteration in run_cfg.test_iterations
                    or (run_cfg.eval_every
                        and iteration % run_cfg.eval_every == 0))
        if eval_now:
            whole()
        # the report evaluates the pre-densify state (densify writes in
        # place, so keep a copy at eval iterations only)
        eval_state = ((_clone(params), _clone(aux), render_n) if eval_now
                      else None)

        # ---- densification schedule --------------------------------------
        if iteration < opt_cfg.densify_until_iter:
            if (iteration > opt_cfg.densify_from_iter
                    and iteration % opt_cfg.densification_interval == 0):
                whole()
                n_al = int(num_alive(aux))
                capacity = params.xyz.shape[0]
                if n_al > 0.7 * capacity and capacity < opt_cfg.max_capacity:
                    new_cap = min(int(capacity
                                      * opt_cfg.capacity_growth_factor),
                                  opt_cfg.max_capacity)
                    log_fn(f"[ITER {iteration}] capacity {capacity} → "
                           f"{new_cap}")
                    params, aux = pad_capacity(params, aux, new_cap)
                    adam = AdamState(count=adam.count,
                                     mu=_pad_tree(adam.mu, new_cap),
                                     nu=_pad_tree(adam.nu, new_cap))
                gate = iteration > opt_cfg.opacity_reset_interval
                if has_grow and gate:
                    params, mu, nu, aux, info = densify_and_prune_grow(
                        params, adam.mu, adam.nu, aux, gen,
                        scene.cameras_extent, densify_cfg, grow_cfg,
                        sphere_dirs, gate)
                else:
                    params, mu, nu, aux, info = densify_and_prune(
                        params, adam.mu, adam.nu, aux, gen,
                        scene.cameras_extent, densify_cfg, gate)
                if info["n_dropped"] > 0:
                    log_fn(f"[ITER {iteration}] WARNING: {info['n_dropped']} "
                           "densification slots dropped (capacity starved)")
                if iteration % 500 == 0:
                    log_fn(f"[ITER {iteration}] densify: "
                           f"+{info['n_cloned']} clone "
                           f"+{info['n_split']} split "
                           f"-{info['n_pruned']} prune "
                           f"→ {info['n_alive']} alive")
                history.setdefault("densify", []).append(
                    dict(info, iteration=iteration))
                sums = check_ranks_agree(params, adam, iteration, device)
                if sums:
                    history.setdefault("rank_checksums", []).append(
                        (iteration, sums))
                # keep alive slots a prefix so the render slice stays
                # valid, then re-bucket the render length
                params, mu, nu, aux = compact_state(params, mu, nu, aux)
                adam = adam._replace(mu=mu, nu=nu)
                new_rn = _render_bucket(int(num_alive(aux)),
                                        params.xyz.shape[0])
                if new_rn != render_n:
                    log_fn(f"[ITER {iteration}] render slice "
                           f"{render_n} → {new_rn}")
                    render_n = new_rn
                if stream_caps:
                    new_ic = _instance_bucket(
                        int(metrics.instance_load),
                        (render_n or params.xyz.shape[0]) + spec_rows,
                        raster_cfg)
                    if new_ic != inst_cap:
                        log_fn(f"[ITER {iteration}] instance cap "
                               f"{inst_cap or 'auto'} → {new_ic or 'auto'}")
                        inst_cap = new_ic
                if use_vis and vis_max > 0:
                    new_vc = _render_bucket(vis_max,
                                            render_n or params.xyz.shape[0],
                                            margin=1.3)
                    if new_vc != vis_cap:
                        log_fn(f"[ITER {iteration}] visible cap "
                               f"{vis_cap or 'off'} → {new_vc or 'off'}")
                        vis_cap = new_vc
                    vis_max = 0
            if (iteration % opt_cfg.opacity_reset_interval == 0
                    or (model_cfg.white_background
                        and iteration == opt_cfg.densify_from_iter)):
                whole()
                params, mu, nu = reset_opacity(params, adam.mu, adam.nu)
                adam = adam._replace(mu=mu, nu=nu)

        # ---- logging / eval / save ---------------------------------------
        # The loss is read only at log points: each read waits for the card.
        if iteration % 10 == 0 or iteration % run_cfg.log_every == 0:
            loss, oc_now, il_now, nf_now, mv_now, ov_now = (
                float(v) for v in (metrics.loss, metrics.overflow_capacity,
                                   metrics.instance_load,
                                   metrics.nonfinite_grad_rows,
                                   metrics.mask_visible,
                                   metrics.overflow_visible))
            if use_vis:
                vis_max = max(vis_max, int(mv_now))
                if ov_now > 0:
                    new_vc = _render_bucket(int(mv_now),
                                            render_n or params.xyz.shape[0],
                                            margin=1.3)
                    if new_vc != vis_cap:
                        log_fn(f"[ITER {iteration}] visible cap overflow "
                               f"({int(ov_now)} rows) → {new_vc or 'off'}")
                        vis_cap = new_vc
            ema_loss = 0.4 * loss + 0.6 * ema_loss
            history.setdefault("nonfinite_grad_rows", []).append(
                (iteration, int(nf_now)))
            if nf_now > 0:
                log_fn(f"[ITER {iteration}] WARNING: {int(nf_now)} rows had "
                       "non-finite gradients (zeroed by scrub_grads)")
            if stream_caps and oc_now > 0:
                # cap too tight: grow to the bucket covering the spilled load
                grown = _instance_bucket(
                    int(il_now + oc_now),
                    (render_n or params.xyz.shape[0]) + spec_rows,
                    raster_cfg)
                if grown != inst_cap:
                    inst_cap = grown
                    log_fn(f"[ITER {iteration}] instance cap overflow "
                           f"({int(oc_now)} entries) → {inst_cap}")
        if iteration % 10 == 0:
            pts = n_alive_now()
            if progress is not None:
                progress.set_postfix({"Loss": f"{ema_loss:.7f}",
                                      "pts": pts})
                progress.update(10)
        if iteration % run_cfg.log_every == 0:
            now = time.perf_counter()
            it_s = run_cfg.log_every / (now - t_last)
            t_last = now
            history["loss"].append((iteration, loss))
            history["iter_time"].append((iteration, it_s))
            if tb_writer is not None:
                tb_writer.add_scalar("train_loss_patches/l1_loss",
                                     float(metrics.l1), iteration)
                tb_writer.add_scalar("train_loss_patches/total_loss", loss,
                                     iteration)
                tb_writer.add_scalar("iter_time", 1000.0 / it_s, iteration)
        if iteration % 500 == 0:
            log_fn(f"[ITER {iteration}] loss {ema_loss:.5f} "
                   f"alive {n_alive_now()} "
                   f"({history['iter_time'][-1][1]:.1f} it/s)"
                   if history["iter_time"] else f"[ITER {iteration}]")

        if eval_now:
            _report(iteration, eval_state, scene, eval_cfg, eval_metrics,
                    eval_render, bg, active_sh, history, tb_writer,
                    model_cfg, log_fn, device, stream_caps, main_rank)
            ps_now = history["psnr_test"].get(iteration)
            # divergence guard: an unattended run stops and checkpoints
            # instead of training on garbage
            if run_cfg.divergence_psnr_drop > 0 and ps_now is not None:
                if ps_now > best_test_psnr:
                    best_test_psnr = ps_now
                    diverged_evals = 0
                elif ps_now < best_test_psnr - run_cfg.divergence_psnr_drop:
                    diverged_evals += 1
                    log_fn(f"[ITER {iteration}] divergence warning "
                           f"{diverged_evals}/{run_cfg.divergence_patience}: "
                           f"test PSNR {ps_now:.2f} vs best "
                           f"{best_test_psnr:.2f}")
                    if diverged_evals >= run_cfg.divergence_patience:
                        if model_cfg.model_path and main_rank:
                            save_checkpoint(
                                f"{model_cfg.model_path}/chkpnt{iteration}"
                                ".npz", params, adam, aux, iteration,
                                active_sh)
                        log_fn(f"[ITER {iteration}] ABORTING: test PSNR "
                               f"{run_cfg.divergence_patience} evals "
                               f">{run_cfg.divergence_psnr_drop} dB below "
                               f"best {best_test_psnr:.2f} — checkpoint "
                               "saved")
                        history["aborted"] = iteration
                        _write_history(model_cfg.model_path if main_rank
                                       else "", history)
                        return params, aux, scene, history
                else:
                    diverged_evals = 0

        if model_cfg.model_path and (
                iteration in run_cfg.save_iterations
                or iteration in run_cfg.checkpoint_iterations):
            whole()
        saving = main_rank and model_cfg.model_path
        if iteration in run_cfg.save_iterations and saving:
            log_fn(f"[ITER {iteration}] Saving Gaussians")
            scene.save(iteration, compact(params, aux))
        if iteration in run_cfg.checkpoint_iterations and saving:
            log_fn(f"[ITER {iteration}] Saving Checkpoint")
            save_checkpoint(f"{model_cfg.model_path}/chkpnt{iteration}.npz",
                            params, adam, aux, iteration, active_sh)

    whole()
    if profiler is not None:
        _stop_profiler(profiler, profile_dir)
    if progress is not None:
        progress.close()
    _write_history(model_cfg.model_path if main_rank else "", history)
    return params, aux, scene, history


def _report(iteration, eval_state, scene, eval_cfg, eval_metrics,
            eval_render, bg, active_sh, history, tb_writer, model_cfg,
            log_fn, device, stream_caps: bool,
            main_rank: bool = True) -> None:
    """The training report: L1 and PSNR over the full test set and 5 fixed
    train views, each split on its own clip-free layout (stream backend;
    the padded backends evaluate on ``eval_cfg`` as it is); shape
    diagnostics; the side-by-side validation image."""
    e_params, e_aux, e_rn = eval_state
    train_all = scene.get_train_cameras()
    configs = [("test", scene.get_test_cameras()),
               ("train", [train_all[idx % len(train_all)]
                          for idx in range(5, 30, 5)] if train_all else [])]
    test_layout, test_cap = None, 0
    e_layout, e_cap = None, 0
    for split, cams in configs:
        if not cams:
            continue
        if stream_caps:
            e_layout, e_cap = adaptive_eval_layout(
                e_params, e_aux, cams, eval_cfg,
                e_rn or e_params.xyz.shape[0])
        l1v, ps = evaluate_split(eval_metrics, e_params, e_aux, cams, bg,
                                 active_sh, device, render_n=e_rn,
                                 instance_cap=e_cap, tier_layout=e_layout)
        log_fn(f"[ITER {iteration}] Evaluating {split}: "
               f"L1 {l1v:.6f} PSNR {ps:.2f}")
        if tb_writer is not None:
            tb_writer.add_scalar(f"{split}/loss_viewpoint - l1_loss", l1v,
                                 iteration)
            tb_writer.add_scalar(f"{split}/loss_viewpoint - psnr", ps,
                                 iteration)
        history.setdefault(f"psnr_{split}", {})[iteration] = ps
        if split == "test":
            history["n_alive"][iteration] = int(num_alive(e_aux))
            test_layout, test_cap = e_layout, e_cap
    al = e_aux.alive
    if bool(al.any()):
        op = torch.sigmoid(e_params.opacity[al, 0]).cpu().numpy()
        sc = torch.exp(e_params.scaling[al]).max(dim=1).values.cpu().numpy()
        r = torch.linalg.vector_norm(e_params.xyz[al], dim=1).cpu().numpy()
        log_fn(f"[ITER {iteration}] diag: opacity med {np.median(op):.3f} "
               f"frac<0.005 {(op < 0.005).mean():.3f} | "
               f"scale med {np.median(sc):.4f} "
               f"p99 {np.percentile(sc, 99):.3f} max {sc.max():.2f} | "
               f"xyz-radius p99 {np.percentile(r, 99):.1f} max {r.max():.1f}")
    if scene.get_test_cameras():
        if tb_writer is not None:
            tb_writer.add_scalar("total_points", int(num_alive(e_aux)),
                                 iteration)
            tb_writer.add_histogram(
                "scene/opacity_histogram",
                torch.sigmoid(e_params.opacity[al, 0]).cpu().numpy(),
                iteration)
        if model_cfg.model_path and main_rank:
            _dump_val_image(model_cfg.model_path, iteration, eval_render,
                            e_params, e_aux, scene, bg, active_sh, device,
                            render_n=e_rn, instance_cap=test_cap,
                            tier_layout=test_layout)


def _clone(tree):
    return type(tree)(*[None if a is None else a.clone() for a in tree])


def _write_history(model_path: str, history: dict) -> None:
    if not model_path:
        return
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "history.json"), "w") as f:
        json.dump(history, f, indent=1)


def _instance_bucket(load: int, n_render: int, raster_cfg: RasterConfig,
                     margin: float = 1.35) -> int:
    """Stream instance capacity from the measured tile load: half-power-of-
    two buckets of margin·load (≥ 1024, CHUNK-aligned), clipped to the
    exact tier-enumeration bound."""
    from ..ops.binning import stream_instance_bound
    bound = stream_instance_bound(n_render,
                                  raster_cfg.max_tiles_per_gaussian,
                                  raster_cfg.tier_budgets,
                                  raster_cfg.tier_fracs)
    target = max(1024, int(load * margin))
    k = max(10, int(math.floor(math.log2(target))))
    for b in (1 << k, (3 << k) >> 1, 1 << (k + 1)):
        if b >= target:
            break
    return min(b, bound + (-bound) % 128)


def _render_bucket(n_alive: int, capacity: int, margin: float = 1.2) -> int:
    """Render-slice length: the smallest half-power-of-two (2^k or 1.5·2^k)
    ≥ margin·n_alive; 0 (= the full capacity) when that reaches it. The
    per-instance stages then track the live count, not the capacity."""
    target = max(1024, int(n_alive * margin))
    k = max(10, int(math.floor(math.log2(target))))
    for b in (1 << k, (3 << k) >> 1, 1 << (k + 1)):
        if b >= target:
            break
    return 0 if b >= capacity else b


def _pad_tree(tree, new_capacity: int):
    """Zero-pad every [C, ...] leaf of a params-shaped tuple."""
    def f(leaf):
        pad = leaf.new_zeros((new_capacity - leaf.shape[0],) + leaf.shape[1:])
        return torch.cat([leaf, pad])
    return type(tree)(*[None if a is None else f(a) for a in tree])


def evaluate_split(eval_metrics, params, aux, cameras, bg, sh_degree,
                   device, render_n: int = 0, instance_cap: int = 0,
                   tier_layout=None):
    """(mean L1, mean PSNR) over a camera list, one host read at the end."""
    vals = [torch.stack(eval_metrics(
        params, aux.alive, cam.view(device), cam.device_image(device), bg,
        width=cam.image.shape[2], height=cam.image.shape[1],
        sh_degree=sh_degree, render_n=render_n, instance_cap=instance_cap,
        tier_layout=tier_layout)) for cam in cameras]
    host = torch.stack(vals).cpu().numpy()
    return float(np.mean(host[:, 0])), float(np.mean(host[:, 1]))


def _make_tb_writer(model_path: str):
    """TensorBoard writer via tensorboardX, optional like the reference."""
    if not model_path:
        return None
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(model_path)
    except ImportError:
        print("Tensorboard not available: not logging progress")
        return None


def _gui_pump(model_cfg, params, aux, raster_cfg, sh_degree, iteration,
              max_iterations):
    """Network-viewer pump, once per iteration (train.py:55-68): serves the
    connected viewer's requests until one asks to go on training. No-op
    until ``viewer.network_gui.init()`` has been called by the CLI. A
    viewer that fails mid-request is dropped, and training goes on."""
    if network_gui.listener is None:
        return
    if network_gui.conn is None:
        network_gui.try_connect()
    device = params.xyz.device
    while network_gui.conn is not None:
        try:
            net_image_bytes = None
            (custom_cam, do_training, shs_py, cov_py, keep_alive,
             scaling_modifier) = network_gui.receive()
            if custom_cam is not None:
                from ..ops.render import render as render_fn
                bg = (torch.ones(3, device=device)
                      if model_cfg.white_background
                      else torch.zeros(3, device=device))
                # the viewer's toggles reach the render as in the reference
                # (train.py:60); the stream backend takes the exact instance
                # bound, so that a frame cannot overflow the slots
                rc = raster_cfg
                if rc.backend in ("stream", "auto"):
                    rc = rc._replace(instance_cap=eval_instance_cap(
                        params.xyz.shape[0], rc))
                with torch.no_grad():
                    out = render_fn(custom_cam.view(device),
                                    custom_cam.image_width,
                                    custom_cam.image_height, params, bg,
                                    sh_degree=sh_degree, alive=aux.alive,
                                    scale_modifier=scaling_modifier,
                                    convert_shs_python=bool(shs_py),
                                    compute_cov3d_python=bool(cov_py),
                                    raster_config=rc)
                net_image_bytes = network_gui.render_to_bytes(out["render"])
            network_gui.send(net_image_bytes, model_cfg.source_path)
            if do_training and (iteration < max_iterations or not keep_alive):
                break
        except Exception:
            network_gui.conn = None


def _make_progress(first_iter: int, iterations: int):
    """tqdm progress bar, optional like the reference."""
    try:
        from tqdm import tqdm
        return tqdm(range(first_iter, iterations), desc="Training progress")
    except ImportError:
        return None


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, profile_dir: str) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _dump_val_image(model_path, iteration, eval_render, params, aux, scene,
                    bg, sh_degree, device, render_n: int = 0,
                    instance_cap: int = 0, tier_layout=None):
    """Side-by-side [render | GT] validation PNG of the first test view."""
    from PIL import Image
    cam = scene.get_test_cameras()[0]
    img = eval_render(params, aux.alive, cam.view(device), bg,
                      width=cam.image.shape[2], height=cam.image.shape[1],
                      sh_degree=sh_degree, render_n=render_n,
                      instance_cap=instance_cap, tier_layout=tier_layout)
    side = np.concatenate([img.cpu().numpy(),
                           np.clip(np.asarray(cam.image), 0, 1)], axis=2)
    Image.fromarray((side.transpose(1, 2, 0) * 255).astype(np.uint8)).save(
        f"{model_path}/val_{iteration:05d}.png")
