"""``train``: the program's training step, driven as ``train/loop.py``
drives it between densification rounds: one training camera a step, in a
seeded random order over all of them (the loop's viewpoint stack), the
host reading the step's counters every ``host_read_every`` steps, closed
loop, the window ending in a synchronise.

Set-up builds the step, its parameters and Adam's state from the seed,
warms the step up through its first ``compared_steps`` steps (the
window's own call and feed, on different cameras) and hands that same
state to the window. The reference follows those first steps once the
window has closed; :func:`compare` holds what the program produced in
them against it.
"""

from __future__ import annotations

import importlib
import random
import statistics
from typing import NamedTuple

import torch

from gsbench import scene, work
from gsbench.bench import (background, camera_views, gap, pipeline_config,
                           ref_setup, rmse, tile_areas, worst_leaf)
from gsbench.reference import step as ref

STAT_FIELDS = {"accum": "xyz_grad_accum", "denom": "denom",
               "max_radii2d": "max_radii2d"}


class Readings(NamedTuple):
    """What one side produced over the compared steps."""
    losses: list      # each step's loss
    grads: dict       # norm by leaf of the first gradient as Adam got it
    change: dict      # norm by leaf of the parameters' change
    images: list      # each step's render [3, H, W], on the host
    stats: dict       # norm by statistic of its change ({} with stats off)


def compare(prog: Readings, ref_: Readings) -> dict:
    """The compared numbers of ``prog`` against the reference's: the
    worst step's loss gap; the worst leaf's gap of first-gradient norms
    and of change norms (the change over the leaves whose reference
    gradient reaches a thousandth of the median leaf's), each against the
    larger of the leaf's and the median leaf's reference norm; the worst
    step's image RMSE; and, where the statistics are on, the worst
    statistic's gap of change norms against its own."""
    med = statistics.median(ref_.grads.values())
    moved = [f for f in ref_.grads if ref_.grads[f] >= 1e-3 * med]
    out = {"loss_gap": max(gap(a, b) for a, b in
                           zip(prog.losses, ref_.losses)),
           "grad_gap": worst_leaf(prog.grads, ref_.grads, list(ref_.grads)),
           "change_gap": worst_leaf(prog.change, ref_.change, moved),
           "image_rmse": max(rmse(a, b) for a, b in
                             zip(prog.images, ref_.images))}
    if ref_.stats:
        out["stats_gap"] = worst_leaf(prog.stats, ref_.stats,
                                      list(ref_.stats), floor=False)
    return out


def judge(run, prog: Readings) -> None:
    """The run's checks: ``prog`` (the program's readings, or what is put
    in its place) against the reference's, and the window's counters."""
    run.checks = compare(prog, run.reference)
    run.checks["clipped"] = run.counts["clipped"]
    run.checks["nonfinite_rows"] = run.counts["nonfinite"]


class StepImages:
    """Keeps the image each step renders, taken where the step hands it
    to its loss (``l1_loss(image, target)`` in ``train/step.py`` and
    ``train/grow_step.py``), while the compared steps run. The window
    runs the step untouched."""

    MODULES = ("mvs_gaussian_splatting_tpu_torch.train.step",
               "mvs_gaussian_splatting_tpu_torch.train.grow_step")

    def __enter__(self):
        self.images, self.saved = [], []
        for name in self.MODULES:
            mod = importlib.import_module(name)
            orig = mod.l1_loss

            def keep(img, gt, _orig=orig):
                self.images.append(img.detach().clone())
                return _orig(img, gt)
            self.saved.append((mod, orig))
            mod.l1_loss = keep
        return self

    def __exit__(self, *exc):
        for mod, orig in self.saved:
            mod.l1_loss = orig


def camera_order(n_views: int, steps: int, seed: int) -> list:
    """The loop's viewpoint stack: a seeded random order over every
    training camera, drawn again when it runs out."""
    rng = random.Random(seed)
    out = []
    while len(out) < steps:
        stack = list(range(n_views))
        while stack and len(out) < steps:
            out.append(stack.pop(rng.randint(0, len(stack) - 1)))
    return out


def norms(a: dict, b: dict) -> dict:
    return {k: float(torch.linalg.vector_norm((a[k] - b[k]).float()))
            for k in a}


def run(run):
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
        GaussianAux, GaussianParams)
    from mvs_gaussian_splatting_tpu_torch.models.grow import GrowConfig
    from mvs_gaussian_splatting_tpu_torch.ops.render import \
        render as port_render
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    from mvs_gaussian_splatting_tpu_torch.train.grow_step import \
        make_spec_train_step
    from mvs_gaussian_splatting_tpu_torch.train.loop import (
        _instance_bucket, raster_config_from_pipe)
    from mvs_gaussian_splatting_tpu_torch.train.optim import AdamState
    from mvs_gaussian_splatting_tpu_torch.train.step import make_train_step

    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    it0 = tr["iteration"]
    opt = OptimizationConfig(**cfg["optimization"])
    pipe = pipeline_config(cfg)
    rc = raster_config_from_pipe(pipe)
    grow = cfg.get("grow")
    # the loop's speculative window (train/loop.py)
    spec_on = bool(grow) and (
        it0 > opt.densify_from_iter - opt.densification_interval - 1
        and it0 < opt.densify_until_iter and it0 > opt.opacity_reset_interval)
    if spec_on != tr["speculative"]:
        raise ValueError(f"{run.cell.name}: iteration {it0} is "
                         f"{'' if spec_on else 'not '}in the speculative "
                         "window, against the traffic file")
    spec = pipe.spec_capacity if spec_on else 0

    cap = scene.make_capture(cfg, it0, run.seed, dev)
    views = camera_views(cap.train_views)
    n = cfg["n_gaussians"]
    loads, _ = tile_areas(cap.params, cap.train_views, cfg, dev)
    inst_cap = _instance_bucket(max(loads), n + 2 * spec, rc)
    bg = background(cfg, dev)
    # the targets: the program's exact render of the starting state; the
    # training render is held against the reference's (image_rmse)
    exact = rc._replace(fast_math=False, instance_cap=inst_cap)
    start = GaussianParams(**cap.params)
    with torch.no_grad():
        targets = scene.make_targets(
            cfg, range(len(views)), run.seed, dev,
            lambda i: port_render(views[i], cfg["width"], cfg["height"],
                                  start, bg, sh_degree=cfg["sh_degree"],
                                  raster_config=exact)["render"])
    del start
    run.n_rows = n + 2 * spec
    run.n_params = sum(v[0].numel() for v in cap.params.values()) * n
    run.grow_rows = spec
    lr_scale = cap.spatial_lr_scale
    if spec_on:
        step_fn = make_spec_train_step(
            opt, rc, lr_scale, GrowConfig(grow_dir=True,
                                          num_dirs=grow["num_dirs"]),
            cap.sphere_dirs, spec, lr_scale)
        gen = torch.Generator(device=dev)
        gen.manual_seed(run.seed + 3)
        extra = {"generator": gen}
    else:
        step_fn = make_train_step(opt, rc, lr_scale)
        extra = {}
    if "step" in run.hooks:
        step_fn = run.hooks["step"](step_fn)
    kw = dict(width=cfg["width"], height=cfg["height"],
              sh_degree=cfg["sh_degree"], render_n=0, instance_cap=inst_cap,
              **extra)
    n_cmp = tr["compared_steps"]
    n_max = n_cmp + tr["max_window_steps"]
    order = camera_order(len(views), n_max, run.seed + 2)

    params0 = GaussianParams(**cap.params)
    adam0 = AdamState(count=torch.tensor(cap.count, dtype=torch.int32,
                                         device=dev),
                      mu=GaussianParams(**cap.mu), nu=GaussianParams(**cap.nu))
    aux0 = GaussianAux(alive=torch.ones(n, dtype=torch.bool, device=dev),
                       max_radii2d=cap.max_radii2d,
                       xyz_grad_accum=cap.accum, denom=cap.denom)
    keys = list(cap.params)
    del cap
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    acc = {"clipped": zero.clone(), "nonfinite": zero.clone(),
           "failed": zero.clone(), "overflow_tiles": zero.clone(),
           "overflow_capacity": zero.clone()}
    state = [params0, adam0, aux0]

    def call(k: int):
        p, a, x = state
        cam = order[k]
        it = it0 + k
        out = step_fn(p, a, x, views[cam], targets[cam], bg, it,
                      it < opt.densify_until_iter, **kw)
        state[:] = out[:3]
        m = out[3]
        clipped = (m.overflow_tiles.long() + m.overflow_capacity.long()
                   + m.overflow_visible.long())
        acc["clipped"] += clipped
        acc["overflow_tiles"] += m.overflow_tiles.long()
        acc["overflow_capacity"] += m.overflow_capacity.long()
        acc["nonfinite"] += m.nonfinite_grad_rows.long()
        acc["failed"] += ((clipped > 0) | (m.nonfinite_grad_rows > 0)).long()
        return m

    losses, g1 = [], {}
    with StepImages() as kept:
        for k in range(n_cmp):
            m = call(k)
            losses.append(float(m.loss))
            if k == 0:
                mu1 = state[1].mu
                g1 = {f: float(torch.linalg.vector_norm(
                    (getattr(mu1, f) - 0.9 * getattr(adam0.mu, f)) / 0.1))
                    for f in keys}
                adam0 = None
    if len(kept.images) != n_cmp:
        raise RuntimeError(f"{len(kept.images)} images for {n_cmp} compared "
                           "steps: the step no longer hands its render to "
                           "l1_loss, where the image check takes it")
    images = [im.cpu() for im in kept.images]
    del kept
    change = {f: float(torch.linalg.vector_norm(
        getattr(state[0], f) - getattr(params0, f))) for f in keys}
    stats = {}
    if it0 < opt.densify_until_iter:
        stats = norms({k: getattr(state[2], f) for k, f in
                       STAT_FIELDS.items()},
                      {k: getattr(aux0, f) for k, f in STAT_FIELDS.items()})
    params0 = aux0 = None
    run.close_setup()

    read_every = tr["host_read_every"]

    def body(j: int):
        m = call(n_cmp + j)
        if (n_cmp + j + 1) % read_every == 0:
            # the loop's host reads (train/loop.py's log points)
            [float(v) for v in (m.loss, m.overflow_capacity,
                                m.instance_load, m.nonfinite_grad_rows,
                                m.mask_visible, m.overflow_visible)]

    steps, secs = run.window(body, tr["trace_steps"])
    if n_cmp + steps > n_max:
        raise RuntimeError("the window ran past max_window_steps")
    run.close_window(steps, secs)
    run.values["train_step_ms"] = secs / steps * 1e3
    run.counts = {k: int(v) for k, v in acc.items()}
    run.failed = run.counts["failed"]
    state.clear()
    del targets, step_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference follows the first steps ----------------------------
    run.program = Readings(losses, g1, change, images, stats)
    run.reference = follow_reference(cfg, tr, run.seed, order, dev)
    judge(run, run.program)
    run.readings = {
        "losses": losses, "ref_losses": run.reference.losses,
        "grad_norms": g1, "ref_grad_norms": run.reference.grads,
        "change_norms": change, "ref_change_norms": run.reference.change,
        "stat_norms": stats, "ref_stat_norms": run.reference.stats,
        "image_rmse": [rmse(a, b) for a, b in
                       zip(images, run.reference.images)],
        "cameras": order[:n_cmp], "instance_cap": inst_cap,
        "max_load": max(loads), "counters": run.counts}

    if run.trace_on:
        cap = scene.make_capture(cfg, it0, run.seed, dev)
        setup = ref_setup(cfg, dev)
        picks = random.Random(run.seed + 4).sample(
            range(steps), min(tr["work_views"], steps))
        for j in sorted(picks):
            _, pairs, rows = ref.render_view(
                cap.params, cap.train_views[order[n_cmp + j]], setup)
            run.work.append((j, work.ViewWork(pairs, rows,
                                              cfg["width"] * cfg["height"])))


def follow_reference(cfg: dict, tr: dict, seed: int, order: list, dev,
                     dtype=torch.float32, loss_rows=None) -> Readings:
    """The reference's first ``compared_steps`` steps from the seed's
    state on the cameras ``order``. ``dtype`` below float32 is the
    control; ``loss_rows`` plants the half-batch fault."""
    it0 = tr["iteration"]
    n_cmp = tr["compared_steps"]
    until = cfg["optimization"]["densify_until_iter"]
    cap = scene.make_capture(cfg, it0, seed, dev)
    spec = cfg["pipeline"]["spec_capacity"] if tr["speculative"] else 0
    setup = ref_setup(cfg, dev, cap.spatial_lr_scale, cap.sphere_dirs, spec)
    cams = order[:n_cmp]
    tgt = scene.make_targets(
        cfg, cams, seed, dev,
        lambda i: ref.render_view(cap.params, cap.train_views[i], setup)[0])
    gts = dict(zip(cams, tgt))
    st = ref.to_dtype(ref.State(cap.params, cap.mu, cap.nu, cap.count,
                                cap.accum, cap.denom, cap.max_radii2d), dtype)
    cams_of = cap.train_views
    del cap
    p0 = dict(st.params)
    s0 = {"accum": st.accum, "denom": st.denom,
          "max_radii2d": st.max_radii2d}
    losses, g1, images = [], {}, []
    for k in range(n_cmp):
        out = ref.train_step(st, cams_of[order[k]], gts[order[k]],
                             it0 + k, setup, it0 + k < until, loss_rows)
        losses.append(out.loss)
        images.append(out.image.float().cpu())
        if k == 0:
            g1 = {f: float(torch.linalg.vector_norm(g.float()))
                  for f, g in out.grads.items()}
        st = out.state
    change = norms(st.params, p0)
    stats = {}
    if it0 < until:
        stats = norms({"accum": st.accum, "denom": st.denom,
                       "max_radii2d": st.max_radii2d}, s0)
    return Readings(losses, g1, change, images, stats)
