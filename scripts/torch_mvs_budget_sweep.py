"""Train the port's MVS branch at several image sizes under two tile budgets
and print, for each run, how much of the predicted Gaussians' tile need
the budget clips and whether the model learns.

The budgets: ``recipe`` is the MVS loop's own raster configuration
(``mvs/train.py:raster_config``: 16 tiles a Gaussian, tiers 4/12 at
0.25/0.1, the stream backend in exact mode); ``flat`` gives every Gaussian
up to min(512, all tiles of the image) tiles and the stream room for all of
them, so nothing clips. The loop is ``train_mvs``'s (its group sampling,
schedule, logging every 10 steps and evals), built on
``make_mvs_train_step``, which takes the raster configuration as an
argument. With ``--init`` the model starts from a flax variable tree saved
as an ``.npz`` of "/"-joined paths (for example by
``scripts/jax_mvs_budget_run.py``), carried across by ``params_from_flax``.

    python scripts/torch_mvs_budget_sweep.py --sizes 128x96,640x480 \\
        --out chiprun_out/mvs_sweep.jsonl

Each run prints one JSON line: the clipped share of the first training
group's tile need at the start, the logged losses' first and last values
and their ratio, the eval PSNRs, whether the weights are finite at the end,
the largest predicted log-scale on the first training group at the start
and at the end, and the mean opacity of the eval groups' Gaussians at the
end. ``--watch`` checks every step's gradients instead and, at the first
non-finite one, names the stages whose gradients are non-finite, on the
card and on a CPU copy (the plain versions) from the same state;
``--compare`` trains nothing and holds one group's step on the card
against a CPU copy: the predicted Gaussians, the image and the Gaussians'
gradients when both render the card's Gaussians, and the image and the
weights' gradients end to end (``flat`` there takes every Gaussian's
whole rect).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mvs_gaussian_splatting_tpu_torch.mvs import train as mt  # noqa: E402
from mvs_gaussian_splatting_tpu_torch.mvs.dataset import \
    make_synthetic_groups  # noqa: E402
from mvs_gaussian_splatting_tpu_torch.mvs.model import (  # noqa: E402
    MVSGaussianModel, params_from_flax)
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import \
    preprocess  # noqa: E402
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
    RasterConfig  # noqa: E402


def budget_config(name: str, device, width: int, height: int,
                  n_gaussians: int) -> RasterConfig:
    rc = mt.raster_config(device, "stream")
    if name == "recipe":
        return rc
    tiles = min(512, -(-width // rc.tile_w) * -(-height // rc.tile_h))
    bound = n_gaussians * tiles
    return rc._replace(max_tiles_per_gaussian=tiles, tier_budgets=(),
                       tier_fracs=(), instance_cap=bound + (-bound) % 128)


def load_init(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_flax(tree)


@torch.no_grad()
def clip_share(model, batch, width, height, rc):
    """(clipped tile slots, tile need) of one group's predicted Gaussians."""
    out = mt.apply_model(model, batch)
    xyz_w, rot_w = mt.gaussians_to_world(out, batch.w2c_ref)
    p = preprocess(xyz_w, torch.sigmoid(out["opacity_logit"][:, 0]),
                   batch.target_cam, width, height,
                   scales=torch.exp(out["log_scaling"]), rotations=rot_w,
                   colors_precomp=out["colors"], tile_w=rc.tile_w,
                   tile_h=rc.tile_h)
    area = (p.rect_max - p.rect_min).clamp_min(0).prod(-1)
    need = int((area * p.mask).sum())
    _, aux = mt.render_predicted(out, batch, width, height, rc)
    return int(aux["overflow_tiles"]), need


@torch.no_grad()
def log_scale_max(model, batch) -> float:
    return float(mt.apply_model(model, batch)["log_scaling"].max())


def run(width, height, budget, args, device):
    groups = make_synthetic_groups(n_groups=args.groups, width=width,
                                   height=height, seed=args.seed,
                                   device=device)
    n_eval = max(1, len(groups) // 8)
    batches = [mt.group_to_batch(g, device) for g in groups[n_eval:]]
    eval_batches = [mt.group_to_batch(g, device) for g in groups[:n_eval]]
    cfg = mt.MVSConfig(iterations=args.iterations, lr=args.lr,
                       eval_every=args.eval_every, seed=args.seed,
                       num_depths=args.num_depths)
    model = MVSGaussianModel(num_depths=cfg.num_depths,
                             feat_dims=cfg.feat_dims, seed=cfg.seed)
    if args.init:
        model.load_state_dict(load_init(args.init))
    model = model.to(device)
    n = mt.apply_model(model, batches[0])["xyz_cam"].shape[0]
    rc = budget_config(budget, device, width, height, n)
    clipped, need = clip_share(model, batches[0], width, height, rc)
    start_scale = log_scale_max(model, batches[0])
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-8)
    train_step, eval_step = mt.make_mvs_train_step(model, cfg, rc, width,
                                                   height, optimizer)
    rng = np.random.RandomState(cfg.seed)
    losses, evals = [], {}
    t0 = time.time()
    for it in range(1, cfg.iterations + 1):
        loss, _ = train_step(batches[rng.randint(len(batches))], it - 1)
        if it % 10 == 0 or it == cfg.iterations:
            losses.append(float(loss))
        if it % max(1, cfg.eval_every) == 0 or it == cfg.iterations:
            evals[it] = float(np.mean([float(eval_step(b)[0])
                                       for b in eval_batches]))
    with torch.no_grad():
        opacity = float(np.mean([
            float(torch.sigmoid(mt.apply_model(model, b)["opacity_logit"])
                  .mean()) for b in eval_batches]))
    weights_finite = all(bool(torch.isfinite(v).all())
                         for v in model.state_dict().values())
    return {"size": [width, height], "budget": budget, "gaussians": n,
            "num_depths": cfg.num_depths,
            "clipped_tile_slots": clipped, "tile_need": need,
            "clipped_share": clipped / max(need, 1),
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_ratio": losses[-1] / losses[0], "psnr_eval": evals,
            "opacity_mean_end": opacity, "finite": bool(
                np.isfinite(losses).all()), "weights_finite": weights_finite,
            "log_scale_max": [start_scale,
                              log_scale_max(model, batches[0])],
            "seconds": round(time.time() - t0, 1)}


def step_stats(model, batch, width, height, rc):
    """Ranges of one group's predicted Gaussians and of their projection."""
    with torch.no_grad():
        out = mt.apply_model(model, batch)
        xyz_w, rot_w = mt.gaussians_to_world(out, batch.w2c_ref)
        p = preprocess(xyz_w, torch.sigmoid(out["opacity_logit"][:, 0]),
                       batch.target_cam, width, height,
                       scales=torch.exp(out["log_scaling"]),
                       rotations=rot_w, colors_precomp=out["colors"],
                       tile_w=rc.tile_w, tile_h=rc.tile_h)
    m = p.mask
    return {"log_scale_max": float(out["log_scaling"].max()),
            "log_scale_min": float(out["log_scaling"].min()),
            "rotation_norm_min": float(out["rotation"].norm(dim=-1).min()),
            "opacity_logit_range": [float(out["opacity_logit"].min()),
                                    float(out["opacity_logit"].max())],
            "outputs_finite": {k: bool(torch.isfinite(v).all())
                               for k, v in out.items()},
            "visible": int(m.sum()),
            "radius_max": float(p.radius[m].max()) if m.any() else 0.0,
            "conic_abs_max": float(p.conic[m].abs().max()) if m.any()
            else 0.0}


def grad_sources(model, batch, cfg, width, height, rc, device):
    """Which stage's gradient is first non-finite on one step: the render's
    projected inputs, the world-frame Gaussians, or the model's outputs."""
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import rasterize
    from mvs_gaussian_splatting_tpu_torch.utils.losses import l1_loss, ssim
    model.zero_grad(set_to_none=True)
    out = mt.apply_model(model, batch)
    for v in out.values():
        v.retain_grad()
    xyz_w, rot_w = mt.gaussians_to_world(out, batch.w2c_ref)
    xyz_w.retain_grad()
    p = preprocess(xyz_w, torch.sigmoid(out["opacity_logit"][:, 0]),
                   batch.target_cam, width, height,
                   scales=torch.exp(out["log_scaling"]), rotations=rot_w,
                   colors_precomp=out["colors"], tile_w=rc.tile_w,
                   tile_h=rc.tile_h)
    named = {k: getattr(p, k) for k in ("xy", "conic", "rgb", "opacity")}
    for v in named.values():
        v.retain_grad()
    img, aux = rasterize(p, width, height, torch.zeros(3, device=device), rc)
    img.retain_grad()
    loss = ((1.0 - cfg.lambda_dssim) * l1_loss(img, batch.target_image)
            + cfg.lambda_dssim * (1.0 - ssim(img, batch.target_image)))
    loss.backward()

    def finite(t):
        return None if t.grad is None else bool(torch.isfinite(t.grad).all())
    bad_rows = {}
    for k, v in named.items():
        if v.grad is not None:
            rows = (~torch.isfinite(v.grad.reshape(v.shape[0], -1))).any(-1)
            bad_rows[k] = int(rows.sum())
    return {"loss": float(loss), "image": finite(img),
            "projected": {k: finite(v) for k, v in named.items()},
            "projected_bad_rows": bad_rows, "xyz_world": finite(xyz_w),
            "outputs": {k: finite(v) for k, v in out.items()},
            "params_bad": [k for k, q in model.named_parameters()
                           if q.grad is not None
                           and not torch.isfinite(q.grad).all()],
            "overflow_tiles": int(aux["overflow_tiles"]),
            "overflow_capacity": int(aux["overflow_capacity"])}


def watch(width, height, budget, args, device):
    """Train as ``run`` does, checking every step's gradients; at the first
    non-finite one, locate its stage on the card and on a CPU copy (the
    plain versions) from the same state."""
    groups = make_synthetic_groups(n_groups=args.groups, width=width,
                                   height=height, seed=args.seed,
                                   device=device)
    n_eval = max(1, len(groups) // 8)
    train_groups = groups[n_eval:]
    batches = [mt.group_to_batch(g, device) for g in train_groups]
    cfg = mt.MVSConfig(iterations=args.iterations, lr=args.lr,
                       eval_every=args.eval_every, seed=args.seed,
                       num_depths=args.num_depths)
    model = MVSGaussianModel(num_depths=cfg.num_depths,
                             feat_dims=cfg.feat_dims, seed=cfg.seed)
    if args.init:
        model.load_state_dict(load_init(args.init))
    model = model.to(device)
    n = mt.apply_model(model, batches[0])["xyz_cam"].shape[0]
    rc = budget_config(budget, device, width, height, n)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-8)
    rng = np.random.RandomState(cfg.seed)
    trace = []
    for it in range(1, cfg.iterations + 1):
        gi = rng.randint(len(batches))
        batch = batches[gi]
        if it % 10 == 1:
            trace.append({"it": it, **step_stats(model, batch, width,
                                                 height, rc)})
        for group in optimizer.param_groups:
            group["lr"] = mt.lr_at(cfg, it - 1)
        state = copy.deepcopy(model.state_dict())
        optimizer.zero_grad(set_to_none=True)
        loss, _ = mt.mvs_loss(model, batch, cfg, rc, width, height)
        loss.backward()
        bad = [k for k, q in model.named_parameters()
               if not torch.isfinite(q.grad).all()]
        if bad:
            model.load_state_dict(state)
            rec = {"size": [width, height], "budget": budget,
                   "first_bad_iteration": it, "group": gi,
                   "loss": float(loss), "params_bad": bad,
                   "stats": step_stats(model, batch, width, height, rc),
                   "card": grad_sources(model, batch, cfg, width, height,
                                        rc, device)}
            cpu = copy.deepcopy(model).cpu()
            rec["cpu"] = grad_sources(
                cpu, mt.group_to_batch(train_groups[gi], "cpu"), cfg, width,
                height, rc._replace(backend="stream"), torch.device("cpu"))
            if args.out:
                torch.save({"state": state, "iteration": it, "group": gi},
                           os.path.splitext(args.out)[0] + "_state.pt")
            rec["trace"] = trace
            return rec
        optimizer.step()
    return {"size": [width, height], "budget": budget,
            "first_bad_iteration": None, "trace": trace}


def compare(width, height, budget, args, device):
    """One group's train step on the card against a CPU copy (the plain
    versions): the predicted Gaussians, then the image and the gradients
    with respect to the Gaussians when both render the card's Gaussians,
    then the image and the weights' gradients end to end."""
    from mvs_gaussian_splatting_tpu_torch.utils.losses import l1_loss, ssim
    group = make_synthetic_groups(n_groups=1, width=width, height=height,
                                  seed=args.seed, device=device)[0]
    cfg = mt.MVSConfig(seed=args.seed, num_depths=args.num_depths)
    model = MVSGaussianModel(num_depths=cfg.num_depths,
                             feat_dims=cfg.feat_dims, seed=cfg.seed)
    if args.init:
        model.load_state_dict(load_init(args.init))
    cpu = torch.device("cpu")
    models = {device: model.to(device), cpu: copy.deepcopy(model).cpu()}
    batches = {d: mt.group_to_batch(group, d) for d in models}
    with torch.no_grad():
        outs = {d: mt.apply_model(m, batches[d]) for d, m in models.items()}
    n = outs[device]["xyz_cam"].shape[0]
    if budget == "recipe":
        rcs = {device: mt.raster_config(device, "stream")}
    else:
        # every Gaussian's whole rect: the image's tiles, room for the need
        rc = mt.raster_config(device, "stream")
        tiles = -(-width // rc.tile_w) * -(-height // rc.tile_h)
        _, need = clip_share(models[device], batches[device], width, height,
                             rc)
        cap = int(need * 1.05) + 128
        rcs = {device: rc._replace(max_tiles_per_gaussian=tiles,
                                   tier_budgets=(), tier_fracs=(),
                                   instance_cap=cap - cap % 128)}
    rcs[cpu] = rcs[device]._replace(backend="stream")

    def loss_of(img, target):
        return ((1.0 - cfg.lambda_dssim) * l1_loss(img, target)
                + cfg.lambda_dssim * (1.0 - ssim(img, target)))

    def image_gap(a, b):
        d = (a - b).abs()
        return {"max_abs": float(d.max()),
                "pixels_over_1e-4": int((d > 1e-4).sum()),
                "p999": float(torch.quantile(d.flatten()[::7], 0.999))}

    same, e2e = {}, {}
    for d in models:
        out = {k: v.detach().to(d).requires_grad_(True)
               for k, v in outs[device].items()}
        img, aux = mt.render_predicted(out, batches[d], width, height, rcs[d])
        loss_of(img, batches[d].target_image).backward()
        same[d] = (img.detach().cpu(), {k: v.grad.cpu() for k, v in
                                        out.items() if v.grad is not None},
                   int(aux["overflow_tiles"]), int(aux["overflow_capacity"]))
        m = models[d]
        m.zero_grad(set_to_none=True)
        img, _ = mt.render_predicted(mt.apply_model(m, batches[d]),
                                     batches[d], width, height, rcs[d])
        loss_of(img, batches[d].target_image).backward()
        e2e[d] = (img.detach().cpu(), {k: q.grad.cpu()
                                       for k, q in m.named_parameters()})

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return {"size": [width, height], "budget": budget, "gaussians": n,
            "instances_clipped": [same[device][2], same[device][3]],
            "gaussians_rel": max(rel(outs[device][k].cpu(), outs[cpu][k])
                                 for k in outs[cpu]),
            "same_gaussians_image": image_gap(same[device][0], same[cpu][0]),
            "same_gaussians_grad_rel": {
                k: rel(same[device][1][k], same[cpu][1][k])
                for k in same[cpu][1]},
            "end_to_end_image": image_gap(e2e[device][0], e2e[cpu][0]),
            "end_to_end_grad_rel": max(rel(e2e[device][1][k], e2e[cpu][1][k])
                                       for k in e2e[cpu][1])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="128x96,256x192,320x240,640x480")
    ap.add_argument("--budgets", default="recipe,flat")
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--num_depths", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", default="",
                    help=".npz of a flax variable tree to start from")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--watch", action="store_true",
                    help="check every step's gradients and locate the "
                         "first non-finite one")
    ap.add_argument("--compare", action="store_true",
                    help="one group's step on the card against a CPU "
                         "copy, with no training")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    for size in args.sizes.split(","):
        width, height = (int(v) for v in size.split("x"))
        for budget in args.budgets.split(","):
            fn = compare if args.compare else watch if args.watch else run
            rec = fn(width, height, budget, args, device)
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
