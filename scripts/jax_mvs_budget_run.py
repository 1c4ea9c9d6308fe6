"""Train the JAX package's MVS branch on the CPU as its own loop does on an
accelerator, and print whether the model learns: the reference run for
``scripts/torch_mvs_budget_sweep.py``.

``mvs/train.py:train_mvs`` runs unchanged on the package's own synthetic
groups with ``backend="stream"``, its raster configuration on an
accelerator; the stream's Pallas kernels run in interpret mode, as the
package's tests run them on the CPU. Before training, the script saves the
loop's initial variables (``model.init`` with the loop's key) as an
``.npz`` of "/"-joined paths, so the port can start from the same weights,
and counts the tile slots the raster configuration clips on the first
training group. At the end it prints whether the weights are finite and the
largest predicted log-scale on that group, before and after.

    python scripts/jax_mvs_budget_run.py --size 128x96 \\
        --init_out runs_mvs/init_128.npz

This script imports JAX and the JAX package, and only those: it is not part
of the port.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="128x96")
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--num_depths", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init_out", default="",
                    help="where to save the initial variables (.npz)")
    args = ap.parse_args(argv)
    width, height = (int(v) for v in args.size.split("x"))

    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
    jrast._rasterize_stream = functools.partial(jrast._rasterize_stream,
                                                interpret=True)
    from mvs_gaussian_splatting_tpu.mvs import train as jtrain
    from mvs_gaussian_splatting_tpu.mvs.dataset import make_synthetic_groups
    from mvs_gaussian_splatting_tpu.mvs.model import MVSGaussianModel
    from mvs_gaussian_splatting_tpu.ops.preprocess import preprocess

    groups = make_synthetic_groups(n_groups=args.groups, width=width,
                                   height=height, seed=args.seed)
    n_eval = max(1, len(groups) // 8)
    eval_groups, train_groups = groups[:n_eval], groups[n_eval:]
    cfg = jtrain.MVSConfig(iterations=args.iterations, lr=args.lr,
                           eval_every=args.eval_every, seed=args.seed,
                           num_depths=args.num_depths, backend="stream")

    # the loop's initial variables and the clipped share of its first group
    model = MVSGaussianModel(num_depths=cfg.num_depths,
                             feat_dims=cfg.feat_dims)
    b0 = jtrain.group_to_batch(train_groups[0])
    inputs = (b0.ref_image, b0.src_images, b0.k_ref_feat, b0.k_src_feats,
              b0.rel_rs, b0.rel_ts, b0.near, b0.far)
    variables = model.init(jax.random.PRNGKey(cfg.seed), *inputs)
    if args.init_out:
        os.makedirs(os.path.dirname(args.init_out) or ".", exist_ok=True)
        flat = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
        np.savez(args.init_out, **{k: np.asarray(v) for k, v in flat.items()})
    rc = jrast.RasterConfig(tile_capacity=512, max_tiles_per_gaussian=16,
                            tile_batch=32, backend="stream")

    @jax.jit
    def log_scale_max(vs):
        return jnp.max(model.apply(vs, *inputs)["log_scaling"])

    @jax.jit
    def clip_share(vs):
        out = model.apply(vs, *inputs)
        xyz_w, rot_w = jtrain.gaussians_to_world(out, b0.w2c_ref)
        p = preprocess(xyz_w, jax.nn.sigmoid(out["opacity_logit"][:, 0]),
                       b0.target_cam, width, height,
                       scales=jnp.exp(out["log_scaling"]), rotations=rot_w,
                       colors_precomp=out["colors"])
        area = jnp.prod(jnp.maximum(p.rect_max - p.rect_min, 0), axis=-1)
        _, aux = jtrain.render_predicted(out, b0, width, height, rc)
        return aux["overflow_tiles"], jnp.sum(area * p.mask)

    clipped, need = (int(v) for v in clip_share(variables))

    t0 = time.time()
    start_scale = float(log_scale_max(variables))
    variables, history = jtrain.train_mvs(
        cfg, train_groups, eval_groups, log_fn=lambda s: print(s, flush=True))
    losses = [v for _, v in history["loss"]]
    weights_finite = all(bool(np.isfinite(np.asarray(v)).all())
                         for v in jax.tree.leaves(variables))
    print(json.dumps({
        "size": [width, height], "budget": "recipe", "package": "jax",
        "gaussians": int(np.prod(b0.ref_image.shape[1:])) // 16,
        "clipped_tile_slots": clipped, "tile_need": need,
        "clipped_share": clipped / max(need, 1),
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_ratio": losses[-1] / losses[0],
        "psnr_eval": {int(k): float(v)
                      for k, v in history["psnr_eval"].items()},
        "finite": bool(np.isfinite(losses).all()),
        "weights_finite": weights_finite,
        "log_scale_max": [start_scale, float(log_scale_max(variables))],
        "num_depths": cfg.num_depths, "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
