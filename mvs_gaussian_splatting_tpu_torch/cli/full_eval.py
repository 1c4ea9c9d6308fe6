"""Full evaluation harness over the standard benchmark scenes.

Port of the JAX package's ``cli/full_eval.py`` (the reference's
full_eval.py:15-75): train → render → metrics over MipNeRF-360 (×9, at
images_4/images_2), Tanks&Temples (×2) and Deep Blending (×2), and any
``--scenes``, in process through the port's ``cli/train.py``,
``cli/render.py`` and ``eval/metrics.py``. Same flags plus ``--device``
(default ``cuda``).

    python -m mvs_gaussian_splatting_tpu_torch.cli.full_eval \\
        --scenes <scene> [...] [--iterations N] [--output_path DIR]

Each stage's wall time, summed over the scenes, is printed and returned.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None):
    """Runs the chain; returns {"model_paths": [...], "seconds": {stage:
    wall seconds}}."""
    parser = argparse.ArgumentParser(description="Full evaluation script")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default="")
    parser.add_argument("--tanksandtemples", "-tat", default="")
    parser.add_argument("--deepblending", "-db", default="")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--scenes", nargs="*", default=[],
                        help="explicit COLMAP scene dirs (appended to any "
                             "dataset-root scenes; images dir 'images')")
    parser.add_argument("--iterations", type=int, default=30_000,
                        help="training iterations per scene (the reference "
                             "recipe is 30K; short runs exercise the full "
                             "chain on hardware)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every stage (default cuda)")
    args = parser.parse_args(argv)

    scenes = []
    if args.mipnerf360:
        for s in MIPNERF360_OUTDOOR:
            scenes.append((os.path.join(args.mipnerf360, s), "images_4"))
        for s in MIPNERF360_INDOOR:
            scenes.append((os.path.join(args.mipnerf360, s), "images_2"))
    if args.tanksandtemples:
        for s in TANKS_AND_TEMPLES:
            scenes.append((os.path.join(args.tanksandtemples, s), "images"))
    if args.deepblending:
        for s in DEEP_BLENDING:
            scenes.append((os.path.join(args.deepblending, s), "images"))
    for s in args.scenes:
        scenes.append((s, "images"))
    if not scenes:
        parser.error("no dataset roots given")

    from ..eval import metrics as metrics_mod
    from . import render as render_cli
    from . import train as train_cli

    seconds = {"train": 0.0, "render": 0.0, "metrics": 0.0}
    model_paths = []
    for source, images in scenes:
        name = os.path.basename(os.path.normpath(source))
        model_path = os.path.join(args.output_path, name)
        model_paths.append(model_path)
        common = ["-s", source, "-m", model_path, "-i", images, "--eval",
                  "--device", args.device]
        if not args.skip_training:
            it = args.iterations
            mid = min(7000, max(1, it // 2))
            t0 = time.time()
            train_cli.main(common + ["--iterations", str(it),
                                     "--test_iterations", str(mid), str(it),
                                     "--save_iterations", str(mid), str(it)])
            seconds["train"] += time.time() - t0
        if not args.skip_rendering:
            t0 = time.time()
            render_cli.main(["-m", model_path, "--skip_train",
                             "--device", args.device])
            seconds["render"] += time.time() - t0
    if not args.skip_metrics:
        t0 = time.time()
        metrics_mod.evaluate(model_paths, device=args.device)
        seconds["metrics"] += time.time() - t0
    print(f"stage wall seconds: {seconds}")
    return {"model_paths": model_paths, "seconds": seconds}


if __name__ == "__main__":
    main(sys.argv[1:])
