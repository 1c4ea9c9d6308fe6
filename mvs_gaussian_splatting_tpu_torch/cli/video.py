"""Render-vs-GT error strips — the reference's video.py.

The port's copy of the JAX package's ``cli/video.py`` (host tooling). For
each rendered/gt pair under <model>/<split>/ours_<iter>/, writes a
side-by-side strip [render | gt | abs-error heatmap] to <out>/.
``matplotlib`` is imported only when a strip is drawn.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from PIL import Image


def error_strip(render_path: str, gt_path: str) -> np.ndarray:
    r = np.asarray(Image.open(render_path).convert("RGB"), np.float32) / 255
    g = np.asarray(Image.open(gt_path).convert("RGB"), np.float32) / 255
    err = np.abs(r - g).mean(-1)
    err = err / max(err.max(), 1e-6)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.cm as cm
    heat = cm.inferno(err)[..., :3]
    return (np.concatenate([r, g, heat], axis=1) * 255).astype(np.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Error-strip tool")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    base = os.path.join(args.model_path, args.split)
    if args.iteration == -1:
        methods = [m for m in os.listdir(base)
                   if m.startswith("ours_") and m.split("_")[-1].isdigit()]
        if not methods:
            parser.error(f"no ours_<iteration> directories under {base}")
        method = max(methods, key=lambda m: int(m.split("_")[-1]))
    else:
        method = f"ours_{args.iteration}"
    renders = os.path.join(base, method, "renders")
    gts = os.path.join(base, method, "gt")
    out_dir = args.out or os.path.join(base, method, "strips")
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(renders)):
        strip = error_strip(os.path.join(renders, name),
                            os.path.join(gts, name))
        Image.fromarray(strip).save(os.path.join(out_dir, name))
    print(f"strips written to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
