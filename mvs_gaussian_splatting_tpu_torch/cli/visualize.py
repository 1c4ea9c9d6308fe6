"""Sphere-direction visualization — the reference's visualize.py.

The port's copy of the JAX package's ``cli/visualize.py`` (host tooling).
Plots the Fibonacci-sphere grow-direction codebook (or a points.txt dump)
as a 3D scatter saved to PNG (headless backend). ``matplotlib`` is
imported only when plotting.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot sphere directions")
    parser.add_argument("--num_dirs", type=int, default=128)
    parser.add_argument("--points", type=str, default="",
                        help="optional points.txt (x y z per line)")
    parser.add_argument("--out", type=str, default="sphere_points.png")
    args = parser.parse_args(argv)

    if args.points:
        pts = np.loadtxt(args.points)
    else:
        from ..utils.sphere import sphere_points
        pts = sphere_points(args.num_dirs)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=12)
    ax.set_box_aspect((1, 1, 1))
    ax.set_title(f"{len(pts)} sphere directions")
    fig.savefig(args.out, dpi=120)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
