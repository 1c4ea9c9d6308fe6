"""The test-PSNR and alive-count trajectories of training runs, as one
figure.

Counterpart of the JAX repository's ``scripts/plot_validation.py``, on the
``history.json`` files that ``ref_scale_validation.py`` and
``cli/train.py`` write (``psnr_test`` and ``n_alive`` by iteration)::

    python -m mvs_gaussian_splatting_tpu_torch.tools.plot_validation
        [--out runs/torch_validation.png] [LABEL=]HISTORY.json ...

Two panels, one axis each: test PSNR and alive Gaussians (thousands)
against the iteration, one fixed colour per run, labelled at its end. A
run is named by ``LABEL=`` or by the directory holding its history.
"""

from __future__ import annotations

import argparse
import json
import os

COLORS = ("#3B82F6", "#F59E0B", "#10B981", "#EF4444", "#8B5CF6")


def load_runs(specs):
    """[(label, history)] of ``[LABEL=]PATH`` arguments."""
    runs = []
    for spec in specs:
        label, sep, path = spec.partition("=")
        if not sep:
            label, path = os.path.basename(os.path.dirname(
                os.path.abspath(spec))), spec
        with open(path) as f:
            runs.append((label, json.load(f)))
    return runs


def plot(runs, out: str) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4), dpi=140)
    for ax in (ax1, ax2):
        ax.grid(True, color="#E5E7EB", linewidth=0.6)
        ax.set_axisbelow(True)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        ax.tick_params(colors="#6B7280", labelsize=8)
    for i, (name, h) in enumerate(runs):
        color = COLORS[i % len(COLORS)]
        it_p = sorted((int(k), v) for k, v in h["psnr_test"].items())
        it_n = sorted((int(k), v) for k, v in h["n_alive"].items())
        ax1.plot([k for k, _ in it_p], [v for _, v in it_p], color=color,
                 linewidth=2, marker="o", markersize=4)
        ax1.annotate(name, xy=it_p[-1], xytext=(4, 0),
                     textcoords="offset points", fontsize=8,
                     color="#374151", va="center")
        ax2.plot([k for k, _ in it_n], [v / 1000 for _, v in it_n],
                 color=color, linewidth=2, marker="o", markersize=4)
    ax1.set_title("test PSNR (dB)", fontsize=10, color="#111827", loc="left")
    ax2.set_title("alive Gaussians (thousands)", fontsize=10,
                  color="#111827", loc="left")
    for ax in (ax1, ax2):
        ax.set_xlabel("iteration", fontsize=9, color="#6B7280")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "torch_validation.png"))
    ap.add_argument("runs", nargs="+", metavar="[LABEL=]HISTORY.json")
    args = ap.parse_args(argv)
    out = plot(load_runs(args.runs), args.out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
