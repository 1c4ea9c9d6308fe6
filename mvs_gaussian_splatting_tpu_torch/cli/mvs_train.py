"""CLI for the generalizable MVS→Gaussian branch (BASELINE config #4).

Port of the JAX package's ``cli/mvs_train.py``: the same flags, plus
``--device`` (default ``cuda``). Trains the cost-volume network on a DTU
scan in the MVSNeRF layout, or on a self-contained synthetic multi-view
fixture:

    python -m mvs_gaussian_splatting_tpu_torch.cli.mvs_train \\
        --source_path /data/dtu --scan scan114 --model_path out/
    python -m mvs_gaussian_splatting_tpu_torch.cli.mvs_train \\
        --synthetic 8 --iterations 1500 --model_path out/

On a card the render runs B1 forward and B2 backward (exact mode).
``main`` returns the run's (model, history), or 1 when a DTU root holds
no group.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="MVS->Gaussian training")
    parser.add_argument("--source_path", "-s", default="",
                        help="DTU root (MVSNeRF layout)")
    parser.add_argument("--scan", default="scan114")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="train on N synthetic multi-view groups "
                             "instead of DTU data")
    parser.add_argument("--model_path", "-m", default="")
    parser.add_argument("--iterations", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--num_depths", type=int, default=32)
    parser.add_argument("--num_src", type=int, default=2)
    parser.add_argument("--eval_every", type=int, default=500)
    parser.add_argument("--width", type=int, default=128,
                        help="synthetic image width")
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--max_dim", type=int, default=640,
                        help="DTU image downscale bound")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)

    from ..mvs.dataset import load_dtu_scan, make_synthetic_groups
    from ..mvs.train import MVSConfig, train_mvs

    if args.synthetic:
        groups = make_synthetic_groups(n_groups=args.synthetic,
                                       width=args.width, height=args.height,
                                       num_src=args.num_src, seed=args.seed,
                                       device=args.device)
    elif args.source_path:
        groups = load_dtu_scan(args.source_path, args.scan,
                               num_src=args.num_src, max_dim=args.max_dim)
        if not groups:
            print(f"no groups found under {args.source_path}",
                  file=sys.stderr)
            return 1
    else:
        parser.error("need --source_path or --synthetic N")

    n_eval = max(1, len(groups) // 8)
    eval_groups, train_groups = groups[:n_eval], groups[n_eval:]
    cfg = MVSConfig(iterations=args.iterations, lr=args.lr,
                    num_depths=args.num_depths, eval_every=args.eval_every,
                    model_path=args.model_path, num_src=args.num_src,
                    seed=args.seed, backend=args.backend)
    model, history = train_mvs(cfg, train_groups, eval_groups,
                               device=args.device)
    last = max(history["psnr_eval"]) if history["psnr_eval"] else None
    if last is not None:
        print(f"final eval PSNR {history['psnr_eval'][last]:.2f}")
    return model, history


if __name__ == "__main__":
    res = main()
    sys.exit(res if isinstance(res, int) else 0)
