"""Training CLI: the JAX package's ``cli/train.py`` flags, plus
``--device`` (default ``cuda``).

    python -m mvs_gaussian_splatting_tpu_torch.cli.train -s <scene> -m <out> \\
        [...]

Training composites in fast-math mode by default, as in the JAX package
(``--no-fast_math`` for exact mode); ``--backend pallas`` or ``jnp``
composites padded per-tile tables instead of the instance stream.

The multi-device modes (``--data_parallel B``, ``--tile_parallel N``, both
at once, ``--gauss_parallel N``) run on one device at world size 1, or
over the ranks that ``torchrun`` starts, one per device::

    torchrun --nproc_per_node 4 -m mvs_gaussian_splatting_tpu_torch.cli.train \
        -s <scene> -m <out> --data_parallel 4

Each rank trains on ``cuda:LOCAL_RANK``; rank 0 writes the model.

``--ip HOST --port P`` opens the network viewer's listener (rank 0): a
SIBR remote viewer, or ``cli/view.py`` of either package, can then watch
the run and pause it (``viewer/network_gui.py``).
"""

from __future__ import annotations

import sys
import uuid

import torch

from ..ops.stream import tile_limit
from ..parallel import multihost
from ..train.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                            TrainRunConfig)
from ..train.loop import train
from ..utils.system import seed_everything
from ..viewer import network_gui
from .args import build_parser, extract


def main(argv=None):
    """Parse ``argv`` and train; returns train()'s (params, aux, scene,
    history)."""
    parser = build_parser("Training script parameters")
    parser.add_argument("--ip", type=str, default="")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of this run's "
                             "100th-120th iterations (after the checkpoint's "
                             "iteration on a resume) into this directory")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)
    # an empty tile, refused before any data is read
    why = tile_limit(args.tile_w, args.tile_h)
    if why:
        parser.error(f"--tile_w {args.tile_w} --tile_h {args.tile_h}: {why}")
    model_cfg = extract(ModelConfig, args)
    opt_cfg = extract(OptimizationConfig, args)
    pipe_cfg = extract(PipelineConfig, args)
    run_cfg = extract(TrainRunConfig, args)
    if model_cfg.model_path == "":
        model_cfg.model_path = f"./output/{str(uuid.uuid4())[:10]}"
    print(f"Optimizing {model_cfg.model_path}")
    seed_everything(run_cfg.seed)
    multihost.initialize()
    device = args.device
    if device == "cuda" and multihost.world_size() > 1:
        device = str(multihost.device())
    if args.ip and multihost.rank() == 0:
        network_gui.init(args.ip, args.port)
    try:
        with torch.autograd.set_detect_anomaly(args.detect_anomaly):
            result = train(model_cfg, opt_cfg, pipe_cfg, run_cfg,
                           device=device, profile_dir=args.profile_dir)
    finally:
        network_gui.close()
    print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
