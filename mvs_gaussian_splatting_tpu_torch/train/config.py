"""Typed configuration mirroring the reference's flag surface.

Replaces the reflection-argparse ParamGroups (arguments/__init__.py:16-108)
with dataclasses serialized as JSON — same field names and defaults, no
``eval()`` round-trips. ``save_cfg_args``/``load_cfg_args`` keep the on-disk
cfg_args artifact for interoperability (train.py:172-173,
arguments/__init__.py:110-130) via a JSON sidecar.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List


@dataclass
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "tpu"
    eval: bool = False
    # research extras (reference arguments/__init__.py:57-66)
    grow_dir: bool = False
    continous_dir: bool = False
    grow_distance: bool = False
    num_dirs: int = 128
    prob_notreinit: bool = False
    symmetric_split: bool = False
    split_notreinit: bool = False
    learn_split_distance: bool = False
    learn_split_scale: bool = False

    def extras(self) -> dict:
        return {k: getattr(self, k) for k in
                ("grow_dir", "continous_dir", "grow_distance",
                 "learn_split_distance", "learn_split_scale")}


@dataclass
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    detach: bool = False
    # TPU-specific knobs (no reference analog)
    backend: str = "auto"            # rasterizer composite backend
    tile_w: int = 16                 # raster tile geometry (32x16 is the
    tile_h: int = 16                 # fastest 1080p config on v5e)
    tile_capacity: int = 1024
    max_tiles_per_gaussian: int = 128
    tile_batch: int = 128
    spec_capacity: int = 4096        # speculation-block slots (grow mode)
    # MXU log-space compositing scans: the TRAIN default since round 3 —
    # 12.26 vs 9.59 steps/s at 1080p with reference-scale PSNR within noise
    # of exact (runs/fastval vs runs/refscale3: 19.89/21.74/22.64/23.21 vs
    # 19.87/21.74/22.58/23.18 at 1K/3K/5K/7K). Evaluation and the offline
    # render/metrics pipeline always composite exact (train/loop.py eval_cfg,
    # cli/render.py). --no-fast_math / fast_math=False restores exact
    # training.
    fast_math: bool = True
    # Visible-prefix compaction (round 4, RasterConfig.visible_cap): bucket
    # the per-camera VISIBLE count and truncate the depth order to it, so
    # per-row binning/pack stages scale with what the camera actually sees
    # instead of the render slice — the win on 360-degree scenes where a
    # large fraction of the cloud is outside any one frustum. Off by
    # default pending hardware validation at reference scale; dropped
    # visible rows are counted (metrics.overflow_visible) and grow the
    # bucket, never silent.
    visible_compaction: bool = False
    # Stream-binning tiered tile budgets (RasterConfig.tier_budgets): every
    # Gaussian gets budgets[0] tile slots, the largest fracs[i]*N by rect
    # area get budgets[i+1], the top fracs[-1]*N the full
    # max_tiles_per_gaussian. The top tier must be generous: a splat whose
    # footprint exceeds its budget renders as a partial patch AND has its
    # densification gradient diluted by the unrendered fraction, so the
    # split/prune machinery stops seeing exactly the splats that most need
    # it (observed as early-training bloat in the validation runs).
    tier_budgets: tuple = (4, 12)
    tier_fracs: tuple = (0.25, 0.1)


@dataclass
class OptimizationConfig:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    growdirs_lr: float = 0.005
    growdistance_lr: float = 0.001
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    random_background: bool = False
    opacitysparse: float = 0.0
    splitdistance_lr: float = 0.005
    splitscale_lr: float = 0.005
    # TPU-specific: capacity management for the padded point store
    initial_capacity_factor: float = 4.0   # capacity = factor × init points
    capacity_growth_factor: float = 2.0
    max_capacity: int = 4_000_000


@dataclass
class TrainRunConfig:
    test_iterations: List[int] = field(default_factory=lambda: [10_000, 30_000, 40_000])
    save_iterations: List[int] = field(default_factory=lambda: [10_000, 30_000, 40_000])
    checkpoint_iterations: List[int] = field(default_factory=list)
    start_checkpoint: str = ""
    eval_every: int = 0      # 0 = off (the reference's every-50-iters sweep is opt-in)
    seed: int = 0
    log_every: int = 10
    data_parallel: int = 0   # cameras per step over the device mesh (0 = off)
    tile_parallel: int = 0   # shard ONE camera's tiles over N devices (0 = off)
    # Setting BOTH data_parallel and tile_parallel composes them into a 2D
    # (data × tile) mesh: data_parallel cameras per step, each camera's tiles
    # sharded tile_parallel-ways (parallel/grid_train.py, round 4).
    gauss_parallel: int = 0  # shard the GAUSSIANS over N devices (0 = off):
    # params/Adam/aux live N/D per device, one all_to_all exchanges packed
    # instances into tile owners (parallel/gauss_train.py) — the axis for
    # the N >> pixels regime. Exclusive with data/tile modes.
    # Unattended-run safety (VERDICT round-2 item #5): abort when the test
    # PSNR at an eval sits more than `divergence_psnr_drop` dB below its
    # running max for `divergence_patience` consecutive evals. 0 = disabled.
    divergence_psnr_drop: float = 0.0
    divergence_patience: int = 3


def save_cfg_args(model_path: str, model_cfg: ModelConfig) -> None:
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(dataclasses.asdict(model_cfg), f, indent=2)


def parse_namespace_repr(text: str) -> dict:
    """Safely parse a stringified argparse ``Namespace(...)`` — the cfg_args
    format the reference writes (train.py:172-173) and reads back via
    ``eval()`` (arguments/__init__.py:110-130). We parse the AST instead and
    accept only literal keyword values, so hostile model dirs cannot execute
    code."""
    import ast

    tree = ast.parse(text.strip(), mode="eval")
    call = tree.body
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
            and call.func.id == "Namespace"):
        raise ValueError("not a Namespace(...) repr")
    out = {}
    for kw in call.keywords:
        if kw.arg is None:
            continue
        try:
            out[kw.arg] = ast.literal_eval(kw.value)
        except (ValueError, SyntaxError):
            pass  # non-literal value (never produced by argparse) — skip
    return out


def load_cfg_args(model_path: str) -> ModelConfig:
    """Read the saved model config: our cfg_args.json, or — for model dirs
    produced by the reference implementation — its ``cfg_args`` Namespace
    repr, so render/metrics drive reference-trained models unchanged."""
    json_path = os.path.join(model_path, "cfg_args.json")
    ref_path = os.path.join(model_path, "cfg_args")
    if os.path.exists(json_path):
        with open(json_path) as f:
            d = json.load(f)
    elif os.path.exists(ref_path):
        with open(ref_path) as f:
            d = parse_namespace_repr(f.read())
        if d.get("data_device") == "cuda":
            d["data_device"] = "tpu"
    else:
        raise FileNotFoundError(json_path)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in d.items() if k in known})
