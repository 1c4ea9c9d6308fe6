"""Offline metrics over rendered/gt image pairs.

Port of the JAX package's ``eval/metrics.py`` (the reference's
metrics.py): walks ``<model>/<split>/ours_<iter>/{renders,gt}``, computes
SSIM and PSNR (and LPIPS when weights are available) on ``device`` (the
card unless the caller asks for the CPU) and writes ``results.json`` and
``per_view.json`` in the same layout. Without LPIPS weights the LPIPS
entries are ``null``; a scene that fails is reported and skipped.

    python -m mvs_gaussian_splatting_tpu_torch.eval.metrics -m <model> [...]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from ..utils.losses import psnr, ssim


def read_image(path: str, device="cuda") -> torch.Tensor:
    """A PNG as a [3, H, W] float32 tensor in [0, 1] on ``device``."""
    arr = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1))).to(
        device)


def lpips_fn(device="cuda"):
    """An LPIPS module on ``device``, or None if its weights are
    unavailable."""
    try:
        from .lpips import LPIPS
        return LPIPS(device=device)
    except Exception:
        return None


def evaluate_dir(renders_dir: str, gt_dir: str, device="cuda"):
    """{image name: {"SSIM", "PSNR", "LPIPS"}} over the pairs of two
    directories."""
    names = sorted(os.listdir(renders_dir))
    lp = lpips_fn(device)
    per_view: Dict[str, Dict[str, Optional[float]]] = {}
    with torch.no_grad():
        for name in names:
            img = read_image(os.path.join(renders_dir, name), device)
            gt = read_image(os.path.join(gt_dir, name), device)
            per_view[name] = {
                "SSIM": float(ssim(img, gt)),
                "PSNR": float(psnr(img, gt)[0]),
                "LPIPS": float(lp(img, gt)) if lp is not None else None,
            }
    return per_view


def evaluate(model_paths: List[str], split: str = "test",
             device="cuda") -> dict:
    """Scores every method directory under each model's ``split`` and
    writes its ``results.json`` / ``per_view.json``; returns {model path:
    {method: means}} for the scenes that succeeded."""
    full_report = {}
    for model_path in model_paths:
        print(f"Scene: {model_path}")
        results = {}
        per_view_all = {}
        test_dir = os.path.join(model_path, split)
        try:
            for method in os.listdir(test_dir):
                renders_dir = os.path.join(test_dir, method, "renders")
                gt_dir = os.path.join(test_dir, method, "gt")
                per_view = evaluate_dir(renders_dir, gt_dir, device)
                agg = {}
                for key in ("SSIM", "PSNR", "LPIPS"):
                    vals = [v[key] for v in per_view.values()
                            if v[key] is not None]
                    agg[key] = float(np.mean(vals)) if vals else None
                print(f"  {method}: SSIM {agg['SSIM']} PSNR {agg['PSNR']} "
                      f"LPIPS {agg['LPIPS']}")
                results[method] = agg
                per_view_all[method] = {
                    key: {n: v[key] for n, v in per_view.items()}
                    for key in ("SSIM", "PSNR", "LPIPS")}
            with open(os.path.join(model_path, "results.json"), "w") as f:
                json.dump(results, f, indent=2)
            with open(os.path.join(model_path, "per_view.json"), "w") as f:
                json.dump(per_view_all, f, indent=2)
            full_report[model_path] = results
        except Exception as e:
            # the reference swallows a scene's failure (metrics.py:92-93)
            print(f"Unable to compute metrics for model {model_path}: {e}")
    return full_report


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="Metrics script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--device", default="cuda",
                        help="torch device to score on (default cuda)")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, device=args.device)


if __name__ == "__main__":
    main()
