"""The port's metrics over the kept ``runs/specfinal`` renders, on torch
alone: the recorded ``results.json`` / ``per_view.json`` and an f64 PSNR of
the same images are the oracles (the JAX package's metrics are held to the
port's in ``tests/test_torch_eval.py``). Tolerances are stated in the test.
"""

import json
import math
import os

import numpy as np
import torch

from mvs_gaussian_splatting_tpu_torch.eval import metrics as tmetrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECFINAL = os.path.join(ROOT, "runs", "specfinal", "model")
METHOD = "ours_25000"


def test_kept_specfinal_metrics_reproduced(monkeypatch):
    """The port's metrics over the kept renders and ground truth of
    ``runs/specfinal`` (15 views at 1237×822, on the CPU) reproduce
    ``results.json`` (mean PSNR within 1e-4 dB, mean SSIM within 1e-5) and
    ``per_view.json``'s SSIM (1e-5 a view). Each view's PSNR is held within
    1e-4 dB of an f64 PSNR of the same images. The kept per-view PSNRs were
    reduced in f32 on the TPU and sit up to 6.6e-4 dB from that f64 value
    (the JAX package's own CPU evaluate differs from them by as much), so
    against ``per_view.json`` a view is held within 1e-3 dB."""
    views = os.path.join(SPECFINAL, "test", METHOD)
    read = tmetrics.read_image
    images = {}

    def recording_read(path, device="cuda"):
        images[os.path.relpath(path, views)] = img = read(path, device)
        return img

    monkeypatch.setattr(tmetrics, "read_image", recording_read)
    got = tmetrics.evaluate_dir(os.path.join(views, "renders"),
                                os.path.join(views, "gt"), device="cpu")
    with open(os.path.join(SPECFINAL, "results.json")) as f:
        want = json.load(f)[METHOD]
    with open(os.path.join(SPECFINAL, "per_view.json")) as f:
        want_view = json.load(f)[METHOD]
    assert sorted(got) == sorted(want_view["PSNR"]) and len(got) == 15
    assert abs(np.mean([v["PSNR"] for v in got.values()])
               - want["PSNR"]) < 1e-4
    assert abs(np.mean([v["SSIM"] for v in got.values()])
               - want["SSIM"]) < 1e-5
    assert want["LPIPS"] is None and all(v["LPIPS"] is None
                                         for v in got.values())
    for name, v in got.items():
        assert abs(v["SSIM"] - want_view["SSIM"][name]) < 1e-5, name
        assert abs(v["PSNR"] - want_view["PSNR"][name]) < 1e-3, name
        a = images[os.path.join("renders", name)].double()
        b = images[os.path.join("gt", name)].double()
        exact = 20 * math.log10(1.0 / math.sqrt(float(((a - b) ** 2).mean())))
        assert abs(v["PSNR"] - exact) < 1e-4, (name, v["PSNR"], exact)
