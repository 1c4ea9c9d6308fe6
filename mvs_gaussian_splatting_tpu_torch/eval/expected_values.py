"""Published expected metric values — the drop-in verification table for
real-weight / real-dataset arrival.

The port's copy of the JAX package's ``eval/expected_values.py`` (numpy
only). Neither the torchvision VGG16 + LPIPS linear-head weights
(lpipsPyTorch/modules/utils.py:11-30 downloads them at runtime) nor the
benchmark datasets are in the repository. Everything needed to verify the
moment they arrive is committed here:

1. ``GS3D_PAPER_30K``: the upstream 3D Gaussian Splatting paper's published
   per-dataset aggregates at 30K iterations (Kerbl et al., SIGGRAPH 2023,
   Table 1 — the tables full_eval.py's 13-scene matrix reproduces,
   the reference's full_eval.py:15-18). A full_eval run over the real scenes
   with real LPIPS weights should land inside the stated bands if training
   reached parity.
2. ``lpips_probe_pair``: a deterministic, committed image pair (no dataset
   needed). ``LPIPS_PROBE_REAL_VGG`` holds the real-weight LPIPS-VGG value on
   that pair; it starts as None and is pinned by running
   ``tests/test_lpips.py::test_lpips_real_weights_probe_pair`` on any machine
   with the weights — after which the test becomes a cross-machine
   implementation check (tolerance band included).

The port's LPIPS is held to the JAX package's on random weights
(tests/test_torch_eval.py), which is itself held to an independent torch
oracle (tests/test_lpips.py), so the only unverified link is the weight
values — exactly what these pins close.
"""

from __future__ import annotations

import numpy as np

# 3DGS paper (Kerbl et al. 2023), 30K-iteration aggregates as published.
# "band" is the acceptance half-width for a reproduction run: generous enough
# for scene-sampling and implementation noise, tight enough to catch a broken
# metric (LPIPS implementations that mix up backbones differ by ≥0.05).
GS3D_PAPER_30K = {
    "mipnerf360": {"psnr": 27.21, "ssim": 0.815, "lpips_vgg": 0.214,
                   "band": {"psnr": 0.5, "ssim": 0.02, "lpips_vgg": 0.03}},
    "tanksandtemples": {"psnr": 23.14, "ssim": 0.841, "lpips_vgg": 0.183,
                        "band": {"psnr": 0.5, "ssim": 0.02,
                                 "lpips_vgg": 0.03}},
    "deepblending": {"psnr": 29.41, "ssim": 0.903, "lpips_vgg": 0.243,
                     "band": {"psnr": 0.5, "ssim": 0.02, "lpips_vgg": 0.03}},
}

# Real-weight LPIPS-VGG value on the committed probe pair below. None until
# pinned on a machine with the weights; once set, any refactor of
# eval/lpips.py (or a differently-converted weight file) must reproduce it
# to LPIPS_PROBE_TOL.
LPIPS_PROBE_REAL_VGG: float | None = None
LPIPS_PROBE_TOL = 1e-4


def lpips_probe_pair():
    """Deterministic 3×128×128 image pair for the real-weight pin.

    Structured (edges + gradients + texture) rather than white noise so the
    VGG features are exercised in-distribution; fully reproducible from this
    source, no data files involved.
    """
    h = w = 128
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img1 = np.stack([
        np.sin(x / 9.0) * 0.5 + 0.5,
        np.cos(y / 6.0) * np.sin(x / 17.0) * 0.5 + 0.5,
        ((x // 16 + y // 16) % 2).astype(np.float32),
    ]).astype(np.float32)
    rng = np.random.RandomState(1234)
    img2 = np.clip(img1 + 0.15 * np.sin((x + y) / 4.0)[None]
                   + rng.randn(3, h, w).astype(np.float32) * 0.02,
                   0.0, 1.0).astype(np.float32)
    return img1, img2


def check_dataset_results(dataset: str, results: dict) -> list:
    """Compare a full_eval results dict {psnr, ssim, lpips_vgg} against the
    published table. Returns a list of human-readable deviations outside the
    band (empty = within published expectations)."""
    exp = GS3D_PAPER_30K[dataset]
    out = []
    for k in ("psnr", "ssim", "lpips_vgg"):
        if k not in results or results[k] is None:
            out.append(f"{k}: missing")
            continue
        if abs(results[k] - exp[k]) > exp["band"][k]:
            out.append(f"{k}: got {results[k]:.4f}, published {exp[k]:.4f} "
                       f"(band ±{exp['band'][k]})")
    return out
