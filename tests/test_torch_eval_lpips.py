"""LPIPS and full_eval held against the JAX package (moved from
``test_torch_eval.py``, whose helpers they use)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_lpips import _random_weights

from mvs_gaussian_splatting_tpu.eval.lpips import LPIPS as JLPIPS
from mvs_gaussian_splatting_tpu_torch.eval import metrics as tmetrics
from mvs_gaussian_splatting_tpu_torch.eval.lpips import LPIPS as TLPIPS

torch.set_num_threads(1)


class TestLPIPS:
    def test_matches_jax_on_seeded_weights(self, tmp_path, monkeypatch):
        """Random weights from a seed: the port's LPIPS within 1e-5
        relative of the JAX package's on a 64×64 pair, 0 on identical
        images; evaluate_dir then reports the same number."""
        path = str(tmp_path / "w.npz")
        _random_weights(path, seed=0)
        rng = np.random.RandomState(1)
        img1 = rng.rand(3, 64, 64).astype(np.float32)
        img2 = np.clip(img1 + rng.randn(3, 64, 64).astype(np.float32) * 0.1,
                       0, 1)
        want = float(JLPIPS(weights_path=path)(img1, img2))
        metric = TLPIPS(weights_path=path, device="cpu")
        got = float(metric(torch.from_numpy(img1), torch.from_numpy(img2)))
        assert got == pytest.approx(want, rel=1e-5), (got, want)
        assert float(metric(torch.from_numpy(img1),
                            torch.from_numpy(img1))) == 0.0
        # through evaluate_dir: the weights named by the environment
        monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", path)
        d = tmp_path / "pair"
        for sub, img in (("renders", img2), ("gt", img1)):
            os.makedirs(d / sub)
            Image.fromarray((img.transpose(1, 2, 0) * 255).astype(
                np.uint8)).save(d / sub / "a.png")
        pv = tmetrics.evaluate_dir(str(d / "renders"), str(d / "gt"), "cpu")
        direct = float(metric(tmetrics.read_image(str(d / "renders/a.png"),
                                                  "cpu"),
                              tmetrics.read_image(str(d / "gt/a.png"),
                                                  "cpu")))
        assert pv["a.png"]["LPIPS"] == pytest.approx(direct, rel=1e-6)

    def test_missing_weights_raise(self, monkeypatch):
        monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
        with pytest.raises(FileNotFoundError):
            TLPIPS(device="cpu")
