"""The port's eval chain (``eval/metrics.py``, ``eval/lpips.py``,
``eval/expected_values.py``, ``cli/full_eval.py``) held against the JAX
package and against the kept ``runs/specfinal`` record.

The JAX package scores the small seeded pairs and the LPIPS weights (its
``LPIPS`` is jitted whole); the kept ``runs/specfinal`` renders are scored
in ``tests/test_torch_eval_kept.py``. Tolerances are stated where they are
used.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mvs_gaussian_splatting_tpu.eval import expected_values as jexpected
from mvs_gaussian_splatting_tpu.eval import metrics as jmetrics
from mvs_gaussian_splatting_tpu_torch.eval import expected_values as texpected
from mvs_gaussian_splatting_tpu_torch.eval import metrics as tmetrics


torch.set_num_threads(1)


def _write_pairs(model_path, method="ours_30000", n=3, noise=0.0, seed=0,
                 h=48, w=64):
    rd = os.path.join(model_path, "test", method, "renders")
    gd = os.path.join(model_path, "test", method, "gt")
    os.makedirs(rd, exist_ok=True)
    os.makedirs(gd, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        gt = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        render = np.clip(gt.astype(np.int32)
                         + (noise * rng.randn(h, w, 3)).astype(np.int32),
                         0, 255).astype(np.uint8)
        Image.fromarray(gt).save(os.path.join(gd, f"{i:05d}.png"))
        Image.fromarray(render).save(os.path.join(rd, f"{i:05d}.png"))
    return rd, gd


class TestMetrics:
    def test_evaluate_dir_matches_jax(self, tmp_path, monkeypatch):
        """Seeded 64×48 PNG pairs: SSIM and PSNR of every view within 1e-6
        (PSNR relative to its value) of the JAX package's evaluate_dir."""
        monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
        # the JAX evaluate_dir as it is, its SSIM and PSNR each jitted whole
        monkeypatch.setattr(jmetrics, "ssim", jax.jit(jmetrics.ssim))
        monkeypatch.setattr(jmetrics, "psnr", jax.jit(jmetrics.psnr))
        rd, gd = _write_pairs(str(tmp_path / "m"), n=3, noise=12.0, seed=4)
        got = tmetrics.evaluate_dir(rd, gd, device="cpu")
        want = jmetrics.evaluate_dir(rd, gd)
        assert sorted(got) == sorted(want)
        for name in want:
            assert abs(got[name]["SSIM"] - want[name]["SSIM"]) < 1e-6
            assert (abs(got[name]["PSNR"] - want[name]["PSNR"])
                    < 1e-6 * want[name]["PSNR"])
            assert got[name]["LPIPS"] is None and want[name]["LPIPS"] is None

    def test_evaluate_writes_results_and_per_view(self, tmp_path):
        model = str(tmp_path / "scene")
        _write_pairs(model, n=3, noise=0.0)
        report = tmetrics.evaluate([model], device="cpu")
        res = json.load(open(os.path.join(model, "results.json")))
        pv = json.load(open(os.path.join(model, "per_view.json")))
        agg = res["ours_30000"]
        # identical pairs: SSIM 1, PSNR inf-or-huge
        assert agg["SSIM"] == pytest.approx(1.0, abs=1e-5)
        assert agg["PSNR"] > 60
        assert sorted(pv["ours_30000"]) == ["LPIPS", "PSNR", "SSIM"]
        assert len(pv["ours_30000"]["PSNR"]) == 3
        assert report[model] == res

    def test_noisy_pair_scores_lower(self, tmp_path):
        clean = str(tmp_path / "clean")
        noisy = str(tmp_path / "noisy")
        _write_pairs(clean, n=2, noise=0.0)
        _write_pairs(noisy, n=2, noise=25.0)
        tmetrics.evaluate([clean, noisy], device="cpu")
        rc = json.load(open(os.path.join(clean, "results.json")))["ours_30000"]
        rn = json.load(open(os.path.join(noisy, "results.json")))["ours_30000"]
        assert rn["PSNR"] < rc["PSNR"]
        assert rn["SSIM"] < rc["SSIM"]

    def test_broken_scene_swallowed(self, tmp_path, capsys):
        ok = str(tmp_path / "ok")
        broken = str(tmp_path / "broken")   # no test/ dir at all
        _write_pairs(ok, n=1)
        os.makedirs(broken, exist_ok=True)
        report = tmetrics.evaluate([broken, ok], device="cpu")
        out = capsys.readouterr().out
        assert "Unable to compute metrics" in out
        assert ok in report and broken not in report
        assert os.path.exists(os.path.join(ok, "results.json"))

    def test_missing_weights_give_null_in_both(self, tmp_path, monkeypatch):
        """Without ``$LPIPS_WEIGHTS_NPZ`` both packages write LPIPS as null
        and the same SSIM / PSNR layout."""
        monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
        monkeypatch.setattr(jmetrics, "ssim", jax.jit(jmetrics.ssim))
        monkeypatch.setattr(jmetrics, "psnr", jax.jit(jmetrics.psnr))
        assert tmetrics.lpips_fn("cpu") is None and jmetrics.lpips_fn() is None
        for name, mod, kw in (("t", tmetrics, {"device": "cpu"}),
                              ("j", jmetrics, {})):
            model = str(tmp_path / name)
            _write_pairs(model, n=2, noise=5.0)
            mod.evaluate([model], **kw)
        rt = json.load(open(tmp_path / "t" / "results.json"))
        rj = json.load(open(tmp_path / "j" / "results.json"))
        assert rt["ours_30000"]["LPIPS"] is None
        assert rj["ours_30000"]["LPIPS"] is None
        pt = json.load(open(tmp_path / "t" / "per_view.json"))
        pj = json.load(open(tmp_path / "j" / "per_view.json"))
        assert pt["ours_30000"]["LPIPS"] == pj["ours_30000"]["LPIPS"] == {
            "00000.png": None, "00001.png": None}


def test_expected_values_copied():
    """The port's copy of the published tables and the probe pair equal the
    JAX package's."""
    assert texpected.GS3D_PAPER_30K == jexpected.GS3D_PAPER_30K
    assert texpected.LPIPS_PROBE_REAL_VGG == jexpected.LPIPS_PROBE_REAL_VGG
    assert texpected.LPIPS_PROBE_TOL == jexpected.LPIPS_PROBE_TOL
    for a, b in zip(texpected.lpips_probe_pair(), jexpected.lpips_probe_pair()):
        np.testing.assert_array_equal(a, b)
    bad = {"psnr": 27.21, "ssim": 0.815, "lpips_vgg": 0.30}
    for ds, res in (("mipnerf360", bad), ("deepblending", {"psnr": 29.4})):
        assert (texpected.check_dataset_results(ds, res)
                == jexpected.check_dataset_results(ds, res))


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, argv, **kw):
        self.calls.append((list(argv), kw))
