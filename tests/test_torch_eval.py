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
from mvs_gaussian_splatting_tpu.eval.lpips import LPIPS as JLPIPS
from mvs_gaussian_splatting_tpu_torch.cli import full_eval
from mvs_gaussian_splatting_tpu_torch.eval import expected_values as texpected
from mvs_gaussian_splatting_tpu_torch.eval import metrics as tmetrics
from mvs_gaussian_splatting_tpu_torch.eval.lpips import LPIPS as TLPIPS

from test_lpips import _random_weights
from test_torch_train import write_synthetic_scene

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


class TestFullEval:
    def _patch(self, monkeypatch):
        from mvs_gaussian_splatting_tpu_torch.cli import render as render_cli
        from mvs_gaussian_splatting_tpu_torch.cli import train as train_cli
        recs = _Recorder(), _Recorder(), _Recorder()
        monkeypatch.setattr(train_cli, "main", recs[0])
        monkeypatch.setattr(render_cli, "main", recs[1])
        monkeypatch.setattr(tmetrics, "evaluate", recs[2])
        return recs

    def test_standard_13_scene_matrix(self, monkeypatch, tmp_path):
        train_rec, render_rec, metrics_rec = self._patch(monkeypatch)
        full_eval.main(["--output_path", str(tmp_path / "eval"),
                        "--mipnerf360", "/data/m360",
                        "--tanksandtemples", "/data/tat",
                        "--deepblending", "/data/db"])
        # 9 MipNeRF-360 + 2 T&T + 2 DB = 13 scenes (full_eval.py:15-18)
        assert len(train_rec.calls) == 13 and len(render_rec.calls) == 13
        by_scene = {c[c.index("-s") + 1]: c for c, _ in train_rec.calls}
        for scene, images in (("/data/m360/bicycle", "images_4"),
                              ("/data/m360/room", "images_2"),
                              ("/data/tat/truck", "images"),
                              ("/data/db/playroom", "images")):
            c = by_scene[scene]
            assert c[c.index("-i") + 1] == images
        for c, _ in train_rec.calls:
            assert "--eval" in c
            assert c[c.index("--device") + 1] == "cuda"
            it = c.index("--test_iterations")
            assert c[it + 1:it + 3] == ["7000", "30000"]
        # renders after the training of each scene, test split only
        for c, _ in render_rec.calls:
            assert "--skip_train" in c
        # metrics called once over all model paths, after every render
        assert len(metrics_rec.calls) == 1
        paths, kw = metrics_rec.calls[0]
        assert len(paths) == 13 and kw == {"device": "cuda"}
        assert paths[0] == os.path.join(str(tmp_path / "eval"), "bicycle")

    def test_skip_flags(self, monkeypatch, tmp_path):
        train_rec, render_rec, metrics_rec = self._patch(monkeypatch)
        full_eval.main(["--output_path", str(tmp_path),
                        "--tanksandtemples", "/data/tat",
                        "--skip_training", "--skip_metrics"])
        assert train_rec.calls == [] and metrics_rec.calls == []
        assert len(render_rec.calls) == 2
        train_rec.calls.clear(), render_rec.calls.clear()
        full_eval.main(["--output_path", str(tmp_path), "--scenes", "/s/a",
                        "--skip_rendering", "--iterations", "10"])
        assert render_rec.calls == [] and len(metrics_rec.calls) == 1
        c = train_rec.calls[0][0]
        assert c[c.index("--save_iterations") + 1:][:2] == ["5", "10"]

    def test_no_datasets_errors(self):
        with pytest.raises(SystemExit):
            full_eval.main(["--output_path", "/tmp/x"])

    def test_tiny_chain_offline_matches_loop(self, tmp_path):
        """One real chain on the CPU: train 10 steps on a 64×48 scene of 9
        views (2 held out), render the test views, score them. The offline
        PSNR (8-bit PNGs) is within 0.02 dB of the loop's own test PSNR at
        the last iteration (the one-operator invariant of
        tests/test_eval_exact.py)."""
        scene = write_synthetic_scene(tmp_path)
        out = tmp_path / "eval"
        res = full_eval.main(["--output_path", str(out), "--scenes", scene,
                              "--iterations", "10", "--device", "cpu"])
        model = out / "scene"
        assert res["model_paths"] == [str(model)]
        assert set(res["seconds"]) == {"train", "render", "metrics"}
        hist = json.loads((model / "history.json").read_text())
        loop = hist["psnr_test"]["10"]
        results = json.loads((model / "results.json").read_text())
        per_view = json.loads((model / "per_view.json").read_text())
        assert sorted(results) == ["ours_10"]
        assert len(per_view["ours_10"]["PSNR"]) == 2
        assert abs(results["ours_10"]["PSNR"] - loop) < 0.02, (results, loop)
