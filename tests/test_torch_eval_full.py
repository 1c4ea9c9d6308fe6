"""``full_eval`` held against the JAX package (moved from
``test_torch_eval_lpips.py``, whose helpers it uses)."""

import json
import os

import pytest
import torch
from test_torch_train import write_synthetic_scene
from test_torch_eval import (_Recorder)

from mvs_gaussian_splatting_tpu_torch.cli import full_eval
from mvs_gaussian_splatting_tpu_torch.eval import metrics as tmetrics

torch.set_num_threads(1)


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
