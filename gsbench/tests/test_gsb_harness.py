"""The harness's guards and its data-driven lookup."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gsbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(
        {"jax.numpy": 1, "mvs_gaussian_splatting_tpu.ops": 1,
         "mvs_gaussian_splatting_tpu_torch.ops": 1, "jaxtyping": 1}) == [
        "jax", "mvs_gaussian_splatting_tpu"]
    assert harness.forbidden_modules(
        {"mvs_gaussian_splatting_tpu_torch": 1, "flaxen": 1,
         "torch": 1}) == []


def test_nothing_the_runs_import_loads_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gsbench import calibrate, harness, run\n"
            "import gsbench.drivers.train, gsbench.drivers.render\n"
            "import gsbench.captures.ring360\n"
            "import mvs_gaussian_splatting_tpu_torch.cli.render\n"
            "import mvs_gaussian_splatting_tpu_torch.train.loop\n"
            "import mvs_gaussian_splatting_tpu_torch.train.grow_step\n"
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gsbench.reference.step, gsbench.scene, gsbench.work\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('mvs_gaussian')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "gsbench/run.py", "--workload", "bicycle.train",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_run_refuses_outside_a_checkout(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench")
    out = subprocess.run(
        [sys.executable, "gsbench/run.py", "--workload", "bicycle.train",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def digest(base: Path) -> dict:
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(base.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


DOME = """import math

import numpy as np
import torch


def train_cameras(cfg, rng):
    k = cfg["n_cameras"]
    el = rng.uniform(0.2, 1.2, k)
    az = rng.uniform(0.0, 2 * np.pi, k)
    r = cfg["scene"]["radius"]
    centres = np.stack([r * np.cos(el) * np.cos(az),
                        r * np.cos(el) * np.sin(az), r * np.sin(el)], -1)
    return centres, np.zeros((k, 3))


def orbit(cfg, poses):
    r = cfg["scene"]["radius"]
    return [([r * math.cos(a), r * math.sin(a), 1.0], (0.0, 0.0, 0.0))
            for a in np.linspace(0, 2 * np.pi, poses, endpoint=False)]


def cloud(cfg, gen, device):
    n = cfg["n_gaussians"]
    return {"xyz": torch.randn((n, 3), generator=gen, device=device),
            "f_dc": torch.zeros((n, 1, 3), device=device),
            "f_rest": torch.zeros((n, 15, 3), device=device),
            "scaling": torch.full((n, 3), -3.0, device=device),
            "rotation": torch.randn((n, 4), generator=gen, device=device),
            "opacity": torch.zeros((n, 1), device=device)}
"""

REPLAY = """from gsbench import scene


def run(run):
    cfg = run.cell.config
    cap = scene.make_capture(cfg, 100, run.seed, run.device)
    poses = scene.orbit_views(cfg, run.cell.traffic["poses"], run.device)
    run.close_setup()
    steps, secs = run.window(lambda k: None, run.cell.traffic["poses"])
    run.close_window(steps, secs)
    run.values["frames_per_s"] = steps / secs
    run.checks = {"views": abs(len(cap.train_views) + len(poses) - 14)}
"""

LOAD = """import json, sys
sys.path.insert(0, sys.argv[1])
from gsbench import harness, spec
out = {}
for trace in (0, 1):
    cell = spec.load_cell("garden.replay")
    r = harness.run_cell(cell, 2 ** 31 + 3, 0.05, bool(trace), "cpu", 0.0)
    out[trace] = harness.result(r, "cpu", 1)
out["old"] = [m["name"] for m in spec.load_cell("bicycle.train").per_layer]
out["config"] = cell.config["name"]
print(json.dumps(out))
"""


def test_new_cell_mix_and_metric_from_files_alone(tmp_path):
    """A later change adds a configuration with a capture shape of its
    own, a traffic mix with a loop of its own, a cell's limits, an
    end-to-end and a per-layer metric, as new files and entries; nothing
    that was there is edited, and a run of the checkout finds them all
    by name."""
    base = tmp_path / "gsbench"
    shutil.copytree(ROOT / "gsbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = digest(base)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = json.loads((base / "configs" / "bicycle.json").read_text())
    cfg.update(name="garden", capture="dome", n_gaussians=64,
               n_cameras=8, test_every=4, width=64, height=48)
    cfg["scene"] = {"radius": 4.0}
    (base / "configs" / "garden.json").write_text(json.dumps(cfg))
    (base / "captures" / "dome.py").write_text(DOME)
    (base / "drivers" / "replay.py").write_text(REPLAY)
    (base / "traffic" / "replay.json").write_text(json.dumps(
        {"driver": "replay", "poses": 8}))
    (base / "limits" / "garden.replay.json").write_text(json.dumps(
        {"views": 0}))
    (base / "metrics" / "frames.replay.py").write_text(
        "def read(run):\n    return float(run.window_steps)\n")
    bench["configs"].append({"name": "garden", "source": "https://x.org",
                             "file": "gsbench/configs/garden.json",
                             "reduced": [], "why": "a new scene"})
    bench["workloads"].append({"name": "garden.replay", "config": "garden",
                               "traffic": "replay", "chips": 1,
                               "why": "a new loop"})
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "views/s",
                                "better": "higher", "bound": 0.02,
                                "source": "host_clock",
                                "workloads": ["garden.replay"]})
    bench["per_layer"].append({"name": "frames.replay", "unit": "views",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "frames_per_s",
                               "workloads": ["garden.replay"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", LOAD, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "garden"
    plain, traced = got["0"], got["1"]
    assert plain["correct"] and traced["correct"]
    assert plain["checks"] == {"views": {"value": 0, "limit": 0}}
    assert set(plain["metrics"]) == {"frames_per_s", "peak_mem_gib",
                                     "setup_s"}
    assert traced["metrics"] == {"frames.replay": {"value": 8.0,
                                                   "unit": "views"}}
    # nothing that was there is edited, and the old cells read as before
    after = digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
    assert got["old"] == [m["name"] for m in
                          spec.load_cell("bicycle.train").per_layer]
