"""The port's multi-process dry run (``tools/multihost_dryrun.py``) on the
CPU: one tile-sharded train step split over two processes that join
through ``parallel/multihost.initialize()`` from the environment, its loss
within 1e-5 (relative) of the same step in one process, the JAX
repository's ``tests/test_multihost.py`` bound. The record goes to the
path given, not to the JAX repository's ``MULTIHOST_DRYRUN.json``."""

import json
import os
import subprocess
import sys

from mvs_gaussian_splatting_tpu_torch.tools import multihost_dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_step_matches_one(tmp_path):
    out = tmp_path / "mh.json"
    before = os.path.getmtime(os.path.join(ROOT, "MULTIHOST_DRYRUN.json"))
    # at a lower priority and one thread a process, beside the other test
    # workers
    proc = subprocess.run(
        ["nice", "-n", "10", sys.executable, "-m",
         f"{multihost_dryrun.PACKAGE}.tools.multihost_dryrun", "--device",
         "cpu", "--out", str(out)],
        cwd=tmp_path, env=multihost_dryrun._env(OMP_NUM_THREADS=1),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(out.read_text())
    assert result["ok"], result
    assert result["rel_diff"] < 1e-5
    assert "gloo" in result["config"]
    assert before == os.path.getmtime(os.path.join(ROOT,
                                                   "MULTIHOST_DRYRUN.json"))
