"""The training loop at world size 1 in grow mode, a mesh larger than the
world refused, and the CLI's camera batches (moved from
``test_torch_parallel_loop.py`` and ``test_torch_parallel_loop_ranks.py``;
the fixtures and the modes are ``test_torch_parallel_loop.py``'s)."""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as R
from test_torch_parallel_loop import (MODES, check_mode_at_world_size_one,
                                      plain, scene)

from mvs_gaussian_splatting_tpu_torch.cli.train import main as cli_main

torch.set_num_threads(1)


@pytest.mark.parametrize("flags, line", MODES[4:])
def test_loop_runs_mode_at_world_size_one(scene, plain, flags, line):
    check_mode_at_world_size_one(scene, plain, flags, line)


def test_mesh_larger_than_world_is_an_error(scene):
    with pytest.raises(ValueError, match="world"):
        R.train_loop(scene, tile_parallel=2)
    with pytest.raises(ValueError, match="world"):
        R.train_loop(scene, gauss_parallel=4)


def test_cli_trains_camera_batches(scene, tmp_path):
    params, _, _, hist = cli_main([
        "-s", scene, "-m", str(tmp_path / "model"), "--eval", "--device",
        "cpu", "--iterations", "4", "--data_parallel", "3",
        "--test_iterations", "4", "--save_iterations", "4",
        "--tile_w", "32", "--tile_h", "16", "--no-fast_math"])
    assert np.isfinite(hist["psnr_test"][4])
    assert (tmp_path / "model" / "point_cloud" / "iteration_4").is_dir()
