"""The port's training loop in every multi-device mode
(``train/loop.py:make_parallel_step``): ``--data_parallel``,
``--tile_parallel``, both at once (the grid), ``--gauss_parallel`` and
``--grow_dir --data_parallel``, at world size 1 in this process and over
4 gloo ranks spawned once for the file (``torch_parallel_ranks.py``).

Across ranks the loop must not diverge: every rank draws the same
cameras and random numbers, and after each densify round the loop
all-gathers a checksum of the parameters and Adam state and raises if a
rank differs; the runs here end with every rank's parameters equal to the
bit. The sharded modes give the unsharded loop's test PSNR (1e-4 dB).
"""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as R

from mvs_gaussian_splatting_tpu_torch.cli.train import main as cli_main

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    # started with the file's first test: the ranks run while the
    # world-size-1 loops do
    return R.Ranks("loop")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return R.write_scene(str(tmp_path_factory.mktemp("loop")))


@pytest.fixture(scope="module")
def plain(scene):
    return R.train_loop(scene)


def _finite(params):
    return all(np.isfinite(v).all() for v in params.values())


@pytest.mark.parametrize("flags, line", [
    (dict(data_parallel=2), "data-parallel: 2 cameras/step over 1 device"),
    (dict(tile_parallel=1), "tile-parallel: 1 camera/step, tiles sharded "
                            "over 1 device"),
    (dict(data_parallel=2, tile_parallel=1),
     "grid-parallel: 2 cameras/step × 1-way tile sharding (1 device"),
    (dict(gauss_parallel=1), "gauss-parallel: params sharded over 1 device"),
    (dict(data_parallel=2, grow=True),
     "data-parallel: 2 cameras/step over 1 device"),
], ids=["data", "tile", "grid", "gauss", "grow_data"])
def test_loop_runs_mode_at_world_size_one(scene, plain, flags, line):
    logs, hist, params = R.train_loop(scene, **flags)
    assert any(line in entry for entry in logs), logs
    assert np.isfinite(hist["psnr_test"][6]) and _finite(params)
    if flags in (dict(tile_parallel=1), dict(gauss_parallel=1)):
        # one shard: the unsharded operator
        assert hist["psnr_test"][6] == pytest.approx(
            plain[1]["psnr_test"][6], abs=1e-4)


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


@pytest.mark.parametrize("mode", ["data_densify", "tile", "grid", "gauss"])
def test_ranks_agree_over_four_ranks(ranks, plain, mode):
    res = ranks.get()
    logs, hist, params = res[0][(mode, 4)]
    assert np.isfinite(hist["psnr_test"][max(hist["psnr_test"])])
    for r in range(1, 4):
        other = res[r][(mode, 4)]
        for k, v in params.items():
            np.testing.assert_array_equal(other[2][k], v, err_msg=k)
        assert other[1]["psnr_test"] == hist["psnr_test"]
    if mode in ("tile", "gauss"):
        assert hist["psnr_test"][6] == pytest.approx(
            plain[1]["psnr_test"][6], abs=1e-4)
    if mode == "data_densify":
        # densify rounds ran, and each one's checksums agreed
        assert len(hist["densify"]) >= 2
        assert [c[0] for c in hist["rank_checksums"]] == [
            d["iteration"] for d in hist["densify"]]


def test_divergent_rank_is_caught(ranks):
    res = ranks.get()
    for r in range(4):
        assert "the ranks diverged" in res[r][("diverged", 4)]
