"""The port's training loop in every multi-device mode
(``train/loop.py:make_parallel_step``): ``--data_parallel``,
``--tile_parallel``, both at once (the grid), ``--gauss_parallel`` and
``--grow_dir --data_parallel``, at world size 1 in this process (grow
mode, the mesh check and the CLI in ``test_torch_parallel_loop_modes.py``);
over 4 gloo ranks in ``test_torch_parallel_loop_ranks.py`` and
``test_torch_parallel_loop_diverged.py``.

Across ranks the loop must not diverge: every rank draws the same
cameras and random numbers, and after each densify round the loop
all-gathers a checksum of the parameters and Adam state and raises if a
rank differs; the runs there end with every rank's parameters equal to
the bit. The sharded modes give the unsharded loop's test PSNR (1e-4 dB).
"""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return R.write_scene(str(tmp_path_factory.mktemp("loop")))


@pytest.fixture(scope="module")
def plain(scene):
    return R.train_loop(scene)


def _finite(params):
    return all(np.isfinite(v).all() for v in params.values())


# each mode's flags and the line the loop logs for it; the last, grow
# mode, runs in test_torch_parallel_loop_modes.py
MODES = [
    pytest.param(dict(data_parallel=2),
                 "data-parallel: 2 cameras/step over 1 device", id="data"),
    pytest.param(dict(tile_parallel=1), "tile-parallel: 1 camera/step, "
                 "tiles sharded over 1 device", id="tile"),
    pytest.param(dict(data_parallel=2, tile_parallel=1),
                 "grid-parallel: 2 cameras/step × 1-way tile sharding (1 "
                 "device", id="grid"),
    pytest.param(dict(gauss_parallel=1),
                 "gauss-parallel: params sharded over 1 device", id="gauss"),
    pytest.param(dict(data_parallel=2, grow=True),
                 "data-parallel: 2 cameras/step over 1 device",
                 id="grow_data"),
]


def check_mode_at_world_size_one(scene, plain, flags, line):
    logs, hist, params = R.train_loop(scene, **flags)
    assert any(line in entry for entry in logs), logs
    assert np.isfinite(hist["psnr_test"][6]) and _finite(params)
    if flags in (dict(tile_parallel=1), dict(gauss_parallel=1)):
        # one shard: the unsharded operator
        assert hist["psnr_test"][6] == pytest.approx(
            plain[1]["psnr_test"][6], abs=1e-4)


@pytest.mark.parametrize("flags, line", MODES[:4])
def test_loop_runs_mode_at_world_size_one(scene, plain, flags, line):
    check_mode_at_world_size_one(scene, plain, flags, line)
