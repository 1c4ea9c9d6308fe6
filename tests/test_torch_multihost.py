"""The port's process-group start-up (``parallel/multihost.py``): two
processes that know only the environment ``torchrun`` gives them join
through ``initialize()`` and take one tile-parallel step, whose loss
equals one process's within 1e-5 (twin of ``tests/test_multihost.py``);
``initialize()`` is a no-op at world size 1; ``spawn`` reports a failing
rank; ``measure_scaling`` at world size 1."""

import os

import pytest
import torch
import torch_parallel_ranks as R

from mvs_gaussian_splatting_tpu_torch.parallel import multihost

torch.set_num_threads(1)


def test_two_process_distributed_step():
    one = R.tile_step_loss()
    got = R.spawn_env(2)
    assert [g[:3] for g in got] == [(0, 2, "gloo"), (1, 2, "gloo")]
    for *_, loss in got:
        assert loss == pytest.approx(one, rel=1e-5)


def test_initialize_is_a_no_op_alone(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize()
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert (multihost.rank(), multihost.world_size()) == (0, 1)
    assert multihost.device() == (torch.device("cuda", 0)
                                  if torch.cuda.is_available()
                                  else torch.device("cpu"))


def _fail(rank, world):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank one fails"):
        multihost.spawn(_fail, 2)


def test_measure_scaling_at_world_size_one():
    calls = []
    res = multihost.measure_scaling(lambda n: lambda: calls.append(n),
                                    iters=3)
    assert list(res) == [1] and calls == [1] * 4
    assert res[1]["efficiency"] == 1.0 and res[1]["ms"] >= 0
    assert os.environ.get("WORLD_SIZE", "1") == "1"
