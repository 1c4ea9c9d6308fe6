"""A rank whose parameters diverge is caught by the loop's checksum over
4 gloo ranks spawned once for the file (moved from
``test_torch_parallel_loop_ranks.py``)."""

import pytest
import torch
import torch_parallel_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("loop_diverged")


def test_divergent_rank_is_caught(ranks):
    res = ranks.get()
    for r in range(4):
        assert "the ranks diverged" in res[r][("diverged", 4)]
