"""The Gaussian-sharded render's quota overflow counted over 4 gloo ranks
spawned once for the file (moved from ``test_torch_gauss_stream.py``)."""

import pytest
import torch
import torch_parallel_ranks as R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("gauss_quota")


def test_quota_overflow_is_counted(ranks):
    """1,600 Gaussians against the least quota (128 rows per source and
    destination): strips are cut, and the counter sees it."""
    finite, quota = ranks.get()[0][("quota", 4)]
    assert finite and quota > 0
