"""The training loop over 4 gloo ranks spawned once for the file (moved
from ``test_torch_parallel_loop.py``, whose fixtures it uses): every rank
ends with the same parameters to the bit."""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as R
from test_torch_parallel_loop import plain, scene

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    # started with the file's first test: the ranks run while its
    # unsharded reference loop does
    return R.Ranks("loop")


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
