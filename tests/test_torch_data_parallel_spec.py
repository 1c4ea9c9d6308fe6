"""The camera-batched speculative (grow-mode) step held against the JAX
package's and across 1, 2 and 4 gloo ranks spawned once for the file
(moved from ``test_torch_data_parallel.py``, whose helpers and bounds it
uses)."""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as R
from test_torch_data_parallel import H, W, jax_spec

from mvs_gaussian_splatting_tpu_torch.parallel.mesh import make_mesh as tmesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("spec_batch")


class TestSpecBatchStep:
    def test_b1_matches_single(self):
        single, batched = R.spec_steps(tmesh(1))
        cam = R.torch_camera(R.orbit_camera_np(W, H, 0.35))
        one = R.spec_step_result(single, cam)
        got = R.spec_step_result(batched, [cam])
        assert got["metrics"]["loss"] == pytest.approx(
            one["metrics"]["loss"], rel=1e-6)
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_array_equal(got["aux"]["denom"], one["aux"]["denom"])

    def test_b4_sharded_runs_and_accumulates_stats(self, ranks):
        jp, jaux, jloss = jax_spec(4)
        res = ranks.get()
        denom_before = R.grow_state()[3]["denom"].sum()
        for n in R.SIZES:
            got = res[0][("spec4", n)]
            assert np.isfinite(got["metrics"]["loss"])
            assert got["aux"]["denom"].sum() > denom_before
            for v in got["params"].values():
                assert np.isfinite(v).all()
            assert got["metrics"]["loss"] == pytest.approx(jloss, rel=1e-5)
            for k, v in jp.items():
                np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                           err_msg=f"{n} ranks, {k}")
            np.testing.assert_array_equal(got["aux"]["denom"],
                                          jaux["denom"])
