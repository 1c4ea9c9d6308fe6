"""The port's (data, tile) grid train step (``parallel/grid_train.py``)
held against the JAX package's (``make_grid_train_step`` on a 2×4 mesh of
its 8 CPU devices, Pallas in interpret mode, jitted whole), against the
port's camera-batched step, and against itself on grids of 1×1, 2×1 and
2×2 gloo ranks (twins of ``tests/test_grid_train.py``; the loop's grid
mode is in ``test_torch_parallel_loop.py``).

B = 2 cameras; on the 1×1 grid one rank takes both. Both packages start
from one numpy state with prior Adam moments. Tolerances: the JAX tests'
(parameters 2e-5 rel + 2e-6 abs, ``xyz_grad_accum`` 2e-4 rel, ``denom``
and the visible count equal; against the camera-batched step on the
``jnp`` compositor 5e-4 rel + 5e-5 abs), the loss within 1e-5; across
grids within the f32 rounding of sums taken over other ranks (1e-6 rel +
1e-9 abs: an Adam step may land one ulp apart).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R
from jax.sharding import Mesh
from test_torch_train import jax_state

from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView
from mvs_gaussian_splatting_tpu.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu.parallel.data_parallel import stack_cameras
from mvs_gaussian_splatting_tpu.parallel.grid_train import \
    make_grid_train_step
from mvs_gaussian_splatting_tpu.train.config import OptimizationConfig

torch.set_num_threads(1)

W, H = R.TT_W, R.TT_H


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("grid")


@functools.lru_cache(maxsize=None)
def jax_grid():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "tile"))
    step, place = make_grid_train_step(
        OptimizationConfig(), RasterConfig(max_tiles_per_gaussian=16,
                                           backend="stream"), 1.0, mesh,
        interpret=True)
    cams = stack_cameras([CameraView(*(jnp.asarray(a) for a in c))
                          for c in R.grid_cameras()])
    args = place(*jax_state(*R.step_state(), count=20), cams,
                 jnp.asarray(R.gts_np(R.GRID_B, W, H)), jnp.zeros(3))
    p, adam, aux, m = step(*args, jnp.int32(1), jnp.asarray(True), width=W,
                           height=H, sh_degree=1)
    return ({k: np.asarray(v) for k, v in p._asdict().items()
             if v is not None},
            {k: np.asarray(v) for k, v in aux._asdict().items()},
            float(m.loss), int(m.n_visible))


def _close(got, want, rtol, atol, what):
    for part in ("params", "aux"):
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=rtol, atol=atol,
                                       err_msg=f"{what}, {k}")


class TestGridParity:
    def test_matches_jax_grid(self, ranks):
        jp, jaux, jloss, jvis = jax_grid()
        r0 = ranks.get()[0]
        for n in R.SIZES:
            got = r0[("step", n)]
            assert got["metrics"]["loss"] == pytest.approx(jloss, rel=1e-5)
            assert got["metrics"]["n_visible"] == jvis
            for k, v in jp.items():
                np.testing.assert_allclose(got["params"][k], v, rtol=2e-5,
                                           atol=2e-6, err_msg=f"{n}, {k}")
            np.testing.assert_allclose(got["aux"]["xyz_grad_accum"],
                                       jaux["xyz_grad_accum"], rtol=2e-4,
                                       atol=1e-8)
            np.testing.assert_array_equal(got["aux"]["denom"], jaux["denom"])

    def test_tile_shard_count_invariance(self, ranks):
        """2×1 against 2×2 (and 1×1): the tile axis is invisible."""
        res = ranks.get()
        want = res[0][("step", 2)]
        for n in (1, 4):
            for r in range(n):
                got = res[r][("step", n)]
                assert got["metrics"] == want["metrics"]
                _close(got, want, 1e-6, 1e-9, f"{n} ranks, rank {r}")
                np.testing.assert_array_equal(got["aux"]["denom"],
                                              want["aux"]["denom"])

    def test_parity_vs_camera_dp_step(self, ranks):
        """Grid against the camera-batched step on the jnp compositor, on
        the same grid's data axis."""
        r0 = ranks.get()[0]
        for n in R.SIZES:
            got, dp = r0[("step", n)], r0[("dp_step", n)]
            assert got["metrics"]["loss"] == pytest.approx(
                dp["metrics"]["loss"], rel=1e-5)
            _close(got, dp, 5e-4, 5e-5, f"{n} ranks")
            np.testing.assert_array_equal(got["aux"]["denom"],
                                          dp["aux"]["denom"])

    def test_grid_training_reduces_loss(self, ranks):
        losses = ranks.get()[0][("losses", 2)]
        assert losses[-1] < losses[0] * 0.96, losses
