"""The port's Gaussian-sharded train step (``parallel/gauss_train.py``:
parameters, Adam state and statistics in blocks of C/D rows, one
``all_to_all`` per step) held against the JAX package's
(``make_gauss_train_step`` on its 8 CPU devices, Pallas in interpret
mode, jitted whole) and against itself across 1, 2 and 4 gloo ranks
(twins of ``tests/test_gauss_train.py``; the loop's gauss mode is in
``test_torch_parallel_loop.py``).

The ranks are spawned once for the file; each runs the step on its block
and the blocks are gathered for the comparison. Both packages start from
one numpy state with prior Adam moments. Tolerances: the JAX test's
(parameters 2e-5 rel + 2e-6 abs, ``xyz_grad_accum`` 2e-4 rel, ``denom``
and the visible count equal, the loss 1e-5 rel); across rank counts
within the f32 rounding of the instance gradients' sums (1e-6 rel +
1e-9 abs).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R
from test_torch_train import jax_state

from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView
from mvs_gaussian_splatting_tpu.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu.parallel.gauss_train import \
    make_gauss_train_step
from mvs_gaussian_splatting_tpu.parallel.mesh import make_mesh
from mvs_gaussian_splatting_tpu.train.config import OptimizationConfig
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
    RasterConfig as TConfig
from mvs_gaussian_splatting_tpu_torch.parallel.gauss_train import \
    make_gauss_train_step as tmake_gauss_train_step
from mvs_gaussian_splatting_tpu_torch.parallel.mesh import make_mesh as tmesh
from mvs_gaussian_splatting_tpu_torch.train.config import \
    OptimizationConfig as TOptimizationConfig

torch.set_num_threads(1)

W, H = R.TT_W, R.TT_H


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("gauss_train")


@functools.lru_cache(maxsize=None)
def jax_step():
    mesh = make_mesh(8, axes=("gauss",))
    step, place = make_gauss_train_step(
        OptimizationConfig(), RasterConfig(max_tiles_per_gaussian=16,
                                           backend="stream"), 1.0, mesh,
        interpret=True)
    cam = CameraView(*(jnp.asarray(a) for a in R.camera_np(W, H)))
    args = place(*jax_state(*R.step_state(), count=20), cam,
                 jnp.asarray(R.gts_np(1, W, H)[0]), jnp.zeros(3))
    p, adam, aux, m = step(*args, jnp.int32(1), jnp.asarray(True), width=W,
                           height=H, sh_degree=1)
    return ({k: np.asarray(v) for k, v in p._asdict().items()
             if v is not None},
            {k: np.asarray(v) for k, v in aux._asdict().items()},
            float(m.loss), int(m.n_visible))


def test_step_matches_jax(ranks):
    jp, jaux, jloss, jvis = jax_step()
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


def test_step_invariant_to_rank_count(ranks):
    res = ranks.get()
    want = res[0][("step", 1)]
    for n in (2, 4):
        for r in range(n):
            got = res[r][("step", n)]
            assert got["metrics"] == want["metrics"]
            for part in ("params", "mu", "aux"):
                for k, v in want[part].items():
                    np.testing.assert_allclose(got[part][k], v, rtol=1e-6,
                                               atol=1e-9,
                                               err_msg=f"{n}, {r}, {k}")
            np.testing.assert_array_equal(got["aux"]["denom"],
                                          want["aux"]["denom"])


def test_gauss_parallel_training_reduces_loss(ranks):
    losses = ranks.get()[0][("losses", 2)]
    assert losses[-1] < losses[0] * 0.96, losses


def test_rejects_non_stream_backend():
    step = tmake_gauss_train_step(
        TOptimizationConfig(), TConfig(backend="jnp"), 1.0,
        tmesh(1, axes=("gauss",)))
    params, adam, aux = R.torch_state(*R.step_state())
    with pytest.raises(ValueError, match="stream"):
        step(params, adam, aux, R.torch_camera(R.camera_np(W, H)),
             torch.zeros(3, H, W), torch.zeros(3), 1, True, width=W,
             height=H, sh_degree=1)
