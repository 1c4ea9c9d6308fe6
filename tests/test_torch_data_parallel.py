"""The port's camera-batched steps (``parallel/data_parallel.py`` and
``train/grow_step.py:make_spec_batch_train_step``) held against the JAX
package's on its 8-device CPU mesh (jitted whole) and against themselves
across 1, 2 and 4 gloo ranks (twins of ``tests/test_parallel.py``'s
``TestDataParallel`` and ``TestSpecBatchStep``).

The ranks are spawned once for the file (``torch_parallel_ranks.py``);
B = 8 cameras on a 32×32 image, the padded ``jnp`` compositor, as the JAX
tests. Both packages start from one numpy state with prior Adam moments.
Tolerances: the JAX tests' (positions 1e-5, ``xyz_grad_accum`` 1e-5 abs +
1e-4 rel, the loss 1e-5 rel, ``denom`` equal); across rank counts the
loss and ``denom`` are equal, the rest within the f32 rounding of a sum
taken over other ranks (1e-6 rel + 1e-9 abs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R
from test_torch_train import jax_state

from mvs_gaussian_splatting_tpu.models.grow import GrowConfig
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView
from mvs_gaussian_splatting_tpu.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu.parallel import make_batch_train_step, make_mesh
from mvs_gaussian_splatting_tpu.parallel.data_parallel import stack_cameras
from mvs_gaussian_splatting_tpu.train import OptimizationConfig
from mvs_gaussian_splatting_tpu.train.grow_step import \
    make_spec_batch_train_step
from mvs_gaussian_splatting_tpu.utils.sphere import sphere_points

torch.set_num_threads(1)

W, H = R.DP_W, R.DP_H


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("data_parallel")


def _jcam(c):
    return CameraView(*(jnp.asarray(a) for a in c))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()
            if v is not None}


@functools.lru_cache(maxsize=None)
def _jax_batch_step():
    mesh = make_mesh(8)
    raster = RasterConfig(tile_capacity=64, max_tiles_per_gaussian=8,
                          tile_batch=8, backend="jnp")
    return (mesh, *make_batch_train_step(OptimizationConfig(), raster, 1.0,
                                         mesh))


@functools.lru_cache(maxsize=None)
def jax_batch(copies: bool):
    """The JAX batched step on 8 devices: the 8 cameras, or 8 copies of
    camera 1."""
    cams = [_jcam(c) for c in R.dp_cameras()]
    gts = R.gts_np(R.DP_B, W, H)
    if copies:
        cams, gts = [cams[1]] * 8, np.repeat(gts[1:2], 8, axis=0)
    mesh, step, place = _jax_batch_step()
    with mesh:
        args = place(*jax_state(*R.dp_state(), count=20),
                     stack_cameras(cams), jnp.asarray(gts), jnp.zeros(3))
        p, adam, aux, m = step(*args, jnp.int32(1), jnp.asarray(True),
                               width=W, height=H, sh_degree=0)
    return _np(p), _np(aux), float(m.loss), int(m.n_visible)


@functools.lru_cache(maxsize=None)
def jax_spec(b: int):
    """The JAX batched speculative step on ``b`` devices."""
    cfg = GrowConfig(**R.GROW_FLAGS, num_dirs=16)
    raster = RasterConfig(tile_capacity=128, max_tiles_per_gaussian=16,
                          tile_batch=8, backend="jnp")
    mesh = make_mesh(b)
    step, place = make_spec_batch_train_step(
        OptimizationConfig(), raster, 1.0, cfg, sphere_points(16), 8, 10.0,
        mesh)
    cams = [_jcam(R.orbit_camera_np(W, H, 0.3 + 0.2 * i)) for i in range(b)]
    with mesh:
        args = place(*jax_state(*R.grow_state(), count=20),
                     stack_cameras(cams), jnp.full((b, 3, H, W), 0.4),
                     jnp.zeros(3))
        p, adam, aux, m = step(*args, jnp.int32(600), jnp.asarray(True),
                               jax.random.PRNGKey(5), width=W, height=H,
                               sh_degree=0)
    return _np(p), _np(aux), float(m.loss)


class TestDataParallel:
    def test_sharded_matches_jax(self, ranks):
        jp, jaux, jloss, jvis = jax_batch(False)
        r0 = ranks.get()[0]
        for n in R.SIZES:
            got = r0[("batch", n)]
            np.testing.assert_allclose(got["params"]["xyz"], jp["xyz"],
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got["aux"]["xyz_grad_accum"],
                                       jaux["xyz_grad_accum"], atol=1e-5,
                                       rtol=1e-4)
            np.testing.assert_array_equal(got["aux"]["denom"], jaux["denom"])
            assert got["metrics"]["loss"] == pytest.approx(jloss, rel=1e-5)
            assert got["metrics"]["n_visible"] == jvis

    def test_stats_accumulate_over_batch(self, ranks):
        res = ranks.get()
        want = res[0][("batch", 1)]
        # every visible Gaussian was seen by up to 8 cameras
        assert want["aux"]["denom"].max() > 1.0
        assert want["metrics"]["n_visible"] > 0
        for n in (2, 4):
            for r in range(n):
                got = res[r][("batch", n)]
                assert got["metrics"] == want["metrics"]
                np.testing.assert_array_equal(got["aux"]["denom"],
                                              want["aux"]["denom"])
                for part in ("params", "mu", "aux"):
                    for k, v in want[part].items():
                        np.testing.assert_allclose(got[part][k], v, rtol=1e-6,
                                                   atol=1e-9, err_msg=k)

    def test_statistics_carry_one_over_b(self, ranks):
        """The reference differentiates the batch MEAN, so each camera's
        viewspace-gradient norm carries 1/B while ``denom`` counts every
        camera (ROADMAP C12): eight copies of one camera accumulate the norm
        of ONE camera's gradient (8 × 1/8) against a denom of 8. The port
        reproduces it, held to the JAX step."""
        jp, jaux, jloss, _ = jax_batch(True)
        for n in R.SIZES:
            got = ranks.get()[0][("copies", n)]["aux"]
            np.testing.assert_allclose(got["xyz_grad_accum"],
                                       jaux["xyz_grad_accum"], atol=1e-5,
                                       rtol=1e-4)
            np.testing.assert_array_equal(got["denom"], jaux["denom"])
        base = R.dp_state()[3]
        seen = got["denom"] > base["denom"]
        assert seen.any()
        np.testing.assert_array_equal((got["denom"] - base["denom"])[seen],
                                      8.0)
