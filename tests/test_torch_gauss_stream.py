"""The port's Gaussian-sharded stream render (``parallel/gauss_stream.py``:
local binning with the ``round_robin=D`` remap, fixed-quota slices, one
``all_to_all``, the (tile, depth) merge, the composite) held against the
JAX package's single-device stream render (Pallas in interpret mode,
jitted whole; ``tests/test_gauss_stream.py`` holds the JAX sharded render
to it) and against itself across 1, 2 and 4 gloo ranks (twins of
``tests/test_gauss_stream.py``).

80×48 at 16×16 is 15 tiles, which 2 and 4 ranks do not divide: every case
runs with pad tiles. The ranks are spawned once for the file. Tolerances:
the JAX tests' (image 1e-5 abs + 1e-4 rel, gradients 2e-5 abs + 1e-3
rel); across rank counts the image is held to the bit and the gradients
within 1e-6 of their scale (each Gaussian's instance gradients are summed
in another order when its instances come from another layout of the
stream).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R

from mvs_gaussian_splatting_tpu.ops import CameraView, preprocess
from mvs_gaussian_splatting_tpu.ops.rasterize import (RasterConfig,
                                                      _rasterize_stream)
from mvs_gaussian_splatting_tpu.utils.transforms import normalize

torch.set_num_threads(1)

W, H = R.GS_W, R.GS_H
TX, TY = -(-W // 16), -(-H // 16)
CFG = RasterConfig(max_tiles_per_gaussian=16, backend="stream")


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("gauss_stream")


@functools.lru_cache(maxsize=None)
def jax_refs():
    cam = CameraView(*(jnp.asarray(a) for a in R.camera_np(W, H)))

    def pre(means, scales, quats, opac, cols):
        return preprocess(means, opac, cam, W, H, scales=scales,
                          rotations=normalize(quats), colors_precomp=cols)

    @jax.jit
    def refs(a_img, a_grad, cot):
        img, _ = _rasterize_stream(pre(*a_img), W, H,
                                   jnp.array([0.2, 0.3, 0.4]), CFG, TX, TY,
                                   interpret=True)

        def loss(*a):
            im, _ = _rasterize_stream(pre(*a), W, H, jnp.zeros(3), CFG, TX,
                                      TY, interpret=True)
            return (im * cot).sum()
        return img, jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*a_grad)

    img, grads = refs(tuple(jnp.asarray(a) for a in R.splats_np(152, 0)),
                      tuple(jnp.asarray(a) for a in R.splats_np(104, 7)),
                      jnp.asarray(R.cotangent_np(W, H, 1)))
    return np.asarray(img), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("mode", ["rr", "strips"])
def test_gauss_sharded_matches_single_device(ranks, mode):
    want = jax_refs()[0]
    res = ranks.get()
    for n in R.SIZES:
        img, quota, capacity = res[0][("image_" + mode, n)]
        np.testing.assert_allclose(img, want, atol=1e-5, rtol=1e-4,
                                   err_msg=f"{mode}, {n} ranks")
        assert quota == 0 and capacity == 0
        for r in range(n):
            np.testing.assert_array_equal(res[r][("image_" + mode, n)][0],
                                          res[0][("image_" + mode, 1)][0])


@pytest.mark.parametrize("mode", ["rr", "strips"])
def test_gauss_sharded_gradients_match(ranks, mode):
    want = jax_refs()[1]
    r0 = ranks.get()[0]
    names = ("means", "scales", "quats", "opac", "cols")
    for n in R.SIZES:
        for got, w, one, name in zip(r0[("grads_" + mode, n)], want,
                                     r0[("grads_" + mode, 1)], names):
            np.testing.assert_allclose(got, w, atol=2e-5, rtol=1e-3,
                                       err_msg=f"{mode}, {n}, {name}")
            assert (np.abs(got - one).max()
                    <= 1e-6 * np.abs(one).max()), (mode, n, name)
