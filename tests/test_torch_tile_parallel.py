"""The port's tile-sharded padded-table compositor
(``parallel/tile_parallel.py``, the ``jnp`` compositor: no kernel) held
against the JAX package's single-device ``jnp`` render (jitted whole;
``tests/test_tile_parallel.py`` holds the JAX sharded compositor to it)
and against itself across 1, 2 and 4 gloo ranks (twins of
``tests/test_tile_parallel.py``).

80×48 at 16×16 is 15 tiles: 2 and 4 ranks hold pad tiles. The ranks are
spawned once for the file. Tolerances: the JAX tests' (image 1e-5 abs +
1e-4 rel; the xy gradient of Σ tiles² 1e-3 abs + 1e-3 rel); across rank
counts the port is held to the bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R

from mvs_gaussian_splatting_tpu.ops import CameraView, preprocess
from mvs_gaussian_splatting_tpu.ops.rasterize import RasterConfig, rasterize
from mvs_gaussian_splatting_tpu.utils.transforms import normalize

torch.set_num_threads(1)

W, H = R.TS_W, R.TS_H
CFG = RasterConfig(tile_capacity=128, tile_batch=8, backend="jnp")


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("tile_parallel")


@functools.lru_cache(maxsize=None)
def jax_refs():
    cam = CameraView(*(jnp.asarray(a) for a in R.camera_np(W, H)))

    def pre(means, scales, quats, opac, cols):
        return preprocess(means, opac, cam, W, H, scales=scales,
                          rotations=normalize(quats), colors_precomp=cols)

    @jax.jit
    def refs(a_img, a_grad):
        img, _ = rasterize(pre(*a_img), W, H, jnp.array([0.2, 0.3, 0.4]),
                           CFG)
        p = pre(*a_grad)

        def loss(xy):
            im, _ = rasterize(p._replace(xy=xy), W, H, jnp.zeros(3), CFG)
            return (im ** 2).sum()
        return img, jax.grad(loss)(p.xy)

    img, g = refs(tuple(jnp.asarray(a) for a in R.splats_np(120, 0)),
                  tuple(jnp.asarray(a) for a in R.splats_np(80, 3)))
    return np.asarray(img), np.asarray(g)


def test_tile_sharded_matches_single_device(ranks):
    want = jax_refs()[0]
    res = ranks.get()
    for n in R.SIZES:
        np.testing.assert_allclose(res[0][("image", n)], want, atol=1e-5,
                                   rtol=1e-4, err_msg=f"{n} ranks")
        for r in range(n):
            np.testing.assert_array_equal(res[r][("image", n)],
                                          res[0][("image", 1)])


def test_tile_sharded_gradients(ranks):
    want = jax_refs()[1]
    res = ranks.get()
    for n in R.SIZES:
        np.testing.assert_allclose(res[0][("grad_xy", n)], want, atol=1e-3,
                                   rtol=1e-3, err_msg=f"{n} ranks")
        for r in range(n):
            np.testing.assert_array_equal(res[r][("grad_xy", n)],
                                          res[0][("grad_xy", 1)])
