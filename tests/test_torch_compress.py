"""The port's codebook compression (``models/quantize.py``,
``cli/compress.py``) held against the JAX package.

The JAX package's random draws (``jax.random.randint`` / ``uniform`` under
its keys) are made once and fed to the port as data; the JAX references
are jitted whole. Tolerances are stated where they are used.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models import quantize as jq
from mvs_gaussian_splatting_tpu_torch.data.cameras import Camera
from mvs_gaussian_splatting_tpu_torch.models import quantize as tq
from mvs_gaussian_splatting_tpu_torch.models.ply import save_gaussian_ply
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
    rasterize_reference
from mvs_gaussian_splatting_tpu_torch.utils import graphics

torch.set_num_threads(1)

ATTRS = ("f_rest", "scaling", "rotation")


def t(a):
    return torch.tensor(np.array(a))


def clustered_data(n=512, k=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 3
    return (centers[rng.randint(0, k, n)]
            + rng.randn(n, d) * 0.1).astype(np.float32)


@jax.jit
def _jax_draws_body(key, ridx_like):
    """The draws of JAX ``fit_codebook(key, data, K, iters)``: its initial
    indices, then one ``split`` and ``randint`` an iteration."""
    n = ridx_like.shape[0]
    k_codes = ridx_like.shape[1]
    init = jax.random.randint(key, (k_codes,), 0, n)

    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (k_codes,), 0, n)

    _, ridx = jax.lax.scan(body, key, None, length=ridx_like.shape[2])
    return init, ridx


def jax_draws(key, n, num_codes, iters):
    init, ridx = _jax_draws_body(key, jnp.zeros((n, num_codes, iters),
                                                jnp.int8))
    return np.asarray(init), np.asarray(ridx)


_jfit = jax.jit(jq.fit_codebook, static_argnums=(2, 3))


def _gaussians(n, seed, sh_rest=15):
    rng = np.random.RandomState(seed)
    return {
        "xyz": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "f_dc": rng.randn(n, 1, 3).astype(np.float32),
        "f_rest": (rng.randn(n, sh_rest, 3) * 0.1).astype(np.float32),
        "opacity": rng.randn(n, 1).astype(np.float32),
        "scaling": rng.uniform(-4, -2, (n, 3)).astype(np.float32),
        "rotation": rng.randn(n, 4).astype(np.float32),
    }


class TestQuantizers:
    def test_nearest_code_equal(self):
        """Codes equal to the JAX package's on a hand-made case and on 300
        random rows against 16 codes."""
        cb = np.array([[0.0, 0], [10, 0], [0, 10]], np.float32)
        x = np.array([[0.1, 0.1], [9, 1], [1, 9]], np.float32)
        assert tq.nearest_code(t(x), t(cb)).tolist() == [0, 1, 2]
        rng = np.random.RandomState(0)
        x = rng.randn(300, 8).astype(np.float32)
        cb = rng.randn(16, 8).astype(np.float32)
        np.testing.assert_array_equal(
            tq.nearest_code(t(x), t(cb)).numpy(),
            np.asarray(jax.jit(jq.nearest_code)(x, cb)))

    def test_vq_straight_through(self):
        """Quantized rows, codes and loss within 1e-6 of the JAX package's;
        the gradient of Σ q² passes straight through to x (2q, within
        1e-6), as JAX's does."""
        x = clustered_data()
        cbj = jax.random.normal(jax.random.PRNGKey(0), (16, 8))
        cb = np.asarray(cbj)

        @jax.jit
        def jref(x_):
            q, codes, loss = jq.vq_quantize(x_, cbj)
            g = jax.grad(lambda z: (jq.vq_quantize(z, cbj)[0] ** 2).sum())(x_)
            return q, codes, loss, g

        jqv, jcodes, jloss, jg = jref(x)
        xt = t(x).requires_grad_()
        q, codes, loss = tq.vq_quantize(xt, t(cb))
        (g,) = torch.autograd.grad((q ** 2).sum(), xt)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_allclose(q.detach().numpy(), jqv, atol=1e-6)
        assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), 2 * q.detach().numpy(),
                                   atol=1e-6)
        assert np.abs(g.numpy()).max() > 0

    def test_kmeans_update(self):
        """One EMA k-means step: codebook, counts and sums within 1e-6."""
        x = clustered_data(seed=1)
        cb = x[::37][:12].copy()
        jstate = jq.CodebookState(cb, jnp.ones(12), cb)
        want = jax.jit(jq.kmeans_update)(jstate, x)
        got = tq.kmeans_update(tq.CodebookState(t(cb), torch.ones(12), t(cb)),
                               t(x))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)


def _model_dir(root, n=200, sh_degree=1, seed=0):
    g = _gaussians(n, seed, sh_rest=(sh_degree + 1) ** 2 - 1)
    d = os.path.join(root, "point_cloud", "iteration_50")
    os.makedirs(d)
    save_gaussian_ply(os.path.join(d, "point_cloud.ply"), g)
    return root, g


def _render(g, w=48, h=48):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
    cam = Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.array([0, 0, 4.0]),
                 fovx=fovx, fovy=fovy, image=None, image_name="c",
                 width=w, height=h)
    shs = torch.cat([t(g["f_dc"]), t(g["f_rest"])], 1)
    with torch.no_grad():
        p = preprocess(t(g["xyz"]), torch.sigmoid(t(g["opacity"])[:, 0]),
                       cam.view("cpu"), w, h,
                       scales=torch.exp(t(g["scaling"])),
                       rotations=t(g["rotation"]), shs=shs, sh_degree=1)
        return rasterize_reference(p, w, h, torch.zeros(3)).numpy()
