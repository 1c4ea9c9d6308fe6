"""The port's codebook compression (``models/quantize.py``,
``cli/compress.py``) held against the JAX package.

The JAX package's random draws (``jax.random.randint`` / ``uniform`` under
its keys) are made once and fed to the port as data; the JAX references
are jitted whole. Tolerances are stated where they are used.
"""

import filecmp
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.cli import compress as jcli
from mvs_gaussian_splatting_tpu.models import quantize as jq
from mvs_gaussian_splatting_tpu_torch.cli import compress as tcli
from mvs_gaussian_splatting_tpu_torch.data.cameras import Camera
from mvs_gaussian_splatting_tpu_torch.models import quantize as tq
from mvs_gaussian_splatting_tpu_torch.models.ply import (load_gaussian_ply,
                                                         save_gaussian_ply)
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

    @pytest.mark.parametrize("case", ["clustered", "gaussian", "reseeded"])
    def test_fit_codebook_with_jax_draws(self, case):
        """50 iterations with the JAX draws fed in: every code equal, the
        codebook within 1e-5 of its largest magnitude and the counts within
        1e-5 relative, on 4 clusters
        against 4 codes, on unclustered rows against 64 codes, and on rows
        whose initial draws repeat a row with ``dead_count=1`` (a code that
        gets no row is re-seeded at once; at the default 1e-3 a code's
        count, starting at 1 and decaying by 0.99 an iteration, would need
        688 iterations).

        The nearest-code expansion |x|² − 2x·c + |c|² loses about 1e-5 to
        cancellation in f32 in both packages, and they sum their products
        in different orders: a row within that of a tie may take either
        code, and the two trajectories then part (4 clusters against 16
        codes part by up to 9e-5 of scale). So every row's final nearest
        code is held at least 1e-5 (in f64) ahead of its second."""
        dead = 1e-3
        if case == "clustered":
            x, k, seed = clustered_data(seed=0), 4, 0
        else:
            x = (np.random.RandomState(0 if case == "reseeded" else 1)
                 .randn(400, 45) * 0.1).astype(np.float32)
            k, seed = 64, 0 if case == "reseeded" else 1
            if case == "reseeded":
                dead = 1.0
        key = jax.random.PRNGKey(seed)
        init, ridx = jax_draws(key, x.shape[0], k, 50)
        if case == "reseeded":
            assert np.unique(init).size < k
        want = _jfit(key, jnp.asarray(x), k, 50, dead)
        got = tq.fit_codebook(t(x), k, 50, dead_count=dead,
                              init_idx=t(init), reseed_idx=t(ridx))
        cb = np.asarray(want.codebook)
        np.testing.assert_allclose(got.codebook.numpy(), cb,
                                   atol=1e-5 * np.abs(cb).max(), rtol=0)
        np.testing.assert_allclose(got.counts.numpy(), want.counts,
                                   rtol=1e-5)
        np.testing.assert_array_equal(
            tq.nearest_code(t(x), got.codebook).numpy(),
            np.asarray(jq.nearest_code(jnp.asarray(x), want.codebook)))
        d2 = ((x[:, None].astype(np.float64) - cb[None]) ** 2).sum(-1)
        d2.sort(axis=1)
        assert (d2[:, 1] - d2[:, 0]).min() > 1e-5

    def test_gumbel_and_argmax_with_jax_noise(self):
        """The Gumbel mixture (soft and hard) with the JAX uniforms fed in,
        and the straight-through argmax: outputs within 1e-6 of the JAX
        package's, and the gradients of Σ q·w with respect to the logits
        within 1e-6."""
        cbj = jax.random.normal(jax.random.PRNGKey(0), (16, 8))
        cb = np.asarray(cbj)
        logits = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (32, 16)))
        w = np.random.RandomState(5).randn(32, 8).astype(np.float32)
        gkey = jax.random.PRNGKey(2)
        u = np.asarray(jax.random.uniform(gkey, logits.shape))

        @jax.jit
        def jref(lg):
            outs = {}
            for hard in (False, True):
                f = (lambda z, h=hard: jq.gumbel_quantize(gkey, z, cbj,
                                                          hard=h))
                outs[f"hard={hard}"] = (f(lg), jax.grad(
                    lambda z, f=f: (f(z)[0] * w).sum())(lg))
            fa = lambda z: jq.argmax_quantize(z, cbj)  # noqa: E731
            outs["argmax"] = (fa(lg), jax.grad(
                lambda z: (fa(z)[0] * w).sum())(lg))
            return outs

        want = jref(logits)
        for hard in (False, True):
            lt = t(logits).requires_grad_()
            q, probs = tq.gumbel_quantize(lt, t(cb), hard=hard, uniform=t(u))
            (g,) = torch.autograd.grad((q * t(w)).sum(), lt)
            (jqv, jprobs), jg = want[f"hard={hard}"]
            np.testing.assert_allclose(q.detach().numpy(), jqv, atol=1e-6)
            np.testing.assert_allclose(probs.detach().numpy(), jprobs,
                                       atol=1e-6)
            np.testing.assert_allclose(g.numpy(), jg, atol=1e-6)
            np.testing.assert_allclose(probs.detach().sum(-1).numpy(), 1.0,
                                       atol=1e-5)
        lt = t(logits).requires_grad_()
        q, idx = tq.argmax_quantize(lt, t(cb))
        (g,) = torch.autograd.grad((q * t(w)).sum(), lt)
        (jqv, jidx), jg = want["argmax"]
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(q.detach().numpy(), jqv, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-6)

    def test_draws_from_a_generator(self):
        """Without draws given, one seed gives one codebook, and another
        seed another one (the draws come from the generator)."""
        x = t(clustered_data(seed=4))
        fits = [tq.fit_codebook(x, 8, 5,
                                generator=torch.Generator().manual_seed(s))
                for s in (7, 7, 8)]
        torch.testing.assert_close(fits[0].codebook, fits[1].codebook,
                                   rtol=0, atol=0)
        assert not torch.equal(fits[0].codebook, fits[2].codebook)
        noise = tq.init_codebook(8, 3, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
        assert noise.codebook.shape == (8, 3)


def test_compress_gaussians_with_jax_draws():
    """400 Gaussians, 64 codes per attribute, the JAX package's per-
    attribute keys (``fold_in(key, i)``) drawn and fed in: codes equal,
    codebooks within 1e-5 of their scale, dequantized rows equal to
    ``codebook[code]``, untouched attributes passed through as given."""
    g = _gaussians(400, seed=2)
    key = jax.random.PRNGKey(0)
    draws = {attr: jax_draws(jax.random.fold_in(key, i), 400, 64, 50)
             for i, attr in enumerate(ATTRS)}
    want = jq.compress_gaussians(key, g, num_codes=64)
    got = tq.compress_gaussians(g, num_codes=64, device="cpu",
                                draws={a: tuple(map(t, d))
                                       for a, d in draws.items()})
    assert set(got["codes"]) == set(ATTRS)
    for attr in ATTRS:
        np.testing.assert_array_equal(got["codes"][attr].numpy(),
                                      np.asarray(want["codes"][attr]))
        cb = np.asarray(want["codebooks"][attr])
        np.testing.assert_allclose(got["codebooks"][attr].numpy(), cb,
                                   atol=1e-5 * np.abs(cb).max(), rtol=0)
        deq = got["dequantized"][attr]
        assert deq.shape == g[attr].shape
        torch.testing.assert_close(
            deq, got["codebooks"][attr][got["codes"][attr]].reshape(deq.shape),
            rtol=0, atol=0)
    for k in ("xyz", "f_dc", "opacity"):
        assert got[k] is g[k]


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


def test_cli_round_trip(tmp_path):
    """PLY → codebook npz → dequantized PLY through the port's CLI on the
    CPU: uint16 codes, exact raw attributes, and a render of the
    dequantized model above 25 dB against the original's."""
    model, g = _model_dir(str(tmp_path / "model"))
    npz = tcli.main(["-m", model, "--num_codes", "64", "--sh_degree", "1",
                     "--device", "cpu"])
    assert npz == os.path.join(model, "point_cloud", "iteration_50",
                               "point_cloud_compressed.npz")
    data = np.load(npz)
    assert data["codes/f_rest"].dtype == np.uint16
    assert data["codebooks/scaling"].shape == (64, 3)
    assert data["shape/f_rest"].dtype == np.int64
    np.testing.assert_array_equal(data["raw/xyz"], g["xyz"])
    dq_path = tcli.main(["-m", model, "--decompress", "--sh_degree", "1"])
    dq = load_gaussian_ply(dq_path, max_sh_degree=1)
    for k in ("xyz", "f_dc", "opacity"):
        np.testing.assert_array_equal(dq[k], g[k])
    for attr in ATTRS:
        np.testing.assert_array_equal(
            dq[attr], data[f"codebooks/{attr}"][data[f"codes/{attr}"]
                                                .astype(np.int64)].reshape(
                g[attr].shape))
    assert np.abs(dq["scaling"] - g["scaling"]).mean() < 0.25
    mse = float(np.mean((_render(g) - _render(dq)) ** 2))
    assert -10 * math.log10(mse + 1e-12) > 25.0


def test_npz_crosses_packages(tmp_path):
    """Each package decompresses the other's ``.npz`` into a PLY
    byte-equal to the one its author writes from the same file."""
    for author, other in ((jcli, tcli), (tcli, jcli)):
        name = "j" if author is jcli else "t"
        model, _ = _model_dir(str(tmp_path / name), seed=1)
        argv = ["-m", model, "--num_codes", "32", "--sh_degree", "1"]
        author.main(argv + (["--device", "cpu"] if author is tcli else []))
        npz = os.path.join(model, "point_cloud", "iteration_50",
                           "point_cloud_compressed.npz")
        own = author.decompress(npz)
        kept = own + ".own"
        os.replace(own, kept)
        cross = other.decompress(npz)
        assert filecmp.cmp(kept, cross, shallow=False), name
