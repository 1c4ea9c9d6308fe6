"""Compression with the JAX draws, the CLI, and files crossing packages
(moved from ``test_torch_compress.py``, whose helpers they use)."""


import jax
import numpy as np
import torch
from test_torch_compress import ATTRS, t, clustered_data, jax_draws, _gaussians

from mvs_gaussian_splatting_tpu.models import quantize as jq
from mvs_gaussian_splatting_tpu_torch.models import quantize as tq

torch.set_num_threads(1)


class TestQuantizers:
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
