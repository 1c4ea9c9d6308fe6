"""Codebook fitting with the JAX draws (moved from
``test_torch_compress.py``, whose helpers it uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compress import (t, clustered_data, jax_draws, _jfit)

from mvs_gaussian_splatting_tpu.models import quantize as jq
from mvs_gaussian_splatting_tpu_torch.models import quantize as tq

torch.set_num_threads(1)


class TestQuantizers:
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
