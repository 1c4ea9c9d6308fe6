"""The model state's initialisation, padding and compaction held against
the JAX package (moved from ``test_torch_train_state.py``)."""

import functools

import jax
import numpy as np
import torch
from test_torch_train import (FIELDS, to_np, random_state, jax_state,
                              torch_state)

from mvs_gaussian_splatting_tpu.models import gaussians as jgauss
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgauss

torch.set_num_threads(1)


class TestModelState:
    def test_init_from_pcd_and_knn(self):
        rng = np.random.RandomState(3)
        pts = rng.randn(100, 3).astype(np.float32)
        cols = rng.rand(100, 3).astype(np.float32)
        jp, jaux = jax.jit(functools.partial(jgauss.init_from_pcd,
                                             capacity=128))(pts, cols)
        tp, taux = tgauss.init_from_pcd(pts, cols, 128, sh_degree=3,
                                        device="cpu")
        # knn: the same expanded-form distances, f32 (1e-5 relative)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(tp, k).numpy(),
                                       np.asarray(getattr(jp, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(taux.alive.numpy(),
                                      np.asarray(jaux.alive))
        assert int(tgauss.num_alive(taux)) == 100

    def test_pad_and_compact_state(self):
        p, mu, nu, aux = random_state(40, 64, seed=4)
        jp, jadam, jaux = jax_state(p, mu, nu, aux)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        jp2, jaux2 = jgauss.pad_capacity(jp, jaux, 128)
        tp2, taux2 = tgauss.pad_capacity(tp, taux, 128)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(tp2, k).numpy(),
                                          np.asarray(getattr(jp2, k)))
        pad = {k: np.concatenate([v, np.zeros_like(v)]) for k, v in
               list(mu.items())}
        _, jadam2, _ = jax_state(p, pad, pad, aux)
        _, tadam2, _ = torch_state(p, pad, pad, aux)
        want = jax.jit(jgauss.compact_state)(jp2, jadam2.mu, jadam2.nu, jaux2)
        got = tgauss.compact_state(tp2, tadam2.mu, tadam2.nu, taux2)
        for w, g in zip(want, got):
            for k, v in to_np(w).items():
                np.testing.assert_array_equal(getattr(g, k).numpy(), v,
                                              err_msg=k)
        assert got[3].alive[:40].all() and not got[3].alive[40:].any()
        exported = tgauss.compact(tp, taux)
        np.testing.assert_array_equal(exported["xyz"],
                                      p["xyz"][aux["alive"]])
