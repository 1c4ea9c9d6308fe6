"""The port's optimizer, model state and densification held against the JAX
package (moved from ``test_torch_train.py``, whose helpers and bounds
they use)."""


import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_train import (FIELDS, to_np, random_state, jax_state,
                              torch_state)

from mvs_gaussian_splatting_tpu.models import densify as jdensify
from mvs_gaussian_splatting_tpu.models import gaussians as jgauss
from mvs_gaussian_splatting_tpu.train import optim as joptim
from mvs_gaussian_splatting_tpu.train.config import OptimizationConfig
from mvs_gaussian_splatting_tpu_torch.models import densify as tdensify
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgauss
from mvs_gaussian_splatting_tpu_torch.train import optim as toptim

torch.set_num_threads(1)


class TestOptim:
    def test_adam_and_scrub_on_identical_grads(self):
        p, mu, nu, aux = random_state(50, 64, seed=1)
        rng = np.random.RandomState(2)
        grads = {k: rng.randn(*v.shape).astype(np.float32) * 1e-3
                 for k, v in p.items()}
        grads["xyz"][3, 1] = np.nan            # two poisoned rows
        grads["opacity"][7, 0] = np.inf
        grads["f_rest"][9] = 1e-30             # tiny of both signs
        grads["f_rest"][9, ::2] *= -1
        opt = OptimizationConfig()
        jp, jadam, jaux = jax_state(p, mu, nu, aux, count=9)
        tp, tadam, taux = torch_state(p, mu, nu, aux, count=9)
        jg, jbad = jax.jit(joptim.scrub_grads)(jgauss.GaussianParams(
            **{k: jnp.asarray(v) for k, v in grads.items()}))
        tg, tbad = toptim.scrub_grads(tgauss.params_from_numpy(grads, "cpu"))
        assert int(jbad) == int(tbad) == 2
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                          np.asarray(getattr(jg, k)))
        jnew, jst = jax.jit(joptim.adam_update)(
            jg, jadam, jp, joptim.group_lrs(opt, 10, 4.2, jp),
            alive=jaux.alive)
        tnew, tst = toptim.adam_update(
            tg, tadam, tp, toptim.group_lrs(opt, 10, 4.2, tp),
            alive=taux.alive)
        assert int(tst.count) == int(jst.count) == 10
        # identical inputs, the same f32 expressions: within 1 ulp-scale
        for k in FIELDS:
            for got, want in ((getattr(tnew, k), getattr(jnew, k)),
                              (getattr(tst.mu, k), getattr(jst.mu, k)),
                              (getattr(tst.nu, k), getattr(jst.nu, k))):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9)
        dead = ~aux["alive"]
        np.testing.assert_array_equal(tnew.xyz.numpy()[dead], p["xyz"][dead])


class TestDensify:
    def test_densify_and_prune_matches_jax(self):
        # too few free slots for every split: some parents are left as
        # they are, and the shortfall is counted
        capacity = 80
        p, mu, nu, aux = random_state(60, capacity, seed=5)
        # a mix of small (clone) and large (split) hot Gaussians
        p["scaling"][::3] = np.log(0.5)
        key = jax.random.PRNGKey(6)
        k1, k2 = jax.random.split(key)
        noise = (np.asarray(jax.random.normal(k1, (capacity, 3))),
                 np.asarray(jax.random.normal(k2, (capacity, 3))))
        cfg_kw = dict(grad_threshold=2e-4, min_opacity=0.005,
                      percent_dense=0.01)
        jp, jadam, jaux = jax_state(p, mu, nu, aux)
        jout = jax.jit(jdensify.densify_and_prune, static_argnums=(6,))(
            jp, jadam.mu, jadam.nu, jaux, key, 10.0,
            jdensify.DensifyConfig(**cfg_kw), True)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        tout = tdensify.densify_and_prune(
            tp, tadam.mu, tadam.nu, taux, None, 10.0,
            tdensify.DensifyConfig(**cfg_kw), True, noise=noise)
        jinfo, tinfo = jout[4], tout[4]
        assert {k: int(v) for k, v in jinfo.items()} == tinfo
        assert tinfo["n_cloned"] > 0 and tinfo["n_split"] > 0
        assert tinfo["n_pruned"] > 0 and tinfo["n_dropped"] > 0
        # the split offsets go through a 3x3 rotation (1e-6 abs)
        for w, g in zip(jout[:4], tout[:4]):
            for k, v in to_np(w).items():
                np.testing.assert_allclose(getattr(g, k).numpy(), v,
                                           rtol=1e-6, atol=1e-6, err_msg=k)

    def test_reset_opacity_and_stats(self):
        p, mu, nu, aux = random_state(30, 48, seed=7)
        jp, jadam, jaux = jax_state(p, mu, nu, aux)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        jr = jdensify.reset_opacity(jp, jadam.mu, jadam.nu)
        tr = tdensify.reset_opacity(tp, tadam.mu, tadam.nu)
        np.testing.assert_allclose(tr[0].opacity.numpy(),
                                   np.asarray(jr[0].opacity), rtol=1e-6)
        assert not tr[1].opacity.any() and not tr[2].opacity.any()
        rng = np.random.RandomState(8)
        radii = rng.randint(0, 20, 48).astype(np.int32)
        g = rng.randn(48, 2).astype(np.float32)
        vis = radii > 0
        ja = jdensify.add_densification_stats(jaux, jnp.asarray(radii),
                                              jnp.asarray(g),
                                              jnp.asarray(vis))
        ta = tdensify.add_densification_stats(taux, torch.tensor(radii),
                                              torch.tensor(g),
                                              torch.tensor(vis))
        for k, v in to_np(ja).items():
            np.testing.assert_allclose(getattr(ta, k).numpy(), v, rtol=1e-6)
        np.testing.assert_allclose(
            tdensify.densification_grads(ta).numpy(),
            np.asarray(jdensify.densification_grads(ja)), rtol=1e-6)

    def test_grow_mode_refused(self):
        """The grow round, once refused, now runs: every hot Gaussian is
        grown into a free slot and its direction logits are reset to
        uniform (tests/test_torch_grow.py holds it against the JAX
        package)."""
        from mvs_gaussian_splatting_tpu_torch.models.grow import GrowConfig
        from mvs_gaussian_splatting_tpu_torch.utils.sphere import \
            sphere_points
        p, mu, nu, aux = random_state(30, 96, seed=13)
        rng = np.random.RandomState(14)
        for tree in (p, mu, nu):
            tree["dirs_prob"] = rng.randn(96, 128).astype(np.float32)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        hot = taux.alive & (tdensify.densification_grads(taux) >= 2e-4)
        out = tdensify.densify_and_prune_grow(
            tp, tadam.mu, tadam.nu, taux, torch.Generator().manual_seed(0),
            10.0, tdensify.DensifyConfig(), GrowConfig(grow_dir=True),
            torch.tensor(sphere_points(128), dtype=torch.float32), True)
        info = out[4]
        assert info["n_cloned"] == int(hot.sum()) > 0
        assert (out[0].dirs_prob[hot] == 1.0 / 128).all()
        assert bool(torch.isfinite(out[0].xyz).all())
