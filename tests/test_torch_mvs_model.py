"""The MVS model's forward and gradients, and the synthetic groups, held
against the JAX package (moved from ``test_torch_mvs.py``, whose
helpers they use)."""

import jax
import numpy as np
import pytest
import torch
from test_torch_mvs import (REL, GRAD_REL, IMG_TOL, rel_gap, t, model_inputs,
                            flax_weights, OUT_KEYS, cotangents)

from mvs_gaussian_splatting_tpu.mvs import dataset as jdata
from mvs_gaussian_splatting_tpu.mvs.model import MVSGaussianModel as JModel
from mvs_gaussian_splatting_tpu_torch.mvs import dataset as tdata
from mvs_gaussian_splatting_tpu_torch.mvs.model import (MVSGaussianModel,
                                                        params_from_flax)

torch.set_num_threads(1)


class TestModel:
    def test_forward_and_grads_match_jax(self):
        inputs = model_inputs()
        jm = JModel(num_depths=8)
        variables = flax_weights(jm, inputs)

        @jax.jit
        def jax_fwd_grad(vs, cts):
            def loss(v):
                o = jm.apply(v, *inputs)
                return sum((o[k] * cts[k]).sum() for k in OUT_KEYS), o
            return jax.grad(loss, has_aux=True)(vs)

        cts = cotangents(jax.eval_shape(lambda v: jm.apply(v, *inputs),
                                        variables))
        jgrads, jout = jax_fwd_grad(variables, cts)

        tm = MVSGaussianModel(num_depths=8)
        tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                         variables)))
        tout = tm(*(t(a) for a in inputs))
        for k in OUT_KEYS:
            assert tout[k].shape == np.shape(jout[k]), k
            assert rel_gap(tout[k].detach().numpy(), jout[k]) <= REL, k
        d = tout["depth"].detach().numpy()
        assert (d >= 1.0).all() and (d <= 5.0).all()
        sum((tout[k] * t(cts[k])).sum() for k in OUT_KEYS).backward()
        want = params_from_flax(jax.tree.map(np.asarray, jgrads))
        gaps = {}
        for name, p in tm.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all())
            gaps[name] = rel_gap(p.grad.numpy(), want[name].numpy())
        print("model grads vs JAX: " + ", ".join(f"{k} {v:.1e}"
                                                 for k, v in gaps.items()))
        assert max(gaps.values()) <= GRAD_REL, gaps

    def test_own_init_is_flax_lecun_normal(self):
        m = MVSGaussianModel(num_depths=8, feat_dims=(8, 16, 16), seed=1)
        w = m.reg.up1.conv.weight                       # [in, out, 3, 3, 3]
        std = float(w.detach().std())
        assert abs(std - (1.0 / (w.shape[0] * 27)) ** 0.5) < 0.1 * std
        assert all(float(mod.bias.abs().max()) == 0.0
                   for mod in m.modules() if hasattr(mod, "bias")
                   and isinstance(mod.bias, torch.Tensor))
        again = MVSGaussianModel(num_depths=8, feat_dims=(8, 16, 16), seed=1)
        assert all(torch.equal(a, b) for a, b in
                   zip(m.state_dict().values(), again.state_dict().values()))


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_synthetic_groups_match_jax(backend):
    """One seed, one scene in both packages: the port's groups (through
    its own rasterize; "auto" is the stream backend, B1's plain version
    here) against the JAX package's (its "jnp" compositor)."""
    kw = dict(n_groups=2, width=48, height=32, n_gauss=60, seed=0)
    want = jdata.make_synthetic_groups(**kw, backend="jnp")
    got = tdata.make_synthetic_groups(**kw, backend=backend, device="cpu")
    assert len(got) == 2
    for g, w in zip(got, want):
        assert len(g.srcs) == 2
        for a, b in zip([g.ref, *g.srcs, g.target],
                        [w.ref, *w.srcs, w.target]):
            assert a.image.shape == (3, 32, 48) and a.image.dtype == np.float32
            assert np.abs(a.image - b.image).max() <= IMG_TOL
            covered = (a.depth > 0) & (b.depth > 0)
            assert covered.mean() > 0.2
            # depth = colour sum / coverage: the image's tolerance over α
            assert np.abs(a.depth - b.depth)[covered].max() <= 1e-2
            np.testing.assert_array_equal(a.w2c, b.w2c)
            np.testing.assert_array_equal(a.K, b.K)
    # real parallax between the views of one group
    d = np.abs(got[0].ref.image - got[0].srcs[0].image).mean()
    assert 1e-3 < d < 0.5
