"""Grow mode's speculative set and the CLI's grow flags held against the
JAX package (moved from ``test_torch_grow.py``, whose helpers and
draws they use)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grow import (DIRS, REL, rel_gap, grow_state, configs,
                             AUGMENT_MODES)

from mvs_gaussian_splatting_tpu.models import gaussians as jgauss
from mvs_gaussian_splatting_tpu.models import grow as jgrow
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgauss
from mvs_gaussian_splatting_tpu_torch.models import grow as tgrow

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", list(AUGMENT_MODES))
def test_speculative_augment(mode):
    flags = AUGMENT_MODES[mode]
    capacity, spec = 96, 16
    p, _, _, aux = grow_state(70, capacity, seed=3, flags=flags)
    jcfg, tcfg = configs(flags)
    n_aug = capacity + spec
    key = jax.random.PRNGKey(4)
    noise = np.array(jax.random.normal(key, (n_aug, 3)))
    grads = (aux["xyz_grad_accum"] / aux["denom"]).astype(np.float32)
    thr, extent, pdense = 2e-4, 3.0, 0.01
    names = ("xyz", "scaling", "rotation", "f_dc", "f_rest", "opacity")
    w = {k: np.random.RandomState(5).randn(
        n_aug + spec, *p[k].shape[1:]).astype(np.float32) for k in names}
    jaux = jgauss.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})

    def jloss(params):
        out = jgrow.speculative_augment(
            params, jaux, jnp.asarray(grads), jnp.asarray(DIRS), jcfg, thr,
            extent, pdense, spec, key)
        return sum((out[k] * w[k]).sum() for k in names), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()}))
    tp = tgauss.GaussianParams(**{k: torch.tensor(v, requires_grad=True)
                                  for k, v in p.items()})
    tout = tgrow.speculative_augment(
        tp, tgauss.aux_from_numpy(aux, "cpu"), torch.tensor(grads),
        torch.tensor(DIRS), tcfg, thr, extent, pdense, spec, noise=noise)
    sum((tout[k] * torch.tensor(w[k])).sum() for k in names).backward()
    # indices and masks equal
    for k in ("grow_idx", "grow_ok", "alive"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    assert int(tout["grow_ok"].sum()) == (
        spec if ("grow_dir" in flags or "continous_dir" in flags) else 0)
    assert int(tout["alive"][n_aug:].sum()) == (
        spec if ("learn_split_distance" in flags
                 or "learn_split_scale" in flags) else 0)
    # the rows: within 1e-6 of each output's scale
    for k in names:
        assert tout[k].shape == jout[k].shape, k
        assert rel_gap(tout[k].detach().numpy(), jout[k]) <= REL, k
    # gradients through the gathers (repeated, clipped indices) and the
    # in-place split, summed in other orders: 1e-6 of each leaf's scale
    for k in p:
        want = np.asarray(getattr(jg, k))
        got = getattr(tp, k).grad
        got = np.zeros_like(want) if got is None else got.numpy()
        assert rel_gap(got, want) <= REL, k
    for k in ("dirs_prob", "conti_dirs", "grow_dist", "split_distance",
              "split_scale"):
        if k in p:
            assert np.abs(getattr(tp, k).grad.numpy()).max() > 0, k
