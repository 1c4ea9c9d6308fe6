"""Grow mode's densify-and-prune rounds held against the JAX package
(moved from ``test_torch_grow_densify.py``, whose helpers they
use)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grow import (DIRS, grow_state, jax_state, torch_state, configs,
                             _assert_state, GROW_ROUNDS)

from mvs_gaussian_splatting_tpu.models import densify as jdensify
from mvs_gaussian_splatting_tpu_torch.models import densify as tdensify

torch.set_num_threads(1)


# grow_dir with grow_distance and learn_split_distance, the deterministic
# round, is held in tests/test_torch_grow_loop.py
@pytest.mark.parametrize("mode", list(GROW_ROUNDS))
def test_densify_and_prune_grow(mode):
    flags = GROW_ROUNDS[mode]
    capacity = 128
    p, mu, nu, aux = grow_state(70, capacity, seed=8, flags=flags)
    p["scaling"][::2] = np.log(0.5)         # large: split candidates
    jcfg, tcfg = configs(flags)
    key = jax.random.PRNGKey(9)
    _, k_reinit, k_split = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_split)
    noise = (np.asarray(jax.random.normal(k1, (capacity, 3))),
             np.asarray(jax.random.normal(k2, (capacity, 3))))
    fresh = np.asarray(jax.random.normal(k_reinit, (capacity, 3)))
    cfg_kw = dict(grad_threshold=2e-4, min_opacity=0.005, percent_dense=0.01,
                  symmetric_split=flags.get("symmetric_split", False))
    jp, jadam, jaux = jax_state(p, mu, nu, aux)
    jout = jax.jit(jdensify.densify_and_prune_grow,
                   static_argnums=(5, 6, 7))(
        jp, jadam.mu, jadam.nu, jaux, key, 10.0,
        jdensify.DensifyConfig(**cfg_kw), jcfg, jnp.asarray(DIRS),
        jnp.asarray(True))
    tp, tadam, taux = torch_state(p, mu, nu, aux)
    tout = tdensify.densify_and_prune_grow(
        tp, tadam.mu, tadam.nu, taux, None, 10.0,
        tdensify.DensifyConfig(**cfg_kw), tcfg, torch.tensor(DIRS), True,
        noise=noise, fresh=fresh)
    info = tout[4]
    assert info["n_cloned"] > 0 and info["n_split"] > 0
    assert info["n_pruned"] > 0 and info["n_dropped"] > 0
    _assert_state(jout, tout)
