"""Grow mode's densification rounds held against the JAX package (moved
from ``test_torch_grow.py``, whose helpers and draws they use)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grow import (DIRS, grow_state, jax_state, torch_state,
                             configs, _assert_state)

from mvs_gaussian_splatting_tpu.models import grow as jgrow
from mvs_gaussian_splatting_tpu_torch.models import grow as tgrow

torch.set_num_threads(1)


@pytest.mark.parametrize("flags", [
    {"grow_dir": True, "grow_distance": True},
    {"continous_dir": True},
    {"continous_dir": True, "prob_notreinit": True},
], ids=["discrete", "continuous", "continuous_notreinit"])
def test_densify_grow(flags):
    capacity = 80
    p, mu, nu, aux = grow_state(60, capacity, seed=6, flags=flags)
    jcfg, tcfg = configs(flags)
    key = jax.random.PRNGKey(7)
    fresh = np.asarray(jax.random.normal(key, (capacity, 3)))
    jp, jadam, jaux = jax_state(p, mu, nu, aux)
    jout = jax.jit(jgrow.densify_grow, static_argnums=(6, 7))(
        jp, jadam.mu, jadam.nu, jaux, jnp.asarray(DIRS), key, jcfg, 2e-4)
    tp, tadam, taux = torch_state(p, mu, nu, aux)
    tout = tgrow.densify_grow(tp, tadam.mu, tadam.nu, taux,
                              torch.tensor(DIRS), tcfg, 2e-4, fresh=fresh)
    # more hot rows than free slots: the shortfall is counted
    assert tout[4]["n_grown"] == 20 and tout[4]["n_dropped"] > 0
    _assert_state(jout, tout)
