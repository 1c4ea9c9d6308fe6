"""ROADMAP C13, level by level: the port no farther from float64 than the
JAX package (moved from ``test_torch_grad.py``, whose helpers and
bounds they use)."""

import pytest
import torch
from test_torch_grad import (C13_FACTOR, C13_FLOOR, _render_f64_gaps,
                             _vjp_f64_gaps, jax_stream_interpret)

torch.set_num_threads(1)


def check_port_no_farther(level):
    """ROADMAP C13, level by level: the composite's VJP at each tile shape
    (the worst row) and the render (each leaf); the one-step tests of
    ``test_torch_train.py`` and ``test_torch_grow_step.py`` hold the
    vanilla and the grow step the same way."""
    gaps = (_render_f64_gaps() if level == "render"
            else [g for g in _vjp_f64_gaps() if g[0] == level])
    assert gaps
    for k, j, t in gaps:
        assert t <= max(C13_FACTOR * j, C13_FLOOR), (k, j, t)


# the render level runs in test_torch_grad_c13_render.py
@pytest.mark.parametrize("level", ["16x16", "32x16", "24x10", "8x4"])
def test_port_no_farther_from_f64_than_jax(level, jax_stream_interpret):
    check_port_no_farther(level)
