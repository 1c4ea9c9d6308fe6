"""Both packages' gradients held to a float64 evaluation of the same
operator (moved from ``test_torch_grad_f64.py``; the helpers and bounds
are ``test_torch_grad.py``'s)."""

import pytest
import torch
from test_torch_grad import (F64_REL, _render_f64_gaps, _vjp_f64_gaps,
                             jax_stream_interpret)

torch.set_num_threads(1)


@pytest.mark.parametrize("level", ["vjp", "render"])
def test_both_packages_near_f64(level, jax_stream_interpret):
    """Each package's float32 gradients within F64_REL of the float64
    evaluation; the one-step tests of ``test_torch_train.py`` and
    ``test_torch_grow_step.py`` hold the steps the same way."""
    gaps = _vjp_f64_gaps() if level == "vjp" else _render_f64_gaps()
    print(f"{level} to f64 (JAX / port): " + ", ".join(
        f"{k} {j:.2e} / {t:.2e}" for k, j, t in gaps))
    for k, j, t in gaps:
        assert j <= F64_REL[level] and t <= F64_REL[level], (k, j, t)
