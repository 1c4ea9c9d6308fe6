"""ROADMAP C13 at the render level: each leaf's gradient no farther from
float64 than the JAX package's (moved from ``test_torch_grad_c13.py``,
whose check it uses)."""

import pytest
import torch
from test_torch_grad import jax_stream_interpret
from test_torch_grad_c13 import check_port_no_farther

torch.set_num_threads(1)


@pytest.mark.parametrize("level", ["render"])
def test_port_no_farther_from_f64_than_jax(level, jax_stream_interpret):
    check_port_no_farther(level)
