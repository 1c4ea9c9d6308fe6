"""The render at 48×48 tiles (four parts, two cut at the edges) held
against the JAX package's jnp render (moved from ``test_torch_parts.py``,
whose check, modes and bounds it uses)."""

import pytest
import torch
from test_torch_parts import GEOMETRIES, MODES, check_large_tiles

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("geometry", GEOMETRIES[1:])
def test_render_at_large_tiles_matches_jax(geometry, mode):
    check_large_tiles(geometry, mode)
