"""The plain composite held against the JAX kernel (moved from
``test_torch_render.py``, whose helpers it uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import (TOL, _stream_inputs)

from mvs_gaussian_splatting_tpu.ops.pallas.stream import \
    composite_stream as jcomposite
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream

torch.set_num_threads(1)


class TestCompositePlain:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_plain_matches_jax_kernel(self, seed):
        s = _stream_inputs(seed)
        out_j, tfin_j = jax.jit(jcomposite, static_argnums=(5, 6, 7, 8))(
            *(jnp.asarray(s[k]) for k in ("attrs", "seg_start", "counts",
                                          "bg", "tile_ids")),
            4, 16, 16, True)
        out_t, tfin_t = tstream.composite_stream_plain(
            *(torch.tensor(s[k]) for k in ("attrs", "seg_start", "counts",
                                           "bg", "tile_ids")), 4, 16, 16)
        gap_out = float(np.abs(out_t.numpy() - np.asarray(out_j)).max())
        gap_t = float(np.abs(tfin_t.numpy() - np.asarray(tfin_j)).max())
        print(f"plain vs JAX kernel (interpret): out {gap_out:.3e}, "
              f"final_T {gap_t:.3e}")
        assert gap_out <= TOL and gap_t <= TOL
        assert int(s["counts"].sum()) > 100
