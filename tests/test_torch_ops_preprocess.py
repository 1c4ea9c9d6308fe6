"""Preprocess held against the JAX package (moved from
``test_torch_ops.py``, whose helpers it uses)."""

import numpy as np
import pytest
import torch
from test_torch_ops import (close, make_scene, run_preprocess)

torch.set_num_threads(1)


class TestPreprocess:
    @pytest.mark.parametrize("seed,mode", [(0, "colors"), (1, "sh"),
                                           (2, "cov3d"), (3, "big")])
    def test_matches_jax(self, seed, mode):
        s = make_scene(n=150, seed=seed, big=(mode == "big"))
        pj, pt = run_preprocess(s, "colors" if mode == "big" else mode)
        for name in ("radius", "mask", "rect_min", "rect_max"):
            np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                          np.asarray(getattr(pj, name)),
                                          err_msg=name)
        vis = np.asarray(pj.mask)
        assert vis.sum() > 10
        for name in ("xy", "depth", "conic", "rgb", "opacity", "cull_r2"):
            a = getattr(pt, name).numpy()[vis]
            b = np.asarray(getattr(pj, name))[vis]
            scale = float(np.abs(b).max())
            close(a, b, atol=1e-5 * scale, msg=name)
