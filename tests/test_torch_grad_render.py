"""The render's gradients held against the JAX package (moved from
``test_torch_grad.py``, whose helpers and bounds it uses)."""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_grad import (jrast, REL, W, H, rel_gap, jax_stream_interpret,
                             random_model, cameras, _jax_render_grads)

from mvs_gaussian_splatting_tpu.models.gaussians import \
    GaussianParams as JParams
from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
    params_from_numpy
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render

torch.set_num_threads(1)


class TestRenderGradients:
    def test_render_grads_match_jax(self, jax_stream_interpret):
        n = 200
        d = random_model(n, seed=11)
        jcam, tcam = cameras()
        rng = np.random.RandomState(12)
        w_img = rng.randn(3, H, W).astype(np.float32)
        w_t = rng.randn(H, W).astype(np.float32)
        bg = np.array([0.1, 0.2, 0.3], np.float32)
        cfg_kw = dict(tile_w=32, tile_h=16, max_tiles_per_gaussian=64,
                      tier_budgets=(4, 12), tier_fracs=(0.25, 0.1))
        gp_j, gndc_j = _jax_render_grads(
            JParams(**{k: jnp.asarray(v) for k, v in d.items()}),
            jnp.zeros((n, 2)), jcam, jnp.asarray(bg), jnp.asarray(w_img),
            jnp.asarray(w_t),
            cfg=jrast.RasterConfig(backend="stream", **cfg_kw))

        tp = params_from_numpy(d, "cpu")
        tp = type(tp)(*[None if a is None else a.requires_grad_()
                        for a in tp])
        ndc = torch.zeros((n, 2), requires_grad=True)
        out = render(tcam, W, H, tp, torch.tensor(bg), sh_degree=3,
                     ndc_offset=ndc, raster_config=RasterConfig(**cfg_kw))
        loss = ((out["render"] * torch.tensor(w_img)).sum()
                + (out["final_T"] * torch.tensor(w_t)).sum())
        loss.backward()
        assert int(out["overflow_tiles"]) == 0
        gaps = {k: rel_gap(getattr(tp, k).grad.numpy(),
                           np.asarray(getattr(gp_j, k))) for k in d}
        gaps["ndc_offset"] = rel_gap(ndc.grad.numpy(), np.asarray(gndc_j))
        print("render grads vs JAX: " + ", ".join(
            f"{k} {v:.1e}" for k, v in gaps.items()))
        assert max(gaps.values()) <= REL
