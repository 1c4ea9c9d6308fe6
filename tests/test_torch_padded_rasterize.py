"""The padded backends' rasterize held against the JAX package's ``jnp``
backend (moved from ``test_torch_padded.py``, whose helpers it
uses)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_padded import (jrast, W, H, TOL, REL, rel_gap, cameras,
                               random_model, _jax_render_grads)

from mvs_gaussian_splatting_tpu.models.gaussians import \
    GaussianParams as JParams
from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
    params_from_numpy
from mvs_gaussian_splatting_tpu_torch.ops import composite as tcomp
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_rasterize_matches_jax_jnp(backend):
    """Image, final_T and every parameter's gradient (and the viewspace
    statistic's) of a render through the port's padded backend against the
    JAX package's ``backend="jnp"``."""
    n = 160
    d = random_model(n, seed=5)
    jcam, tcam = cameras()
    rng = np.random.RandomState(6)
    w_img = rng.randn(3, H, W).astype(np.float32)
    w_t = rng.randn(H, W).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg_kw = dict(max_tiles_per_gaussian=32, tile_capacity=128,
                  tile_batch=8)
    (gp_j, gndc_j), (img_j, tfin_j) = _jax_render_grads(
        JParams(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.zeros((n, 2)), jcam, jnp.asarray(bg), jnp.asarray(w_img),
        jnp.asarray(w_t), cfg=jrast.RasterConfig(backend="jnp", **cfg_kw))

    tp = params_from_numpy(d, "cpu")
    tp = type(tp)(*[None if a is None else a.requires_grad_() for a in tp])
    ndc = torch.zeros((n, 2), requires_grad=True)
    before = (tcomp.launches, tcomp.bwd_launches)
    out = render(tcam, W, H, tp, torch.tensor(bg), sh_degree=3,
                 ndc_offset=ndc,
                 raster_config=RasterConfig(backend=backend, **cfg_kw))
    loss = ((out["render"] * torch.tensor(w_img)).sum()
            + (out["final_T"] * torch.tensor(w_t)).sum())
    loss.backward()
    assert (tcomp.launches, tcomp.bwd_launches) == before
    gap = max(float(np.abs(out["render"].detach().numpy()
                           - np.asarray(img_j)).max()),
              float(np.abs(out["final_T"].detach().numpy()
                           - np.asarray(tfin_j)).max()))
    gaps = {k: rel_gap(getattr(tp, k).grad.numpy(),
                       np.asarray(getattr(gp_j, k))) for k in d}
    gaps["ndc_offset"] = rel_gap(ndc.grad.numpy(), np.asarray(gndc_j))
    print(f"{backend}: image {gap:.1e}; grads " + ", ".join(
        f"{k} {v:.1e}" for k, v in gaps.items()))
    assert gap <= TOL and max(gaps.values()) <= REL
    assert int(out["overflow_capacity"]) == 0
    assert int(out["instance_load"]) > 0
    assert out["tier_need_counts"].numel() == 0
