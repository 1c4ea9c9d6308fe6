"""The fast-math autograd routing and render held against the JAX
package (moved from ``test_torch_fast.py``, whose helpers and bounds
they use)."""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_grad import cameras, random_model
from test_torch_train import H, W, rel_gap
from test_torch_fast import (jrast, TOL, REL, NAMES, jax_stream_interpret,
                             _stream, _cotangents, _jax_render_grads)

from mvs_gaussian_splatting_tpu.models.gaussians import \
    GaussianParams as JParams
from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
    params_from_numpy
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render

torch.set_num_threads(1)


class TestStreamFast:
    def test_autograd_routes_fast_to_fast_plain(self, monkeypatch):
        s = _stream((32, 16))
        g_out, g_tfin = (torch.from_numpy(c) for c in _cotangents(s))
        args = [torch.from_numpy(s[k]) for k in NAMES] + [s["tiles_x"], 32,
                                                          16]

        def refuse(*a, **k):
            raise AssertionError("fast mode reached an exact plain version")

        monkeypatch.setattr(tstream, "composite_stream_plain", refuse)
        monkeypatch.setattr(tstream, "composite_stream_bwd_plain", refuse)
        attrs = args[0].clone().requires_grad_()
        out, tfin = tstream.composite_stream(attrs, *args[1:], fast=True)
        torch.autograd.backward((out, tfin), (g_out, g_tfin))
        want, _ = tstream.composite_stream_bwd_fast_plain(
            *args, out.detach(), tfin.detach(), g_out, g_tfin)
        torch.testing.assert_close(attrs.grad, want, rtol=0, atol=0)


def test_render_fast_matches_jax(jax_stream_interpret):
    """The image and every parameter's gradient (and the viewspace
    statistic's) of ``render`` with ``fast_math=True`` against the JAX
    package's fast stream path, at its ``tests/test_fast_math.py`` scene
    size (150 Gaussians, 64×48)."""
    n = 150
    d = random_model(n, seed=13)
    jcam, tcam = cameras()
    rng = np.random.RandomState(14)
    w_img = rng.randn(3, H, W).astype(np.float32)
    w_t = rng.randn(H, W).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg_kw = dict(instance_cap=1 << 14, fast_math=True)
    (gp_j, gndc_j), (img_j, tfin_j) = _jax_render_grads(
        JParams(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.zeros((n, 2)), jcam, jnp.asarray(bg), jnp.asarray(w_img),
        jnp.asarray(w_t), cfg=jrast.RasterConfig(backend="stream", **cfg_kw))

    tp = params_from_numpy(d, "cpu")
    tp = type(tp)(*[None if a is None else a.requires_grad_() for a in tp])
    ndc = torch.zeros((n, 2), requires_grad=True)
    out = render(tcam, W, H, tp, torch.tensor(bg), sh_degree=3,
                 ndc_offset=ndc, raster_config=RasterConfig(**cfg_kw))
    loss = ((out["render"] * torch.tensor(w_img)).sum()
            + (out["final_T"] * torch.tensor(w_t)).sum())
    loss.backward()
    gap = max(float(np.abs(out["render"].detach().numpy()
                           - np.asarray(img_j)).max()),
              float(np.abs(out["final_T"].detach().numpy()
                           - np.asarray(tfin_j)).max()))
    gaps = {k: rel_gap(getattr(tp, k).grad.numpy(),
                       np.asarray(getattr(gp_j, k))) for k in d}
    gaps["ndc_offset"] = rel_gap(ndc.grad.numpy(), np.asarray(gndc_j))
    print(f"fast render vs JAX: image {gap:.1e}; grads " + ", ".join(
        f"{k} {v:.1e}" for k, v in gaps.items()))
    assert gap <= TOL and max(gaps.values()) <= REL
