"""The per-pixel oracle held against the JAX package's and the stream
(moved from ``test_torch_render.py``, whose helpers it uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_render import (W, H, TOL, random_model, cameras)

from mvs_gaussian_splatting_tpu.ops.raster_ref import \
    rasterize_reference as jref
from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
    activated, params_from_numpy)
from mvs_gaussian_splatting_tpu_torch.ops import rasterize as trast
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import (Processed,
                                                             preprocess)
from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
    rasterize_reference

torch.set_num_threads(1)


class TestOracle:
    def test_reference_matches_jax_and_stream(self):
        d = random_model(120, seed=4)
        jcam, tcam = cameras()
        tp = params_from_numpy(d, "cpu")
        s, r, o = activated(tp)
        col = np.random.RandomState(4).rand(120, 3).astype(np.float32)
        with torch.no_grad():
            p = preprocess(tp.xyz, o, tcam, W, H, scales=s, rotations=r,
                           colors_precomp=torch.tensor(col))
            bg = torch.tensor([0.2, 0.4, 0.6])
            img, aux = rasterize_reference(p, W, H, bg, return_aux=True)
            tiled, taux = trast.rasterize(p, W, H, bg, trast.RasterConfig(
                max_tiles_per_gaussian=64))
        pj = type(p)._make(jnp.asarray(v.numpy()) for v in p)
        from mvs_gaussian_splatting_tpu.ops.preprocess import \
            Processed as JProcessed
        img_j = jax.jit(jref, static_argnums=(1, 2))(
            JProcessed(*pj), W, H, jnp.asarray(bg.numpy()))
        np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=TOL)
        np.testing.assert_allclose(tiled.numpy(), img.numpy(), atol=TOL)
        np.testing.assert_allclose(taux["final_T"].numpy(),
                                   aux["final_T"].numpy(), atol=TOL)
        assert isinstance(p, Processed)
