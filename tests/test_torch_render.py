"""The port's composite, oracle and whole render path held against the JAX
package.

Inputs are made from a seed with numpy and handed to both packages as numpy
arrays. The JAX package's stream path runs its Pallas kernel in interpret
mode, as its own tests do; the port runs on the CPU, where
``composite_stream`` takes its plain version. Images and final_T agree
within 2e-4 max abs (the bound the JAX kernels were held to against CPU
f32, BASELINE.md); counters, radii and visibility are equal.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models.gaussians import \
    GaussianParams as JParams
from mvs_gaussian_splatting_tpu.ops.pallas.stream import \
    composite_stream as jcomposite
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView as JCamera
from mvs_gaussian_splatting_tpu.ops.raster_ref import \
    rasterize_reference as jref
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu_torch.models.gaussians import (
    activated, params_from_numpy)
from mvs_gaussian_splatting_tpu_torch.ops import rasterize as trast
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import (CameraView,
                                                             Processed,
                                                             preprocess)
from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
    rasterize_reference
from mvs_gaussian_splatting_tpu_torch.ops.render import render

torch.set_num_threads(1)

# the JAX package's ops/__init__ re-exports functions under module names
jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

W, H = 64, 48
TOL = 2e-4


def random_model(n, seed):
    """Raw (unactivated) SH-degree-3 Gaussians in front of the camera."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(2, 6, n)
    f = np.float32
    return {
        "xyz": np.stack([rng.uniform(-0.8, 0.8, n) * z,
                         rng.uniform(-0.6, 0.6, n) * z, z], -1).astype(f),
        "f_dc": ((rng.uniform(0, 1, (n, 1, 3)) - 0.5) / 0.28209479).astype(f),
        "f_rest": (rng.randn(n, 15, 3) * 0.2).astype(f),
        "scaling": np.log(rng.uniform(0.04, 0.3, (n, 3))).astype(f),
        "rotation": rng.randn(n, 4).astype(f),
        "opacity": rng.uniform(-2.0, 3.0, (n, 1)).astype(f),
    }


def cameras(fov_deg=60.0):
    fovx = math.radians(fov_deg)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    # a slight turn and offset so the view matrix is not the identity
    a = 0.1
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                 [-math.sin(a), 0, math.cos(a)]]
    V[:3, 3] = [0.1, -0.05, 0.2]
    full = (P @ V).astype(np.float32)
    center = np.linalg.inv(V)[:3, 3].astype(np.float32)
    tan = (np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))
    jcam = JCamera(jnp.asarray(V), jnp.asarray(full), jnp.asarray(center),
                   *tan)
    tcam = CameraView(torch.tensor(V), torch.tensor(full),
                      torch.tensor(center), *(torch.tensor(v) for v in tan))
    return jcam, tcam


@pytest.fixture
def jax_stream_interpret(monkeypatch):
    """The JAX package's rasterize() taking its stream path through the
    Pallas kernel in interpret mode (the CPU has no TPU to lower it for)."""
    monkeypatch.setattr(jrast, "_rasterize_stream", functools.partial(
        jrast._rasterize_stream, interpret=True))


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_pack(jp, jcam, colors, cfg):
    from mvs_gaussian_splatting_tpu.models.gaussians import activated as jact
    from mvs_gaussian_splatting_tpu.ops.preprocess import preprocess as jpre
    s, r, o = jact(jp)
    p = jpre(jp.xyz, o, jcam, W, H, scales=s, rotations=r,
             colors_precomp=colors)
    return jrast.bin_and_pack_stream(p, 4, 3, cfg)


def _stream_inputs(seed, n=250):
    """One packed stream, built by the JAX package from a random scene."""
    d = random_model(n, seed)
    jcam, _ = cameras()
    jp = JParams(**{k: jnp.asarray(v) for k, v in d.items()})
    colors = np.random.RandomState(seed).rand(n, 3).astype(np.float32)
    bins, attrs = _jax_pack(jp, jcam, jnp.asarray(colors),
                            jrast.RasterConfig(backend="stream"))
    return {"attrs": np.asarray(attrs), "seg_start": np.asarray(bins.seg_start),
            "counts": np.asarray(bins.counts),
            "tile_ids": np.arange(12, dtype=np.int32),
            "bg": np.array([0.3, 0.1, 0.7], np.float32)}


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


def _render_both(case, jax_stream_interpret):
    n = 300
    d = random_model(n, seed=case["seed"])
    jcam, tcam = cameras()
    jp = JParams(**{k: jnp.asarray(v) for k, v in d.items()})
    tp = params_from_numpy(d, "cpu")
    bg = np.array(case.get("bg", [0.1, 0.2, 0.3]), np.float32)
    kw_j = dict(case.get("kw", {}))
    kw_t = dict(kw_j)
    if "alive" in case:
        alive = np.random.RandomState(9).rand(n) > case["alive"]
        kw_j["alive"], kw_t["alive"] = jnp.asarray(alive), torch.tensor(alive)
    if case.get("override"):
        col = np.random.RandomState(8).rand(n, 3).astype(np.float32)
        kw_j["override_color"] = jnp.asarray(col)
        kw_t["override_color"] = torch.tensor(col)
    cfg_kw = case.get("cfg", {})
    # jitted whole: eager JAX runs the interpreted kernel op by op
    jrender = jax.jit(jrender_mod.render, static_argnums=(1, 2),
                      static_argnames=("sh_degree", "raster_config",
                                       "scale_modifier",
                                       "compute_cov3d_python",
                                       "convert_shs_python"))
    out_j = jrender(
        jcam, W, H, jp, jnp.asarray(bg), sh_degree=3,
        raster_config=jrast.RasterConfig(backend="stream", **cfg_kw), **kw_j)
    with torch.no_grad():
        out_t = render(tcam, W, H, tp, torch.tensor(bg), sh_degree=3,
                       raster_config=trast.RasterConfig(**cfg_kw), **kw_t)
    return out_j, out_t


RENDER_CASES = {
    "default": dict(seed=0),
    "eval_flags": dict(seed=1, alive=0.15,
                       kw=dict(compute_cov3d_python=True,
                               convert_shs_python=True, scale_modifier=0.9),
                       cfg=dict(max_tiles_per_gaussian=512,
                                tier_budgets=(4, 12, 64),
                                tier_fracs=(0.25, 0.1, 0.01))),
    "visible_cap": dict(seed=2, override=True, bg=[1.0, 1.0, 1.0],
                        cfg=dict(visible_cap=160, instance_cap=256)),
}


class TestRenderSlice:
    @pytest.mark.parametrize("case", sorted(RENDER_CASES))
    def test_render_matches_jax(self, case, jax_stream_interpret):
        out_j, out_t = _render_both(RENDER_CASES[case], jax_stream_interpret)
        assert out_t["render"].shape == (3, H, W)
        gap = float(np.abs(out_t["render"].numpy()
                           - np.asarray(out_j["render"])).max())
        gap_t = float(np.abs(out_t["final_T"].numpy()
                             - np.asarray(out_j["final_T"])).max())
        print(f"{case}: render vs JAX {gap:.3e}, final_T {gap_t:.3e}")
        assert gap <= TOL and gap_t <= TOL
        for k in ("radii", "visibility_filter", "overflow_tiles",
                  "overflow_capacity", "overflow_visible", "instance_load",
                  "n_mask_visible", "tier_need_counts"):
            np.testing.assert_array_equal(np.asarray(out_t[k]),
                                          np.asarray(out_j[k]), err_msg=k)
        assert int(out_t["instance_load"]) > 0
        if case == "visible_cap":
            assert int(out_t["overflow_visible"]) > 0
            assert int(out_t["overflow_capacity"]) > 0

    def test_unported_backends_refused(self):
        d = random_model(20, seed=3)
        _, tcam = cameras()
        tp = params_from_numpy(d, "cpu")
        for cfg in (trast.RasterConfig(backend="jnp"),
                    trast.RasterConfig(fast_math=True)):
            with pytest.raises(ValueError, match="not ported"):
                render(tcam, W, H, tp, torch.zeros(3), sh_degree=3,
                       raster_config=cfg)


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
