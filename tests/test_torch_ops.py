"""The port's math, preprocess and binning held against the JAX package.

Inputs are made from a seed with numpy and handed to both packages as numpy
arrays; JAX runs on the CPU (tests/conftest.py), the port on the CPU.
Tolerances: the small operations within 1e-6 absolute; preprocess floats
within 1e-5 relative to each output's scale (float32 sums taken in another
order), its integer outputs exact; binning integer-exact.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models import gaussians as jgs
from mvs_gaussian_splatting_tpu.ops import binning as jbin
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu.utils import sh as jsh
from mvs_gaussian_splatting_tpu.utils import transforms as jtr
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgs
from mvs_gaussian_splatting_tpu_torch.ops import binning as tbin
from mvs_gaussian_splatting_tpu_torch.ops import preprocess as tpre
from mvs_gaussian_splatting_tpu_torch.utils import sh as tsh
from mvs_gaussian_splatting_tpu_torch.utils import transforms as ttr

torch.set_num_threads(1)

# the JAX package's ops/__init__ re-exports the function under this name
jpre = importlib.import_module("mvs_gaussian_splatting_tpu.ops.preprocess")

W, H = 64, 48
TILES_X, TILES_Y = W // 16, H // 16


def t(a):
    return torch.tensor(np.asarray(a))


def close(port, ref, atol=1e-6, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


class TestSmallOps:
    def setup_method(self):
        rng = np.random.RandomState(0)
        self.q = rng.randn(50, 4).astype(np.float32)
        self.s = rng.uniform(0.01, 2.0, (50, 3)).astype(np.float32)
        self.x = rng.uniform(0.01, 0.99, 50).astype(np.float32)

    def test_transforms(self):
        q, s = self.q, self.s
        close(ttr.quat_to_rotmat(t(q)), jtr.quat_to_rotmat(q))
        close(ttr.build_scaling_rotation(t(s), t(q)),
              jtr.build_scaling_rotation(s, q))
        cov_t = ttr.covariance_from_scaling_rotation(t(s), t(q), 0.7)
        cov_j = jtr.covariance_from_scaling_rotation(s, q, 0.7)
        close(cov_t, cov_j)
        close(ttr.strip_symmetric(cov_t), jtr.strip_symmetric(cov_j))
        close(ttr.unstrip_symmetric(ttr.strip_symmetric(cov_t)), cov_j)
        close(ttr.inverse_sigmoid(t(self.x)), jtr.inverse_sigmoid(self.x),
              atol=1e-5)
        close(ttr.normalize(t(q)), jtr.normalize(q))

    @pytest.mark.parametrize("deg", [0, 1, 2, 3])
    def test_sh(self, deg):
        rng = np.random.RandomState(deg)
        d = rng.randn(40, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        sh = (rng.randn(40, 16, 3) * 0.5).astype(np.float32)
        close(tsh.sh_basis(deg, t(d)), jsh.sh_basis(deg, d))
        close(tsh.eval_sh(deg, t(sh), t(d)), jsh.eval_sh(deg, sh, d))
        rgb_t, cl_t = tsh.sh_to_rgb_clamped(deg, t(sh), t(d))
        rgb_j, cl_j = jsh.sh_to_rgb_clamped(deg, sh, d)
        close(rgb_t, rgb_j)
        np.testing.assert_array_equal(cl_t.numpy(), np.asarray(cl_j))
        close(tsh.sh2rgb(t(sh)), jsh.sh2rgb(sh))
        close(tsh.rgb2sh(t(self.x)), jsh.rgb2sh(self.x), atol=1e-5)

    def test_activated_and_params_from_numpy(self):
        rng = np.random.RandomState(3)
        n = 30
        jp = jgs.GaussianParams(
            xyz=jnp.asarray(rng.randn(n, 3).astype(np.float32)),
            f_dc=jnp.asarray(rng.randn(n, 1, 3).astype(np.float32)),
            f_rest=jnp.asarray(rng.randn(n, 15, 3).astype(np.float32)),
            scaling=jnp.asarray(rng.randn(n, 3).astype(np.float32)),
            rotation=jnp.asarray(rng.randn(n, 4).astype(np.float32)),
            opacity=jnp.asarray(rng.randn(n, 1).astype(np.float32)))
        tp = tgs.params_from_numpy(
            {k: np.asarray(v) for k, v in jp._asdict().items()
             if v is not None}, "cpu")
        assert tp.dirs_prob is None and tp.xyz.dtype == torch.float32
        for a, b in zip(tgs.activated(tp), jgs.activated(jp)):
            close(a, b)
        close(tgs.get_features(tp), jgs.get_features(jp))
        with pytest.raises(ValueError, match="unknown"):
            tgs.params_from_numpy({"xyzw": np.zeros(3)}, "cpu")


def camera(fov_deg=60.0):
    fovx = math.radians(fov_deg)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    tan = (np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))
    jcam = jpre.CameraView(jnp.eye(4), jnp.asarray(P), jnp.zeros(3), *tan)
    tcam = tpre.CameraView(torch.eye(4), t(P), torch.zeros(3),
                           *(torch.tensor(v) for v in tan))
    return jcam, tcam


def make_scene(n=100, seed=0, big=False):
    """tests/test_stream.py:make_inputs, plus its _big_scene variant."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(2, 6, n)
    if big:
        means = np.stack([rng.uniform(-0.5, 0.5, n) * z,
                          rng.uniform(-0.4, 0.4, n) * z, z], -1)
        scales = rng.uniform(0.5, 1.5, (n, 3))
        opac = rng.uniform(0.3, 0.9, n)
        quats = rng.randn(n, 4)
        colors = rng.rand(n, 3)
    else:
        means = np.stack([rng.uniform(-0.8, 0.8, n) * z,
                          rng.uniform(-0.6, 0.6, n) * z, z], -1)
        scales = rng.uniform(0.05, 0.3, (n, 3))
        quats = rng.randn(n, 4)
        opac = rng.uniform(0.3, 0.97, n)
        colors = rng.uniform(0, 1, (n, 3))
    f = np.float32
    return dict(means=means.astype(f), scales=scales.astype(f),
                quats=quats.astype(f), opac=opac.astype(f),
                colors=colors.astype(f),
                shs=(rng.randn(n, 16, 3) * 0.4).astype(f),
                alive=rng.rand(n) > 0.1)


def run_preprocess(s, mode="colors"):
    jcam, tcam = camera()
    kw_j, kw_t = {}, {}
    if mode == "cov3d":
        c6 = np.asarray(jtr.strip_symmetric(
            jtr.covariance_from_scaling_rotation(s["scales"], s["quats"])))
        kw_j["cov3d_precomp"], kw_t["cov3d_precomp"] = jnp.asarray(c6), t(c6)
    else:
        kw_j.update(scales=jnp.asarray(s["scales"]),
                    rotations=jnp.asarray(s["quats"]))
        kw_t.update(scales=t(s["scales"]), rotations=t(s["quats"]))
    if mode == "sh":
        kw_j.update(shs=jnp.asarray(s["shs"]), sh_degree=3,
                    mask=jnp.asarray(s["alive"]))
        kw_t.update(shs=t(s["shs"]), sh_degree=3, mask=t(s["alive"]))
    else:
        kw_j["colors_precomp"] = jnp.asarray(s["colors"])
        kw_t["colors_precomp"] = t(s["colors"])
    pj = _jax_preprocess(jnp.asarray(s["means"]), jnp.asarray(s["opac"]),
                         jcam, W, H, **kw_j)
    pt = tpre.preprocess(t(s["means"]), t(s["opac"]), tcam, W, H, **kw_t)
    return pj, pt


# jitted whole: eager JAX compiles every op on its own, which costs more
_jax_preprocess = jax.jit(jpre.preprocess, static_argnums=(3, 4),
                          static_argnames=("sh_degree",))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4),
                   static_argnames=("tier_budgets", "tier_fracs"))
def _jax_bin(p, tiles_x, tiles_y, d, cap, **kw):
    return jbin.bin_instances_stream(p, tiles_x, tiles_y, d, cap, **kw)


def processed_to_torch(pj):
    """The JAX package's Processed as the port's, through numpy."""
    return tpre.Processed(*(t(np.asarray(v)) for v in pj))


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


class TestBinning:
    CASES = {
        "default": dict(n=100, seed=0, big=False, d=64, cap=1 << 14),
        "flat": dict(n=100, seed=1, big=False, d=64, cap=1 << 14,
                     tier_budgets=()),
        "tiny_cap": dict(n=200, seed=0, big=False, d=64, cap=256),
        "big_clamped": dict(n=1000, seed=7, big=True, d=32, cap=512),
        "tier_shortfall": dict(n=1000, seed=7, big=True, d=32, cap=1 << 16,
                               tier_fracs=(0.01, 0.01)),
        "tiers_cover": dict(n=1000, seed=7, big=True, d=32, cap=1 << 16,
                            tier_fracs=(1.0, 1.0)),
        # 2^21 tiles: the (tile, rank) key needs 32 bits, so both packed
        # sorts take their unpacked fallback
        "unpacked_31bit": dict(n=300, seed=4, big=True, d=32, cap=1 << 14,
                               tiles=(2048, 1024)),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_integer_exact(self, case):
        c = dict(self.CASES[case])
        tiles_x, tiles_y = c.pop("tiles", (TILES_X, TILES_Y))
        s = make_scene(n=c.pop("n"), seed=c.pop("seed"), big=c.pop("big"))
        pj, _ = run_preprocess(s)
        d, cap = c.pop("d"), c.pop("cap")
        bj = _jax_bin(pj, tiles_x, tiles_y, d, cap, **c)
        bt = tbin.bin_instances_stream(processed_to_torch(pj), tiles_x,
                                       tiles_y, d, cap, **c)
        for name in ("inst_rank", "inst_valid", "order", "seg_start",
                     "counts", "counts_raw", "overflow_tiles",
                     "overflow_capacity", "tier_counts"):
            a = getattr(bt, name).numpy()
            b = np.asarray(getattr(bj, name))
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        if case in ("tiny_cap", "big_clamped"):
            assert int(bt.overflow_capacity) > 0
            assert int(bt.seg_start.max()) <= cap
        if case == "tier_shortfall":
            assert int(bt.overflow_tiles) > 0

    def test_layout_helpers(self):
        for args in [(1000, 32, (4, 12), (0.25, 0.1)),
                     (115_320, 512, (4, 12, 64), (0.25, 0.1, 0.01)),
                     (700, 64, (), ())]:
            assert (tbin.stream_instance_bound(*args)
                    == jbin.stream_instance_bound(*args))
            n, d, b, f = args
            assert (tbin.auto_instance_cap(n, d, 16, 16, b, f)
                    == jbin.auto_instance_cap(n, d, 16, 16, b, f))
        rng = np.random.RandomState(5)
        needs = np.concatenate([rng.randint(0, 30, 5000),
                                rng.randint(100, 4056, 300)])
        for limit in (16_000_000, 200_000, 30_000):
            assert (tbin.adaptive_tier_layout(needs, 512, (4, 12, 64),
                                              (0.25, 0.1, 0.01),
                                              slot_limit=limit,
                                              quantize=True)
                    == jbin.adaptive_tier_layout(needs, 512, (4, 12, 64),
                                                 (0.25, 0.1, 0.01),
                                                 slot_limit=limit,
                                                 quantize=True))
        with pytest.raises(ValueError, match="non-increasing"):
            tbin._tier_layout(100, 32, (4, 12), (0.1, 0.25))
