"""The port's training path held against the JAX package: losses,
schedules, Adam, model state, densification, checkpoints, one train step,
and a short training run through ``cli/train.py`` on the CPU.

Inputs and random draws are made with numpy (or drawn once by JAX) and
handed to both packages. The JAX step takes its stream path through the
Pallas kernels in interpret mode, jitted whole. Tolerances are stated
where they are used.
"""

import functools
import importlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.models import densify as jdensify
from mvs_gaussian_splatting_tpu.models import gaussians as jgauss
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView as JCamera
from mvs_gaussian_splatting_tpu.train import checkpoint as jckpt
from mvs_gaussian_splatting_tpu.train import optim as joptim
from mvs_gaussian_splatting_tpu.train.config import OptimizationConfig
from mvs_gaussian_splatting_tpu.train.step import \
    make_train_step as jmake_train_step
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu.utils import losses as jlosses
from mvs_gaussian_splatting_tpu.utils import schedules as jsched
from mvs_gaussian_splatting_tpu_torch.data.cameras import Camera
from mvs_gaussian_splatting_tpu_torch.data.colmap import write_pinhole_scene
from mvs_gaussian_splatting_tpu_torch.models import densify as tdensify
from mvs_gaussian_splatting_tpu_torch.models import gaussians as tgauss
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import (CameraView,
                                                             preprocess)
from mvs_gaussian_splatting_tpu_torch.ops.raster_ref import \
    rasterize_reference
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render
from mvs_gaussian_splatting_tpu_torch.train import checkpoint as tckpt
from mvs_gaussian_splatting_tpu_torch.train import optim as toptim
from mvs_gaussian_splatting_tpu_torch.train.step import make_train_step
from mvs_gaussian_splatting_tpu_torch.utils import losses as tlosses
from mvs_gaussian_splatting_tpu_torch.utils import schedules as tsched
from test_torch_grad import leaves64, loss64, render64

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def to_np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()
            if v is not None}


def rel_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale if scale else float(
        np.abs(got).max())


@pytest.fixture
def jax_stream_interpret(monkeypatch):
    """The JAX package's rasterize() taking its stream path through the
    Pallas kernels in interpret mode."""
    monkeypatch.setattr(jrast, "_rasterize_stream", functools.partial(
        jrast._rasterize_stream, interpret=True))


class TestLosses:
    def test_ssim_value_and_grad(self):
        rng = np.random.RandomState(0)
        a = rng.rand(3, 40, 52).astype(np.float32)
        b = np.clip(a + 0.1 * rng.randn(3, 40, 52), 0, 1).astype(np.float32)
        val_j, g_j = jax.jit(jax.value_and_grad(jlosses.ssim))(
            jnp.asarray(a), jnp.asarray(b))
        ta = torch.tensor(a, requires_grad=True)
        val_t = tlosses.ssim(ta, torch.tensor(b))
        val_t.backward()
        # the same operator; the blur sums in another order (1e-6 abs)
        assert abs(val_t.item() - float(val_j)) <= 1e-6
        assert float(np.abs(ta.grad.numpy() - np.asarray(g_j)).max()) <= 1e-6
        assert tlosses.psnr(ta, torch.tensor(b))[0].item() == pytest.approx(
            float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))[0]),
            abs=1e-4)

    @pytest.mark.parametrize("step", [-1, 0, 1, 500, 7000, 30000, 40000])
    def test_expon_lr(self, step):
        kw = dict(lr_init=1.6e-4 * 4.2, lr_final=1.6e-6 * 4.2,
                  lr_delay_mult=0.01, max_steps=30000)
        want = float(jsched.expon_lr(step, **kw))
        got = tsched.expon_lr(step, **kw)
        # both evaluate in f32; exp/log may differ in the last bit
        assert got == pytest.approx(want, rel=1e-6)
        assert tsched.expon_lr(step, 0.0, 0.0) == 0.0
        delayed = dict(kw, lr_delay_steps=100)
        assert tsched.expon_lr(step, **delayed) == pytest.approx(
            float(jsched.expon_lr(step, **delayed)), rel=1e-6)


def random_state(n, capacity, seed):
    """numpy (params, mu, nu, aux) dicts: n alive rows in ``capacity``."""
    rng = np.random.RandomState(seed)
    f = np.float32
    p = {"xyz": rng.randn(capacity, 3).astype(f) * 2,
         "f_dc": rng.randn(capacity, 1, 3).astype(f),
         "f_rest": (rng.randn(capacity, 15, 3) * 0.1).astype(f),
         "scaling": rng.uniform(-4, 0, (capacity, 3)).astype(f),
         "rotation": rng.randn(capacity, 4).astype(f),
         "opacity": rng.uniform(-6, 3, (capacity, 1)).astype(f)}
    mu = {k: (rng.randn(*v.shape) * 1e-3).astype(f) for k, v in p.items()}
    nu = {k: (rng.rand(*v.shape) * 1e-5).astype(f) for k, v in p.items()}
    alive = np.zeros(capacity, bool)
    alive[rng.choice(capacity, n, replace=False)] = True
    aux = {"alive": alive,
           "max_radii2d": rng.randint(0, 30, capacity).astype(f),
           "xyz_grad_accum": (rng.rand(capacity) * 4e-3).astype(f),
           "denom": rng.randint(0, 10, capacity).astype(f)}
    return p, mu, nu, aux


def jax_state(p, mu, nu, aux, count=0):
    jp = jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    adam = joptim.AdamState(
        count=jnp.asarray(count, jnp.int32),
        mu=jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}))
    jaux = jgauss.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    return jp, adam, jaux


def torch_state(p, mu, nu, aux, count=0):
    return (tgauss.params_from_numpy(p, "cpu"),
            toptim.adam_from_numpy(count, mu, nu, "cpu"),
            tgauss.aux_from_numpy(aux, "cpu"))


class TestOptim:
    def test_adam_and_scrub_on_identical_grads(self):
        p, mu, nu, aux = random_state(50, 64, seed=1)
        rng = np.random.RandomState(2)
        grads = {k: rng.randn(*v.shape).astype(np.float32) * 1e-3
                 for k, v in p.items()}
        grads["xyz"][3, 1] = np.nan            # two poisoned rows
        grads["opacity"][7, 0] = np.inf
        grads["f_rest"][9] = 1e-30             # tiny of both signs
        grads["f_rest"][9, ::2] *= -1
        opt = OptimizationConfig()
        jp, jadam, jaux = jax_state(p, mu, nu, aux, count=9)
        tp, tadam, taux = torch_state(p, mu, nu, aux, count=9)
        jg, jbad = jax.jit(joptim.scrub_grads)(jgauss.GaussianParams(
            **{k: jnp.asarray(v) for k, v in grads.items()}))
        tg, tbad = toptim.scrub_grads(tgauss.params_from_numpy(grads, "cpu"))
        assert int(jbad) == int(tbad) == 2
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                          np.asarray(getattr(jg, k)))
        jnew, jst = jax.jit(joptim.adam_update)(
            jg, jadam, jp, joptim.group_lrs(opt, 10, 4.2, jp),
            alive=jaux.alive)
        tnew, tst = toptim.adam_update(
            tg, tadam, tp, toptim.group_lrs(opt, 10, 4.2, tp),
            alive=taux.alive)
        assert int(tst.count) == int(jst.count) == 10
        # identical inputs, the same f32 expressions: within 1 ulp-scale
        for k in FIELDS:
            for got, want in ((getattr(tnew, k), getattr(jnew, k)),
                              (getattr(tst.mu, k), getattr(jst.mu, k)),
                              (getattr(tst.nu, k), getattr(jst.nu, k))):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9)
        dead = ~aux["alive"]
        np.testing.assert_array_equal(tnew.xyz.numpy()[dead], p["xyz"][dead])


class TestModelState:
    def test_init_from_pcd_and_knn(self):
        rng = np.random.RandomState(3)
        pts = rng.randn(100, 3).astype(np.float32)
        cols = rng.rand(100, 3).astype(np.float32)
        jp, jaux = jax.jit(functools.partial(jgauss.init_from_pcd,
                                             capacity=128))(pts, cols)
        tp, taux = tgauss.init_from_pcd(pts, cols, 128, sh_degree=3,
                                        device="cpu")
        # knn: the same expanded-form distances, f32 (1e-5 relative)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(tp, k).numpy(),
                                       np.asarray(getattr(jp, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(taux.alive.numpy(),
                                      np.asarray(jaux.alive))
        assert int(tgauss.num_alive(taux)) == 100

    def test_pad_and_compact_state(self):
        p, mu, nu, aux = random_state(40, 64, seed=4)
        jp, jadam, jaux = jax_state(p, mu, nu, aux)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        jp2, jaux2 = jgauss.pad_capacity(jp, jaux, 128)
        tp2, taux2 = tgauss.pad_capacity(tp, taux, 128)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(tp2, k).numpy(),
                                          np.asarray(getattr(jp2, k)))
        pad = {k: np.concatenate([v, np.zeros_like(v)]) for k, v in
               list(mu.items())}
        _, jadam2, _ = jax_state(p, pad, pad, aux)
        _, tadam2, _ = torch_state(p, pad, pad, aux)
        want = jax.jit(jgauss.compact_state)(jp2, jadam2.mu, jadam2.nu, jaux2)
        got = tgauss.compact_state(tp2, tadam2.mu, tadam2.nu, taux2)
        for w, g in zip(want, got):
            for k, v in to_np(w).items():
                np.testing.assert_array_equal(getattr(g, k).numpy(), v,
                                              err_msg=k)
        assert got[3].alive[:40].all() and not got[3].alive[40:].any()
        exported = tgauss.compact(tp, taux)
        np.testing.assert_array_equal(exported["xyz"],
                                      p["xyz"][aux["alive"]])


class TestDensify:
    def test_densify_and_prune_matches_jax(self):
        # too few free slots for every split: some parents are left as
        # they are, and the shortfall is counted
        capacity = 80
        p, mu, nu, aux = random_state(60, capacity, seed=5)
        # a mix of small (clone) and large (split) hot Gaussians
        p["scaling"][::3] = np.log(0.5)
        key = jax.random.PRNGKey(6)
        k1, k2 = jax.random.split(key)
        noise = (np.asarray(jax.random.normal(k1, (capacity, 3))),
                 np.asarray(jax.random.normal(k2, (capacity, 3))))
        cfg_kw = dict(grad_threshold=2e-4, min_opacity=0.005,
                      percent_dense=0.01)
        jp, jadam, jaux = jax_state(p, mu, nu, aux)
        jout = jax.jit(jdensify.densify_and_prune, static_argnums=(6,))(
            jp, jadam.mu, jadam.nu, jaux, key, 10.0,
            jdensify.DensifyConfig(**cfg_kw), True)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        tout = tdensify.densify_and_prune(
            tp, tadam.mu, tadam.nu, taux, None, 10.0,
            tdensify.DensifyConfig(**cfg_kw), True, noise=noise)
        jinfo, tinfo = jout[4], tout[4]
        assert {k: int(v) for k, v in jinfo.items()} == tinfo
        assert tinfo["n_cloned"] > 0 and tinfo["n_split"] > 0
        assert tinfo["n_pruned"] > 0 and tinfo["n_dropped"] > 0
        # the split offsets go through a 3x3 rotation (1e-6 abs)
        for w, g in zip(jout[:4], tout[:4]):
            for k, v in to_np(w).items():
                np.testing.assert_allclose(getattr(g, k).numpy(), v,
                                           rtol=1e-6, atol=1e-6, err_msg=k)

    def test_reset_opacity_and_stats(self):
        p, mu, nu, aux = random_state(30, 48, seed=7)
        jp, jadam, jaux = jax_state(p, mu, nu, aux)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        jr = jdensify.reset_opacity(jp, jadam.mu, jadam.nu)
        tr = tdensify.reset_opacity(tp, tadam.mu, tadam.nu)
        np.testing.assert_allclose(tr[0].opacity.numpy(),
                                   np.asarray(jr[0].opacity), rtol=1e-6)
        assert not tr[1].opacity.any() and not tr[2].opacity.any()
        rng = np.random.RandomState(8)
        radii = rng.randint(0, 20, 48).astype(np.int32)
        g = rng.randn(48, 2).astype(np.float32)
        vis = radii > 0
        ja = jdensify.add_densification_stats(jaux, jnp.asarray(radii),
                                              jnp.asarray(g),
                                              jnp.asarray(vis))
        ta = tdensify.add_densification_stats(taux, torch.tensor(radii),
                                              torch.tensor(g),
                                              torch.tensor(vis))
        for k, v in to_np(ja).items():
            np.testing.assert_allclose(getattr(ta, k).numpy(), v, rtol=1e-6)
        np.testing.assert_allclose(
            tdensify.densification_grads(ta).numpy(),
            np.asarray(jdensify.densification_grads(ja)), rtol=1e-6)

    def test_grow_mode_refused(self):
        """The grow round, once refused, now runs: every hot Gaussian is
        grown into a free slot and its direction logits are reset to
        uniform (tests/test_torch_grow.py holds it against the JAX
        package)."""
        from mvs_gaussian_splatting_tpu_torch.models.grow import GrowConfig
        from mvs_gaussian_splatting_tpu_torch.utils.sphere import \
            sphere_points
        p, mu, nu, aux = random_state(30, 96, seed=13)
        rng = np.random.RandomState(14)
        for tree in (p, mu, nu):
            tree["dirs_prob"] = rng.randn(96, 128).astype(np.float32)
        tp, tadam, taux = torch_state(p, mu, nu, aux)
        hot = taux.alive & (tdensify.densification_grads(taux) >= 2e-4)
        out = tdensify.densify_and_prune_grow(
            tp, tadam.mu, tadam.nu, taux, torch.Generator().manual_seed(0),
            10.0, tdensify.DensifyConfig(), GrowConfig(grow_dir=True),
            torch.tensor(sphere_points(128), dtype=torch.float32), True)
        info = out[4]
        assert info["n_cloned"] == int(hot.sum()) > 0
        assert (out[0].dirs_prob[hot] == 1.0 / 128).all()
        assert bool(torch.isfinite(out[0].xyz).all())


W, H = 64, 48


def _camera(seed=0):
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    V = np.eye(4, dtype=np.float32)
    V[:3, 3] = [0.05, -0.02, 0.1]
    full = (P @ V).astype(np.float32)
    c = np.linalg.inv(V)[:3, 3].astype(np.float32)
    tan = (np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))
    return (JCamera(jnp.asarray(V), jnp.asarray(full), jnp.asarray(c), *tan),
            CameraView(torch.tensor(V), torch.tensor(full), torch.tensor(c),
                       *(torch.tensor(v) for v in tan)))


def scene_state(n, capacity, seed):
    """A random state whose alive rows sit in front of the camera."""
    p, mu, nu, aux = random_state(n, capacity, seed)
    rng = np.random.RandomState(seed + 100)
    z = rng.uniform(2, 6, capacity)
    p["xyz"] = np.stack([rng.uniform(-0.8, 0.8, capacity) * z,
                         rng.uniform(-0.6, 0.6, capacity) * z, z],
                        -1).astype(np.float32)
    p["scaling"] = np.log(rng.uniform(0.04, 0.3, (capacity, 3))).astype(
        np.float32)
    p["opacity"] = rng.uniform(-2, 3, (capacity, 1)).astype(np.float32)
    aux["alive"] = np.arange(capacity) < n      # a prefix, as compacted
    return p, mu, nu, aux


class TestTrainStep:
    def test_one_step_matches_jax(self, jax_stream_interpret):
        p, mu, nu, aux = scene_state(180, 256, seed=9)
        jcam, tcam = _camera()
        gt = np.random.RandomState(10).rand(3, H, W).astype(np.float32)
        bg = np.array([0.2, 0.3, 0.1], np.float32)
        opt = OptimizationConfig(opacitysparse=0.1)
        kw = dict(tile_w=32, tile_h=16, max_tiles_per_gaussian=64,
                  tier_budgets=(4, 12), tier_fracs=(0.25, 0.1))
        jstep = jmake_train_step(opt, jrast.RasterConfig(backend="stream",
                                                         **kw), 4.2)
        jp, jadam, jaux = jax_state(p, mu, nu, aux, count=20)
        jnew, jst, jaux2, jm = jstep(jp, jadam, jaux, jcam, jnp.asarray(gt),
                                     jnp.asarray(bg), jnp.int32(21),
                                     jnp.asarray(True), width=W, height=H,
                                     sh_degree=3, render_n=192)
        tstep = make_train_step(opt, RasterConfig(**kw), 4.2)
        tp, tadam, taux = torch_state(p, mu, nu, aux, count=20)
        tnew, tst, taux2, tm = tstep(tp, tadam, taux, tcam, torch.tensor(gt),
                                     torch.tensor(bg), 21, True, width=W,
                                     height=H, sh_degree=3, render_n=192)
        # loss: the same image within 2e-4 per pixel, averaged (1e-5 abs)
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5
        for k in ("n_visible", "overflow_tiles", "overflow_capacity",
                  "instance_load", "nonfinite_grad_rows"):
            assert int(getattr(tm, k)) == int(getattr(jm, k)), k
        # the gradients, read from the first moments' change:
        # mu_new − 0.9·mu = 0.1·g, within 3.5e-6 of each leaf's scale
        # (measured 1.3-2.8e-6), and each package within 3e-6 of the
        # float64 evaluation of the same step (measured: JAX 1.2-2.3e-6,
        # the port 0.47-2.3e-6; ROADMAP C11, C13)
        l64 = leaves64(p, 192)
        img64, _ = render64(l64, taux.alive[:192], tcam, bg)
        loss64(img64, torch.tensor(gt).double(), opt, l64["opacity"],
               taux.alive[:192]).backward()
        gaps = {}
        for k in FIELDS:
            gj = np.asarray(getattr(jst.mu, k)) - 0.9 * mu[k]
            gt_ = getattr(tst.mu, k).numpy() - 0.9 * mu[k]
            g64 = 0.1 * l64[k].grad.numpy()[:180]
            gaps[k] = (rel_gap(gt_[:180], gj[:180]), rel_gap(gj[:180], g64),
                       rel_gap(gt_[:180], g64))
        print("one step, port-JAX / JAX-f64 / port-f64: " + ", ".join(
            f"{k} " + " / ".join(f"{g:.2e}" for g in v)
            for k, v in gaps.items()))
        for k in FIELDS:
            assert gaps[k][0] <= 3.5e-6, k
            assert max(gaps[k][1:]) <= 3e-6, k
            # ROADMAP C13: the port no farther from float64 than
            # max(1.25 × the JAX package's gap, 5e-7)
            assert gaps[k][2] <= max(1.25 * gaps[k][1], 5e-7), k
            np.testing.assert_allclose(getattr(tst.nu, k).numpy(),
                                       np.asarray(getattr(jst.nu, k)),
                                       rtol=1e-4, atol=1e-12, err_msg=k)
            # parameters after Adam: steps of ~lr, their differences come
            # from the gradient gap through nonzero prior moments (1e-5 of
            # the largest step)
            step_j = np.asarray(getattr(jnew, k)) - p[k]
            step_t = getattr(tnew, k).numpy() - p[k]
            assert rel_gap(step_t, step_j) <= 1e-5, k
        for k, v in to_np(jaux2).items():
            np.testing.assert_allclose(getattr(taux2, k).numpy(), v,
                                       rtol=2e-5, atol=1e-9, err_msg=k)
        assert float(taux2.denom.sum()) > 0


class TestCheckpoint:
    def test_checkpoints_load_both_ways(self, tmp_path):
        p, mu, nu, aux = scene_state(150, 192, seed=11)
        _, tcam = _camera()
        tp, tadam, taux = torch_state(p, mu, nu, aux, count=33)
        jp, jadam, jaux = jax_state(p, mu, nu, aux, count=33)
        tckpt.save_checkpoint(str(tmp_path / "t.npz"), tp, tadam, taux, 33, 2)
        jckpt.save_checkpoint(str(tmp_path / "j.npz"), jp, jadam, jaux, 33, 2)
        from_t = jckpt.load_checkpoint(str(tmp_path / "t.npz"))
        from_j = tckpt.load_checkpoint(str(tmp_path / "j.npz"), "cpu")
        assert from_t[3:] == (33, 2) and from_j[3:] == (33, 2)
        assert int(from_t[1].count) == int(from_j[1].count) == 33
        for (jtree, ttree) in ((from_t[0], from_j[0]),
                               (from_t[1].mu, from_j[1].mu),
                               (from_t[1].nu, from_j[1].nu),
                               (from_t[2], from_j[2])):
            for k, v in to_np(jtree).items():
                np.testing.assert_array_equal(getattr(ttree, k).numpy(), v)
        # the JAX package's checkpoint, loaded by the port, renders the
        # image the source state renders
        with torch.no_grad():
            want = render(tcam, W, H, tp, torch.zeros(3), sh_degree=2,
                          alive=taux.alive)["render"]
            got = render(tcam, W, H, from_j[0], torch.zeros(3), sh_degree=2,
                         alive=from_j[2].alive)["render"]
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _pose(angle, radius=4.0):
    eye = np.array([radius * math.sin(angle), 0.0, -radius * math.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd])
    return r_w2c.T, -r_w2c @ eye


def write_synthetic_scene(tmp_path, n=120) -> str:
    """A COLMAP scene of ``n`` Gaussians seen from 9 views at 64×48, with
    noisy init points, under ``tmp_path/scene``; returns its path."""
    rng = np.random.RandomState(3)
    means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.2, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    cams, imgs = [], []
    for v in range(9):
        R, T = _pose(2 * math.pi * v / 9)
        cam = Camera(uid=v, colmap_id=v, R=R, T=T, fovx=fovx, fovy=fovy,
                     image=None, image_name=f"v{v:02d}", width=W, height=H)
        with torch.no_grad():
            pre = preprocess(torch.tensor(means), torch.tensor(opac),
                             cam.view("cpu"), W, H,
                             scales=torch.tensor(scales),
                             rotations=torch.tensor(quats),
                             colors_precomp=torch.tensor(cols))
            img = rasterize_reference(pre, W, H, torch.zeros(3)).numpy()
        cams.append(cam)
        imgs.append((np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(
            np.uint8))
    init = means + rng.randn(n, 3).astype(np.float32) * 0.05
    write_pinhole_scene(str(tmp_path / "scene"), cams, imgs, init,
                        np.full((n, 3), 128, np.uint8))
    return str(tmp_path / "scene")


def test_cli_train_synthetic(tmp_path):
    """A hundred-odd Gaussians, 64×48, 20 steps on the CPU through
    ``cli/train.py``: the loss falls, densification runs, parameters stay
    finite, and the model directory holds its artifacts."""
    from mvs_gaussian_splatting_tpu_torch.cli.train import main

    n = 120
    scene = write_synthetic_scene(tmp_path, n)
    model = tmp_path / "model"
    params, aux, _, hist = main([
        "-s", scene, "-m", str(model), "--eval",
        "--no-fast_math", "--device", "cpu", "--iterations", "20",
        "--densify_from_iter", "5", "--densification_interval", "10",
        "--test_iterations", "20", "--save_iterations", "20",
        "--checkpoint_iterations", "20", "--log_every", "5",
        "--tile_w", "32", "--tile_h", "16"])
    losses = [v for _, v in hist["loss"]]
    assert losses[-1] < losses[0]
    assert hist["densify"] and any(d["n_split"] + d["n_cloned"]
                                   for d in hist["densify"])
    assert int(aux.alive.sum()) != n
    assert all(bool(torch.isfinite(a).all()) for a in params
               if a is not None)
    assert sum(v for _, v in hist["nonfinite_grad_rows"]) == 0
    for name in ("cameras.json", "cfg_args.json", "input.ply",
                 "history.json", "chkpnt20.npz",
                 "point_cloud/iteration_20/point_cloud.ply"):
        assert os.path.exists(model / name), name
    assert "20" in json.loads((model / "history.json").read_text())[
        "psnr_test"]


def test_fast_math_refused(tmp_path):
    """The configuration's default ``fast_math=True``, once refused, now
    trains: ``cli/train.py`` with no ``--no-fast_math`` composites through
    the fast-math mode (its plain versions on the CPU) and writes its
    checkpoint, which the port loads back."""
    from mvs_gaussian_splatting_tpu_torch.cli.train import main
    from mvs_gaussian_splatting_tpu_torch.ops import stream

    scene = write_synthetic_scene(tmp_path)
    model = tmp_path / "m"
    calls = []
    real = stream.composite_stream_bwd_fast_plain
    stream.composite_stream_bwd_fast_plain = (
        lambda *a, **k: calls.append(1) or real(*a, **k))
    try:
        params, _, _, hist = main([
            "-s", scene, "-m", str(model), "--device", "cpu",
            "--iterations", "6", "--checkpoint_iterations", "6",
            "--log_every", "2", "--tile_w", "32", "--tile_h", "16"])
    finally:
        stream.composite_stream_bwd_fast_plain = real
    assert len(calls) == 6                     # one fast backward per step
    losses = [v for _, v in hist["loss"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    loaded = tckpt.load_checkpoint(str(model / "chkpnt6.npz"), "cpu")
    assert loaded[3] == 6
    torch.testing.assert_close(loaded[0].xyz, params.xyz, rtol=0, atol=0)
