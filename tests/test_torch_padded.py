"""The port's padded-table backends (``RasterConfig.backend`` ``"pallas"``
and ``"jnp"``) held against the JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
JAX package's padded kernels (B4 ``composite.py:_fwd_kernel``, B5
``_bwd_kernel``) run in interpret mode through ``composite_pallas`` /
``composite_tiles_pallas``, as its own ``tests/test_pallas_composite.py``
runs them: its ``rasterize(backend="pallas")`` cannot be reached on the CPU
(it passes no ``interpret``), so the end-to-end image and gradients are
held against ``rasterize(backend="jnp")``. JAX references are jitted whole.

Tolerances: images and final_T within 2e-4 max abs (the bound the JAX
package's kernels are held to against CPU f32); gradients within 2e-5 of
each leaf's largest magnitude (``tests/test_torch_grad.py``); padded and
invalid slots' gradients exactly zero.
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
from mvs_gaussian_splatting_tpu.ops import binning as jbin
from mvs_gaussian_splatting_tpu.ops.pallas.composite import composite_pallas
from mvs_gaussian_splatting_tpu.ops.preprocess import CameraView as JCamera
from mvs_gaussian_splatting_tpu.ops.preprocess import \
    preprocess as jpreprocess
from mvs_gaussian_splatting_tpu.utils import graphics
from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
    params_from_numpy
from mvs_gaussian_splatting_tpu_torch.ops import binning as tbin
from mvs_gaussian_splatting_tpu_torch.ops import composite as tcomp
from mvs_gaussian_splatting_tpu_torch.ops import preprocess as tpre
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render

torch.set_num_threads(1)

jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
jrender_mod = importlib.import_module("mvs_gaussian_splatting_tpu.ops.render")

W, H = 64, 48
TILES_X, TILES_Y = W // 16, H // 16
TOL = 2e-4
REL = 2e-5


def rel_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


def cameras():
    fovx = math.radians(60.0)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, W), H)
    P = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    a = 0.1
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                 [-math.sin(a), 0, math.cos(a)]]
    V[:3, 3] = [0.1, -0.05, 0.2]
    full = (P @ V).astype(np.float32)
    center = np.linalg.inv(V)[:3, 3].astype(np.float32)
    tan = (np.float32(math.tan(fovx / 2)), np.float32(math.tan(fovy / 2)))
    return (JCamera(jnp.asarray(V), jnp.asarray(full), jnp.asarray(center),
                    *tan),
            CameraView(torch.tensor(V), torch.tensor(full),
                       torch.tensor(center), *(torch.tensor(v) for v in tan)))


def random_model(n, seed):
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


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_processed(means, w, h, opac, scales, quats, colors, jcam):
    return jpreprocess(means, opac, jcam, w, h, scales=scales,
                       rotations=quats, colors_precomp=colors)


def jax_processed(n, seed):
    """The JAX package's Processed of a random scene; the port bins the
    same (through numpy), so the two binnings see identical inputs."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(2, 6, n)
    means = np.stack([rng.uniform(-0.8, 0.8, n) * z,
                      rng.uniform(-0.6, 0.6, n) * z, z], -1)
    jcam, _ = cameras()
    pj = _jax_processed(
        jnp.asarray(means, jnp.float32), W, H,
        jnp.asarray(rng.uniform(0.3, 0.99, n), jnp.float32),
        jnp.asarray(rng.uniform(0.05, 0.6, (n, 3)), jnp.float32),
        jnp.asarray(rng.randn(n, 4), jnp.float32),
        jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32), jcam)
    pt = tpre.Processed(*(torch.from_numpy(np.array(v)) for v in pj))
    return pj, pt


_jax_bin = jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3, 4))


class TestBinGaussians:
    # block 96: the enumeration runs over blocks of 3 and 24 Gaussians
    @pytest.mark.parametrize("d,cap,block", [(32, 128, None), (4, 16, None),
                                             (32, 128, 96), (4, 16, 96)])
    def test_matches_jax(self, d, cap, block, monkeypatch):
        if block:
            monkeypatch.setattr(tbin, "ENUM_BLOCK", block)
        pj, pt = jax_processed(160, seed=1)
        bj = _jax_bin(pj, TILES_X, TILES_Y, d, cap)
        bt = tbin.bin_gaussians(pt, TILES_X, TILES_Y, d, cap)
        for name in bj._fields:
            np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                          np.asarray(getattr(bj, name)),
                                          err_msg=name)
        assert int(bt.valid.sum()) > 0
        if d == 4:       # the tight layout clips on both counts
            assert int(bt.overflow_tiles) > 0
            assert int(bt.overflow_capacity) > 0
        # padded slots point at Gaussian 0
        assert not bt.gauss_idx[~bt.valid].any()


def tables(seed, k=128, holes=False):
    """Padded tables of a random scene binned by the JAX package: (planes
    list, rgb, valid f32, counts) as numpy. ``holes`` marks every fifth
    slot below each count invalid (counts unchanged)."""
    pj, _ = jax_processed(120, seed)
    b = _jax_bin(pj, TILES_X, TILES_Y, 32, k)
    idx = np.asarray(b.gauss_idx)
    xy, conic = np.asarray(pj.xy)[idx], np.asarray(pj.conic)[idx]
    planes = [xy[..., 0], xy[..., 1], conic[..., 0], conic[..., 1],
              conic[..., 2], np.asarray(pj.opacity)[idx]]
    valid = np.asarray(b.valid).copy()
    counts = np.asarray(b.counts).clip(max=k).astype(np.int32)
    if holes:
        valid[:, ::5] = False
    return ([p.astype(np.float32) for p in planes],
            np.asarray(pj.rgb)[idx].astype(np.float32),
            valid.astype(np.float32), counts)


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_padded_vjp(planes, rgb, valid, counts, bg, k, cts):
    def f(pl, c, b):
        return composite_pallas(pl, c, valid, counts, b, TILES_X, 16, 16, k,
                                True)
    out, pull = jax.vjp(f, tuple(planes), rgb, bg)
    return out, pull(cts)


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def _jax_padded_vjp_tiles(planes, rgb, valid, counts, bg, cts, tiles_x,
                          tile_w, tile_h, k):
    def f(pl, c, b):
        return composite_pallas(pl, c, valid, counts, b, tiles_x, tile_w,
                                tile_h, k, True)
    out, pull = jax.vjp(f, tuple(planes), rgb, bg)
    return out, pull(cts)


class TestPaddedComposite:
    @pytest.mark.parametrize("holes", [False, True])
    def test_plain_matches_pallas_interpret(self, holes):
        k = 128
        planes, rgb, valid, counts = tables(2, k, holes)
        t, p = counts.shape[0], 256
        bg = np.array([0.2, 0.4, 0.1], np.float32)
        rng = np.random.RandomState(3)
        g_out = rng.randn(t, p, 3).astype(np.float32)
        g_tfin = rng.randn(t, p).astype(np.float32)
        (out_j, tfin_j), (gpl_j, grgb_j, gbg_j) = _jax_padded_vjp(
            [jnp.asarray(a) for a in planes], jnp.asarray(rgb),
            jnp.asarray(valid), jnp.asarray(counts), jnp.asarray(bg), k,
            (jnp.asarray(g_out), jnp.asarray(g_tfin)))

        tp = torch.from_numpy(np.stack(planes))
        args = (tp, torch.from_numpy(rgb), torch.from_numpy(valid),
                torch.from_numpy(counts), torch.from_numpy(bg), TILES_X, 16,
                16)
        out, tfin = tcomp.composite_padded_plain(*args)
        gap = max(float(np.abs(out.numpy() - np.asarray(out_j)).max()),
                  float(np.abs(tfin.numpy() - np.asarray(tfin_j)).max()))
        gpl, grgb, gbg = tcomp.composite_padded_bwd_plain(
            *args, out, tfin, torch.from_numpy(g_out),
            torch.from_numpy(g_tfin))
        gaps = [rel_gap(gpl[r].numpy(), gpl_j[r]) for r in range(6)]
        gaps.append(rel_gap(grgb.numpy(), grgb_j))
        gaps.append(rel_gap(gbg.numpy(), gbg_j))
        print(f"holes {holes}: forward {gap:.2e}, gradients "
              + " ".join(f"{g:.1e}" for g in gaps))
        assert gap <= TOL and max(gaps) <= REL
        # padded and invalid slots: exact zeros, in the port and in JAX
        dead = valid == 0
        assert dead.any() and (~dead).any()
        assert not gpl.numpy()[:, dead].any() and not grgb.numpy()[dead].any()
        assert not np.asarray(gpl_j)[:, dead].any()
        # and the JAX package's own jnp tile compositor agrees
        out_jnp, _ = jrast.composite_tiles_jnp(
            jnp.stack(planes[:2], -1), jnp.stack(planes[2:5], -1),
            jnp.asarray(rgb), jnp.asarray(planes[5]), jnp.asarray(valid > 0),
            jnp.arange(t), TILES_X, 16, 16, jnp.asarray(bg))
        assert float(np.abs(out.numpy().transpose(0, 2, 1)
                            - np.asarray(out_jnp)).max()) <= TOL

    # 24×10 and 8×4: tiles of a part-filled and of a single 8×4 warp block,
    # which B5 takes since its redesign
    @pytest.mark.parametrize("geometry", [(24, 10), (8, 4)])
    def test_plain_bwd_matches_pallas_interpret_odd_tiles(self, geometry):
        tw, th = geometry
        k = 128
        s = tcomp.random_tables(5, tiles_x=3, tiles_y=2, tile_w=tw,
                                tile_h=th, k=k)
        t, p = s["counts"].shape[0], tw * th
        rng = np.random.RandomState(6)
        g_out = rng.randn(t, p, 3).astype(np.float32)
        g_tfin = rng.randn(t, p).astype(np.float32)
        (out_j, tfin_j), (gpl_j, grgb_j, gbg_j) = _jax_padded_vjp_tiles(
            [jnp.asarray(a) for a in s["planes"]], jnp.asarray(s["rgb"]),
            jnp.asarray(s["valid"]), jnp.asarray(s["counts"]),
            jnp.asarray(s["bg"]), (jnp.asarray(g_out), jnp.asarray(g_tfin)),
            s["tiles_x"], tw, th, k)
        args = [torch.from_numpy(s[key]) for key in
                ("planes", "rgb", "valid", "counts", "bg")] + [
            s["tiles_x"], tw, th]
        out, tfin = tcomp.composite_padded_plain(*args)
        gap = max(float(np.abs(out.numpy() - np.asarray(out_j)).max()),
                  float(np.abs(tfin.numpy() - np.asarray(tfin_j)).max()))
        gpl, grgb, gbg = tcomp.composite_padded_bwd_plain(
            *args, out, tfin, torch.from_numpy(g_out),
            torch.from_numpy(g_tfin))
        gaps = [rel_gap(gpl[r].numpy(), gpl_j[r]) for r in range(6)]
        gaps += [rel_gap(grgb.numpy(), grgb_j), rel_gap(gbg.numpy(), gbg_j)]
        print(f"{tw}x{th}: forward {gap:.2e}, gradients "
              + " ".join(f"{g:.1e}" for g in gaps))
        assert gap <= TOL and max(gaps) <= REL
        dead = s["valid"] == 0
        assert dead.any()
        assert not gpl.numpy()[:, dead].any() and not grgb.numpy()[dead].any()

    def test_autograd_takes_plain_versions_on_cpu(self):
        planes, rgb, valid, counts = tables(4)
        tp = torch.from_numpy(np.stack(planes)).requires_grad_()
        trgb = torch.from_numpy(rgb).requires_grad_()
        before = (tcomp.launches, tcomp.bwd_launches)
        out, tfin = tcomp.composite_padded(
            tp, trgb, torch.from_numpy(valid), torch.from_numpy(counts),
            torch.tensor([0.1, 0.2, 0.3]), TILES_X, 16, 16)
        (out.sum() + tfin.sum()).backward()
        assert (tcomp.launches, tcomp.bwd_launches) == before
        assert float(tp.grad[0].abs().max()) > 0
        assert float(trgb.grad.abs().max()) > 0


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_render_grads(jp, ndc, jcam, bg, w_img, w_t, *, cfg):
    def loss(p, off):
        out = jrender_mod.render(jcam, W, H, p, bg, sh_degree=3,
                                 ndc_offset=off, raster_config=cfg)
        return ((out["render"] * w_img).sum() + (out["final_T"] * w_t).sum(),
                (out["render"], out["final_T"]))
    return jax.grad(loss, argnums=(0, 1), has_aux=True)(jp, ndc)


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


def test_cli_train_and_render_pallas_backend(tmp_path):
    """A short ``cli/train.py --backend pallas --device cpu`` run (finite
    losses and parameters), then ``cli/render.py --backend pallas`` of its
    test view, equal to the stream backend's render of the same model."""
    from PIL import Image

    from mvs_gaussian_splatting_tpu_torch.cli.render import \
        main as render_main
    from mvs_gaussian_splatting_tpu_torch.cli.train import main
    from test_torch_train import write_synthetic_scene

    scene = write_synthetic_scene(tmp_path)
    model = tmp_path / "model"
    params, aux, _, hist = main([
        "-s", scene, "-m", str(model), "--eval",
        "--backend", "pallas", "--device", "cpu", "--iterations", "6",
        "--test_iterations", "6", "--save_iterations", "6",
        "--log_every", "2", "--max_tiles_per_gaussian", "32",
        "--tile_capacity", "128"])
    losses = [v for _, v in hist["loss"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(bool(torch.isfinite(a).all()) for a in params
               if a is not None)
    assert "6" in {str(k) for k in hist["psnr_test"]}
    pngs = {}
    for backend in ("pallas", "stream"):
        clipped = render_main(["-m", str(model), "-s", scene, "--skip_train",
                               "--device", "cpu", "--backend", backend,
                               "--tile_capacity", "256"])
        assert clipped == {"test": {"views": 2, "overflow_tiles": 0,
                                    "overflow_capacity": 0}}
        out = model / "test" / "ours_6" / "renders" / "00000.png"
        pngs[backend] = np.asarray(Image.open(out), np.int16)
    assert np.abs(pngs["pallas"] - pngs["stream"]).max() <= 1
