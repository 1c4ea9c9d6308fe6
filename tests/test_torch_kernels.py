"""The port's composite wrappers (ops/stream.py, ops/composite.py) and
their CUDA kernels: B1 and B3f (csrc/stream_fwd.cu), B2 (csrc/stream_bwd.cu),
B3b (csrc/stream_bwd_fast.cu), B4 (csrc/padded_fwd.cu) and B5
(csrc/padded_bwd.cu), at every tile shape they take (tiles of more than
1,024 pixels, or for B3b a side over 64, walked in parts).

This file imports neither JAX nor the JAX package, so the tests marked
``gpu`` also run on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Each ``gpu`` test skips inside its body when there is no card. The kernel is
held against ``composite_stream_plain`` within 2e-4 max abs (the bound the
JAX package's kernels were held to against CPU f32; the two differ only in
the last bits of exp, and a flipped 1/255 or 1e-4 threshold). The backward
kernel is held to ``composite_stream_bwd_plain`` per attribute row within
1e-5 of that row's largest magnitude: the two replay the forward with the
same rounding and differ only in the order of the sum over a tile's pixels.
The fast-math kernels (B3f, B3b) are held to their plain versions within
the JAX package's fast-mode contract (``tests/test_fast_math.py``): 2e-3
max abs on image and final_T, 5e-3 of each row's largest magnitude on
gradients; the plain versions take the log-space route of the TPU kernel,
the kernels a per-pixel loop with TF32 tensor-core moment sums. The
kernels walk 8×4-pixel warp blocks and skip entries whose cull box misses
a block (``TestCompactBlocksAndCull``), which must change no output.
B4 is held to ``composite_padded_plain`` within 2e-4 and B5 to
``composite_padded_bwd_plain`` within 1e-5 per plane, as B1 and B2.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu_torch.ops import composite, stream
from mvs_gaussian_splatting_tpu_torch.ops.composite import random_tables
from mvs_gaussian_splatting_tpu_torch.ops.stream import (
    composite_stream, composite_stream_plain, random_stream)

torch.set_num_threads(1)

TOL = 2e-4
BWD_REL = 1e-5
FAST_TOL = 2e-3      # the JAX package's fast-mode contract
FAST_REL = 5e-3


def synthetic_stream(seed, long_len=2700):
    return random_stream(seed, tiles_x=6, tiles_y=5, long_len=long_len)


def _args(s, device):
    return ([torch.from_numpy(s[k]).to(device) for k in
             ("attrs", "seg_start", "counts", "bg", "tile_ids")]
            + [s["tiles_x"], s["tile_w"], s["tile_h"]])


def _cotangents(s, seed):
    """A random g_out and a nonzero g_tfin for the stream ``s``."""
    t, p = s["seg_start"].shape[0], s["tile_w"] * s["tile_h"]
    rng = np.random.RandomState(100 + seed)
    return (torch.from_numpy(rng.randn(t, p, 3).astype(np.float32)),
            torch.from_numpy(rng.randn(t, p).astype(np.float32)))


def bwd_gaps(got, want):
    """Per attribute row: max |got − want| / max |want| (0 for zero rows,
    which must then match exactly)."""
    gaps = []
    for r in range(want.shape[0]):
        scale = float(want[r].abs().max())
        err = float((got[r] - want[r]).abs().max())
        gaps.append(err / scale if scale > 0 else (0.0 if err == 0 else
                                                   float("inf")))
    return gaps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package (the card's machine has neither)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "mvs_gaussian_splatting_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    banned = {"jax", "jaxlib", "mvs_gaussian_splatting_tpu"}
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names
                      if n.split(".")[0] in banned]
    assert len(files) > 20 and not found, found


class TestWrapperOnCPU:
    def test_cpu_tensors_take_plain_version(self):
        s = synthetic_stream(0, long_len=600)
        before = stream.launches
        out, tfin = composite_stream(*_args(s, "cpu"))
        ref, rtfin = composite_stream_plain(*_args(s, "cpu"))
        assert stream.launches == before      # no kernel on the CPU
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        torch.testing.assert_close(tfin, rtfin, rtol=0, atol=0)

    def test_empty_and_single_entry_tiles(self):
        s = synthetic_stream(1, long_len=600)
        out, tfin = composite_stream(*_args(s, "cpu"))
        bg = torch.from_numpy(s["bg"])
        # tile 0 is empty: background and T = 1 everywhere
        torch.testing.assert_close(out[0], bg.expand(256, 3))
        assert bool((tfin[0] == 1).all())
        # tile 1 holds one entry: out = rgb·α + (1−α)·bg per pixel
        a = s["attrs"][:, s["seg_start"][1]]
        px = torch.arange(256) % 16 + 16.0
        py = (torch.arange(256) // 16).float()
        dx, dy = a[0] - px, a[1] - py
        power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
        alpha = torch.clamp(a[5] * torch.exp(power), max=0.99)
        alpha = torch.where((power <= 0) & (alpha >= 1 / 255), alpha, 0.0)
        want = alpha[:, None] * torch.from_numpy(a[6:9]) + (1 - alpha)[:, None] * bg
        torch.testing.assert_close(out[1], want, atol=1e-6, rtol=0)

    def test_early_exit_visits(self):
        s = synthetic_stream(2, long_len=600)
        _, tfin, visits = composite_stream_plain(*_args(s, "cpu"),
                                                 count_visits=True)
        assert 0 < visits <= int(s["counts"].sum()) * 256
        # saturated pixels stop at the first entry that would pass 1e-4
        assert float(tfin.min()) >= 1e-4
        assert bool((tfin <= 1).all())

    @pytest.mark.parametrize("bad", ["rows", "dtype", "ids", "tile", "stride"])
    def test_rejects_malformed_inputs(self, bad):
        a = _args(synthetic_stream(3, long_len=600), "cpu")
        if bad == "rows":
            a[0] = a[0][:9]
        elif bad == "dtype":
            a[0] = a[0].double()
        elif bad == "ids":
            a[4] = a[4].long()
        elif bad == "tile":       # empty: the one shape no kernel takes
            a[6], a[7] = 0, 16
        else:
            a[0] = a[0][:, ::2]
        with pytest.raises((ValueError, TypeError)):
            composite_stream(*a)

    def test_cpu_backward_takes_plain_version(self):
        s = synthetic_stream(6, long_len=600)
        a = _args(s, "cpu")
        attrs = a[0].clone().requires_grad_()
        bg = a[3].clone().requires_grad_()
        g_out, g_tfin = _cotangents(s, 6)
        before = stream.bwd_launches
        out, tfin = composite_stream(attrs, a[1], a[2], bg, *a[4:])
        torch.autograd.backward((out, tfin), (g_out, g_tfin))
        assert stream.bwd_launches == before
        want, want_bg = stream.composite_stream_bwd_plain(
            *a, out.detach(), tfin.detach(), g_out, g_tfin)
        torch.testing.assert_close(attrs.grad, want, rtol=0, atol=0)
        torch.testing.assert_close(bg.grad, want_bg, rtol=0, atol=0)
        assert float(want[:9].abs().max()) > 0
        assert bool((want[9:] == 0).all())


@pytest.mark.gpu
class TestKernel:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_kernel_matches_plain(self, cuda, seed):
        s = synthetic_stream(seed)
        before = stream.launches
        out, tfin = composite_stream(*_args(s, cuda))
        torch.cuda.synchronize()
        assert stream.launches == before + 1
        ref, rtfin = composite_stream_plain(*_args(s, cuda))
        gap = max(float((out - ref).abs().max()),
                  float((tfin - rtfin).abs().max()))
        print(f"seed {seed}: kernel vs plain max abs {gap:.3e}")
        assert gap <= TOL

    def test_tile_subset_through_tile_ids(self, cuda):
        s = synthetic_stream(4)
        a = _args(s, cuda)
        sel = torch.tensor([3, 0, 7, 1, 2], device=cuda)
        sub = list(a)
        sub[1], sub[2], sub[4] = (x[sel].contiguous() for x in (a[1], a[2], a[4]))
        out, tfin = composite_stream(*sub)
        full, ftfin = composite_stream(*a)
        torch.testing.assert_close(out, full[sel], rtol=0, atol=0)
        torch.testing.assert_close(tfin, ftfin[sel], rtol=0, atol=0)

    def test_cuda_tensor_never_reaches_plain(self, cuda, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("CUDA tensor reached composite_stream_plain")

        monkeypatch.setattr(stream, "composite_stream_plain", refuse)
        out, _ = composite_stream(*_args(synthetic_stream(5), cuda))
        torch.cuda.synchronize()
        assert out.is_cuda and bool(torch.isfinite(out).all())

    def test_render_path_launches_kernel(self, cuda, monkeypatch):
        from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
            params_from_numpy
        from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView
        from mvs_gaussian_splatting_tpu_torch.ops.render import render
        from mvs_gaussian_splatting_tpu_torch.utils import graphics

        def refuse(*args, **kwargs):
            raise AssertionError("CUDA tensor reached composite_stream_plain")

        monkeypatch.setattr(stream, "composite_stream_plain", refuse)
        rng = np.random.RandomState(0)
        n, w, h = 200, 64, 48
        z = rng.uniform(2, 6, n)
        params = params_from_numpy({
            "xyz": np.stack([rng.uniform(-0.8, 0.8, n) * z,
                             rng.uniform(-0.6, 0.6, n) * z, z], -1),
            "f_dc": rng.randn(n, 1, 3), "f_rest": rng.randn(n, 15, 3) * 0.1,
            "scaling": np.log(rng.uniform(0.05, 0.3, (n, 3))),
            "rotation": rng.randn(n, 4), "opacity": rng.randn(n, 1)}, cuda)
        fovx = 1.0
        fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
        proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
        cam = CameraView(torch.eye(4, device=cuda),
                         torch.tensor(proj, device=cuda),
                         torch.zeros(3, device=cuda),
                         torch.tensor(np.tan(fovx / 2), dtype=torch.float32,
                                      device=cuda),
                         torch.tensor(np.tan(fovy / 2), dtype=torch.float32,
                                      device=cuda))
        before = stream.launches
        with torch.no_grad():
            out = render(cam, w, h, params, torch.zeros(3, device=cuda),
                         sh_degree=3)
        torch.cuda.synchronize()
        assert stream.launches == before + 1
        assert out["render"].shape == (3, h, w)
        assert bool(torch.isfinite(out["render"]).all())
        assert int(out["instance_load"]) > 0


def _stream_32x16(seed):
    """A random stream on 32×16 tiles, the flagship recipe's geometry."""
    return random_stream(seed, tiles_x=5, tiles_y=4, tile_w=32, tile_h=16)


def _segment_mask(s, device):
    width = s["attrs"].shape[1]
    inside = torch.zeros(width, dtype=torch.bool, device=device)
    for st, c in zip(s["seg_start"], s["counts"]):
        inside[int(st):int(st) + int(c)] = True
    return inside


@pytest.mark.gpu
class TestBackwardKernel:
    @pytest.mark.parametrize("geometry", ["16x16", "32x16"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_kernel_matches_plain(self, cuda, geometry, seed):
        s = (synthetic_stream(seed) if geometry == "16x16"
             else _stream_32x16(seed))
        a = _args(s, cuda)
        out, tfin = composite_stream(*a)
        g_out, g_tfin = (c.to(cuda) for c in _cotangents(s, seed))
        before = stream.bwd_launches
        got, got_bg = stream.composite_stream_bwd(*a, out, tfin, g_out,
                                                  g_tfin)
        torch.cuda.synchronize()
        assert stream.bwd_launches == before + 1
        want, want_bg = stream.composite_stream_bwd_plain(*a, out, tfin,
                                                          g_out, g_tfin)
        gaps = bwd_gaps(got, want)
        print(f"{geometry} seed {seed}: per-row gaps "
              + " ".join(f"{g:.2e}" for g in gaps[:9]))
        assert max(gaps) <= BWD_REL
        outside = ~_segment_mask(s, cuda)
        assert bool((got[:, outside] == 0).all())
        assert bool((got[9:] == 0).all())
        torch.testing.assert_close(got_bg, want_bg, rtol=1e-6, atol=0)

    def test_autograd_routes_to_kernel(self, cuda, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("CUDA tensor reached a plain version")

        monkeypatch.setattr(stream, "composite_stream_bwd_plain", refuse)
        monkeypatch.setattr(stream, "composite_stream_plain", refuse)
        s = _stream_32x16(2)
        a = _args(s, cuda)
        attrs = a[0].clone().requires_grad_()
        g_out, g_tfin = (c.to(cuda) for c in _cotangents(s, 2))
        fwd, bwd = stream.launches, stream.bwd_launches
        out, tfin = composite_stream(attrs, *a[1:])
        torch.autograd.backward((out, tfin), (g_out, g_tfin))
        torch.cuda.synchronize()
        assert (stream.launches, stream.bwd_launches) == (fwd + 1, bwd + 1)
        assert bool(torch.isfinite(attrs.grad).all())
        assert float(attrs.grad.abs().max()) > 0

    def test_bad_launch_raises(self, cuda, monkeypatch):
        # an empty tile: refused before any launch
        s = random_stream(3, tiles_x=2, tiles_y=3, tile_w=16, tile_h=4,
                          long_len=100)
        a = list(_args(s, cuda))
        out, tfin = composite_stream(*a, fast=True)
        g = torch.zeros_like(out), torch.zeros_like(tfin)
        a[7] = 0
        with pytest.raises(ValueError, match="is empty"):
            stream.composite_stream_bwd(*a, out[:, :0], tfin[:, :0],
                                        g[0][:, :0], g[1][:, :0], fast=True)
        # past the wrapper's check, the library refuses the shape itself,
        # and the wrapper raises on the error code instead of returning
        # zeros
        monkeypatch.setattr(stream, "tile_limit", lambda *args: None)
        empty = torch.zeros((6, 0, 3), device=cuda)
        with pytest.raises(RuntimeError, match="gs_stream_bwd launch failed"):
            stream.composite_stream_bwd(*a, empty, empty[..., 0], empty,
                                        empty[..., 0])
        torch.cuda.synchronize()    # the refused launch left no fault behind

    def test_train_step_launches_both_kernels(self, cuda, monkeypatch):
        from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
            init_from_pcd
        from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView
        from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
            RasterConfig
        from mvs_gaussian_splatting_tpu_torch.train.config import \
            OptimizationConfig
        from mvs_gaussian_splatting_tpu_torch.train.optim import adam_init
        from mvs_gaussian_splatting_tpu_torch.train.step import \
            make_train_step
        from mvs_gaussian_splatting_tpu_torch.utils import graphics

        def refuse(*args, **kwargs):
            raise AssertionError("CUDA tensor reached a plain version")

        monkeypatch.setattr(stream, "composite_stream_plain", refuse)
        monkeypatch.setattr(stream, "composite_stream_bwd_plain", refuse)
        rng = np.random.RandomState(1)
        n, w, h = 300, 96, 64
        z = rng.uniform(2, 6, n)
        pts = np.stack([rng.uniform(-0.8, 0.8, n) * z,
                        rng.uniform(-0.6, 0.6, n) * z, z], -1)
        params, aux = init_from_pcd(pts.astype(np.float32),
                                    rng.rand(n, 3).astype(np.float32), 512,
                                    device=cuda)
        fovx = 1.0
        fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
        proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
        f32 = dict(dtype=torch.float32, device=cuda)
        cam = CameraView(torch.eye(4, **f32), torch.tensor(proj, **f32),
                         torch.zeros(3, **f32),
                         torch.tensor(np.tan(fovx / 2), **f32),
                         torch.tensor(np.tan(fovy / 2), **f32))
        step = make_train_step(OptimizationConfig(),
                               RasterConfig(tile_w=32, tile_h=16), 5.0)
        gt = torch.rand((3, h, w), generator=torch.Generator(
            device=cuda).manual_seed(0), device=cuda)
        fwd, bwd = stream.launches, stream.bwd_launches
        new, adam, aux2, m = step(params, adam_init(params), aux, cam, gt,
                                  torch.zeros(3, device=cuda), 1, True,
                                  width=w, height=h, sh_degree=0)
        torch.cuda.synchronize()
        assert (stream.launches, stream.bwd_launches) == (fwd + 1, bwd + 1)
        assert bool(torch.isfinite(m.loss)) and int(m.nonfinite_grad_rows) == 0
        assert float((new.xyz - params.xyz).abs().max()) > 0
        assert float(aux2.denom.sum()) > 0


def _refuse(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached a plain version")


def _small_camera(device, w, h):
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView
    from mvs_gaussian_splatting_tpu_torch.utils import graphics
    fovx = 1.0
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
    proj = graphics.projection_matrix(0.01, 100.0, fovx, fovy)
    f32 = dict(dtype=torch.float32, device=device)
    return CameraView(torch.eye(4, **f32), torch.tensor(proj, **f32),
                      torch.zeros(3, **f32),
                      torch.tensor(np.tan(fovx / 2), **f32),
                      torch.tensor(np.tan(fovy / 2), **f32))


def _one_train_step(device, raster_cfg):
    """One make_train_step step on a random 300-point scene at 96×64."""
    from mvs_gaussian_splatting_tpu_torch.models.gaussians import \
        init_from_pcd
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig
    from mvs_gaussian_splatting_tpu_torch.train.optim import adam_init
    from mvs_gaussian_splatting_tpu_torch.train.step import make_train_step
    rng = np.random.RandomState(1)
    n, w, h = 300, 96, 64
    z = rng.uniform(2, 6, n)
    pts = np.stack([rng.uniform(-0.8, 0.8, n) * z,
                    rng.uniform(-0.6, 0.6, n) * z, z], -1)
    params, aux = init_from_pcd(pts.astype(np.float32),
                                rng.rand(n, 3).astype(np.float32), 512,
                                device=device)
    step = make_train_step(OptimizationConfig(), raster_cfg, 5.0)
    gt = torch.rand((3, h, w), generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    new, _, aux2, m = step(params, adam_init(params), aux,
                           _small_camera(device, w, h), gt,
                           torch.zeros(3, device=device), 1, True, width=w,
                           height=h, sh_degree=0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(m.loss)) and int(m.nonfinite_grad_rows) == 0
    assert float((new.xyz - params.xyz).abs().max()) > 0
    assert float(aux2.denom.sum()) > 0


def _launch_counts():
    return (stream.launches, stream.bwd_launches, stream.fast_launches,
            stream.fast_bwd_launches, composite.launches,
            composite.bwd_launches)


@pytest.mark.gpu
class TestFastKernels:
    @pytest.mark.parametrize("far", [0.0, 0.2])
    @pytest.mark.parametrize("geometry", ["16x16", "32x16"])
    def test_kernels_match_plain(self, cuda, geometry, far):
        tw = 16 if geometry == "16x16" else 32
        s = random_stream(5, tiles_x=6, tiles_y=5, tile_w=tw, tile_h=16,
                          far=far)
        a = _args(s, cuda)
        before = _launch_counts()
        out, tfin = composite_stream(*a, fast=True)
        g_out, g_tfin = (c.to(cuda) for c in _cotangents(s, 5))
        got, got_bg = stream.composite_stream_bwd(*a, out, tfin, g_out,
                                                  g_tfin, fast=True)
        torch.cuda.synchronize()
        after = _launch_counts()
        assert [x - y for x, y in zip(after, before)] == [0, 0, 1, 1, 0, 0]
        ref, rtfin = stream.composite_stream_fast_plain(*a)
        gap = max(float((out - ref).abs().max()),
                  float((tfin - rtfin).abs().max()))
        want, want_bg = stream.composite_stream_bwd_fast_plain(
            *a, ref, rtfin, g_out, g_tfin)
        gaps = bwd_gaps(got, want)
        print(f"{geometry} far {far}: B3f vs plain {gap:.2e}; B3b per-row "
              + " ".join(f"{g:.1e}" for g in gaps[:9]))
        assert gap <= FAST_TOL and max(gaps) <= FAST_REL
        outside = ~_segment_mask(s, cuda)
        assert bool((got[:, outside] == 0).all())
        assert bool((got[9:] == 0).all())
        torch.testing.assert_close(got_bg, want_bg, rtol=1e-4, atol=1e-4)

    def test_autograd_routes_to_fast_kernels(self, cuda, monkeypatch):
        for name in ("composite_stream_plain", "composite_stream_bwd_plain",
                     "composite_stream_fast_plain",
                     "composite_stream_bwd_fast_plain"):
            monkeypatch.setattr(stream, name, _refuse)
        s = _stream_32x16(2)
        a = _args(s, cuda)
        attrs = a[0].clone().requires_grad_()
        g_out, g_tfin = (c.to(cuda) for c in _cotangents(s, 2))
        before = _launch_counts()
        out, tfin = composite_stream(attrs, *a[1:], fast=True)
        torch.autograd.backward((out, tfin), (g_out, g_tfin))
        torch.cuda.synchronize()
        after = _launch_counts()
        assert [x - y for x, y in zip(after, before)] == [0, 0, 1, 1, 0, 0]
        assert bool(torch.isfinite(attrs.grad).all())
        assert float(attrs.grad.abs().max()) > 0

    def test_fast_train_step_launches_fast_kernels_only(self, cuda,
                                                        monkeypatch):
        from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
            RasterConfig
        for name in ("composite_stream_fast_plain",
                     "composite_stream_bwd_fast_plain"):
            monkeypatch.setattr(stream, name, _refuse)
        before = _launch_counts()
        _one_train_step(cuda, RasterConfig(tile_w=32, tile_h=16,
                                           fast_math=True))
        after = _launch_counts()
        assert [x - y for x, y in zip(after, before)] == [0, 0, 1, 1, 0, 0]


# tiles walked in parts: more than 1,024 pixels (64 x 32: 2 parts of 32 x
# 32; 48 x 48: 4, three of them cut at the edges; 40 x 40: 4, cut to 8
# pixels), and a side over 64 (128 x 8: one part in the forwards, 4 in B3b)
LARGE = {"large_64x32": (64, 32), "large_48x48": (48, 48),
         "large_40x40": (40, 40), "large_128x8": (128, 8)}


def edge_stream(case, seed=11):
    """A random stream (4×3 tiles, tiles 2 and 3 longer than four batches
    of either kernel, a fifth of the entries far-centred wide splats) for
    one edge case of the compact warp blocks, the per-warp cull and the
    pixel parts (any other name: the stream as made, on 32×16 tiles)."""
    tw, th = {"odd_24x10": (24, 10), "odd_24x4": (24, 4),
              "one_warp_8x4": (8, 4), "rows_512x2": (512, 2),
              "threshold": (16, 16), **LARGE}.get(case, (32, 16))
    s = random_stream(seed, tiles_x=4, tiles_y=3, tile_w=tw, tile_h=th,
                      long_len=2700, far=0.2)
    a = s["attrs"]
    rng = np.random.RandomState(seed + 1)
    ids = np.repeat(np.arange(len(s["counts"])), s["counts"])
    ox = (ids % s["tiles_x"]) * tw
    oy = (ids // s["tiles_x"]) * th
    n = len(ids)
    if case == "saturate":
        # tile 2 saturates within its first batch: opaque splats wider than
        # the tile, centred on it
        st = s["seg_start"][2]
        a[0, st:st + 8] = ox[st] + tw / 2
        a[1, st:st + 8] = oy[st] + th / 2
        a[2, st:st + 8], a[3, st:st + 8], a[4, st:st + 8] = 1e-4, 0.0, 1e-4
        a[5, st:st + 8] = 0.99
    elif case == "graze":
        # the alpha = 1/255 boundary within a pixel of a block edge
        sx, sy = rng.uniform(0.5, 20.0, (2, n))
        rho = rng.choice([0.0, 0.9, 0.999], n)
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        a[2, :n], a[3, :n], a[4, :n] = (sy ** 2 / det, -rho * sx * sy / det,
                                        sx ** 2 / det)
        op = rng.uniform(0.01, 0.99, n)
        a[5, :n] = op
        half = np.sqrt(2 * np.log(255 * op) * a[4, :n]
                       / (a[2, :n] * a[4, :n] - a[3, :n] ** 2))
        edge = rng.choice(np.arange(0, tw + 1, 8), n) - 0.5
        side = rng.choice([-1.0, 1.0], n)
        a[0, :n] = ox + edge + side * (half + rng.uniform(-1, 1, n))
        a[1, :n] = oy + rng.uniform(-4, th + 4, n)
    elif case == "degenerate":
        pick = rng.rand(n) < 0.2
        kind = rng.randint(0, 6, n)
        ca, cb, cc = a[2, :n], a[3, :n], a[4, :n]
        for k, sel in enumerate(kind[pick] == i for i in range(6)):
            idx = np.flatnonzero(pick)[sel]
            if k == 0:
                cb[idx] = np.sqrt(ca[idx] * cc[idx])       # det = 0
            elif k == 1:
                cb[idx] = 2 * np.sqrt(ca[idx] * cc[idx])   # det < 0
            elif k == 2:
                ca[idx] = 0.0
            elif k == 3:
                ca[idx] = np.nan
            elif k == 4:
                cc[idx] = np.inf
            else:
                cb[idx] = -np.inf
    elif case == "threshold":
        # opacities one float either side of 1/255, centred on pixels
        pick = rng.rand(n) < 0.3
        m = np.float32(1.0 / 255.0)
        a[5, :n][pick] = np.where(rng.rand(int(pick.sum())) < 0.5,
                                  np.nextafter(m, np.float32(0)),
                                  np.nextafter(m, np.float32(1)))
        a[0, :n][pick] = ox[pick] + rng.randint(0, tw, int(pick.sum()))
        a[1, :n][pick] = oy[pick] + rng.randint(0, th, int(pick.sum()))
    return s


def finite_row_gaps(got, want, call, batch=64):
    """bwd_gaps over the values both have finite, after checking where one
    side is not finite. That is allowed only where the entry's centre,
    conic or opacity is itself not finite (the closed forms then give NaN
    from zero moments), the other side holds exactly zero, and that side
    never reached the entry: the plain version stops at the first multiple
    of 32 entries where every tile is done; the kernel (``batch`` =
    ``kBatch`` of ``csrc/stream_bwd_fast.cu``) at the first batch that opens
    with its own tile done, so no earlier than the start of the batch that
    holds the entry where the plain replay finds the tile done."""
    attrs, seg_start, counts, _, tile_ids, tiles_x, tile_w, tile_h = call
    width, t = attrs.shape[1], seg_start.shape[0]
    dev = attrs.device
    stop = 0
    done_at = torch.full((t,), width, dtype=torch.int64, device=dev)
    for k, _, in_seg, *_, live in stream._fast_replay(
            attrs, seg_start, counts, tile_ids, tiles_x, tile_w, tile_h):
        stop = k + 1
        done_at[in_seg & ~live.any(1) & (done_at == width)] = k
    cnt = torch.minimum(counts.long(), (width - seg_start.long()).clamp(min=0))
    ids = torch.repeat_interleave(torch.arange(t, device=dev), cnt)
    pos = (torch.arange(ids.numel(), device=dev)
           - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt))
    cols = seg_start.long()[ids] + pos
    past_plain = torch.zeros(width, dtype=torch.bool, device=dev)
    past_plain[cols] = pos >= stop
    past_kernel = torch.zeros(width, dtype=torch.bool, device=dev)
    past_kernel[cols] = pos >= done_at[ids] // batch * batch
    bad = ~torch.isfinite(attrs[:6]).all(0)
    fin_w, fin_g = torch.isfinite(want), torch.isfinite(got)
    ok = ((fin_w == fin_g)
          | (bad & past_plain & fin_w & (want == 0))
          | (bad & past_kernel & fin_g & (got == 0)))
    assert bool(ok.all()), (
        f"{int((~ok).sum())} values non-finite on one side only, e.g. "
        f"(row, column) {torch.nonzero(~ok)[:4].tolist()}")
    both = fin_w & fin_g
    return bwd_gaps(torch.where(both, got, 0.0), torch.where(both, want, 0.0))


@pytest.mark.gpu
class TestCompactBlocksAndCull:
    """B1, B3f and B3b on the edge cases of the redesign: odd tile shapes
    (blocks overhanging the tile; an 8×4 tile, one warp, fewer threads than
    B3b's 64-entry batch; a tile too thin for 8×4 blocks within 1,024
    threads, whose warps take pixel rows), more than four batches, a tile
    that saturates in its first batch, cull boxes grazing a block, degenerate
    conics, opacities at 1/255, and tiles walked in parts. B1 is bit-equal
    to its plain version (the cull is exact), B3f within 2e-3, B3b within
    5e-3 per row with exact zeros outside the segments and in rows 9-15."""

    @pytest.mark.parametrize("case", ["odd_24x10", "odd_24x4",
                                      "one_warp_8x4", "rows_512x2",
                                      "saturate", "graze", "degenerate",
                                      "threshold", *LARGE])
    def test_kernels_match_plain(self, cuda, case):
        s = edge_stream(case)
        a = _args(s, cuda)
        out, tfin = composite_stream(*a)
        ref, rtfin = composite_stream_plain(*a)
        torch.cuda.synchronize()
        gap = max(float((out - ref).abs().max()),
                  float((tfin - rtfin).abs().max()))
        assert torch.equal(out, ref) and torch.equal(tfin, rtfin), gap
        fout, ftfin = composite_stream(*a, fast=True)
        fref, frtfin = stream.composite_stream_fast_plain(*a)
        fgap = max(float((fout - fref).abs().max()),
                   float((ftfin - frtfin).abs().max()))
        msg = f"{case}: B1 bit-equal, B3f vs plain {fgap:.2e}"
        assert fgap <= FAST_TOL, msg
        if case == "saturate":    # tile 2 ends within its first 8 entries
            one = [a[0], a[1][2:3], a[2][2:3], a[3], a[4][2:3], *a[5:]]
            _, _, visits = composite_stream_plain(*one, count_visits=True)
            assert visits <= 8 * s["tile_w"] * s["tile_h"]
        g_out, g_tfin = (c.to(cuda) for c in _cotangents(s, 3))
        got, _ = stream.composite_stream_bwd(*a, fout, ftfin, g_out, g_tfin,
                                             fast=True)
        again, _ = stream.composite_stream_bwd(*a, fout, ftfin, g_out,
                                               g_tfin, fast=True)
        want, _ = stream.composite_stream_bwd_fast_plain(
            *a, fref, frtfin, g_out, g_tfin)
        gaps = finite_row_gaps(got[:9], want[:9], a)
        msg += "; B3b per-row " + " ".join(f"{g:.1e}" for g in gaps)
        assert max(gaps) <= FAST_REL, msg
        # bit for bit, NaN (from a degenerate entry's zero moments) included
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        outside = ~_segment_mask(s, cuda)
        assert bool((got[:, outside] == 0).all())
        assert bool((got[9:] == 0).all())
        print(msg)


def exact_row_gaps(got, want, attrs):
    """bwd_gaps over the values both have finite, after checking where
    either side is not finite. Only the plain version may be, and only at
    an entry whose centre or conic is not finite (its rows 0-1 multiply a
    zero dpower by the conic); the kernel writes 0 there, as it does for
    every entry no pixel includes."""
    bad = ~torch.isfinite(attrs[:6]).all(0)
    fin_w, fin_g = torch.isfinite(want), torch.isfinite(got)
    ok = (fin_w & fin_g) | (bad & ~fin_w & (got == 0))
    assert bool(ok.all()), (
        f"{int((~ok).sum())} values non-finite, e.g. (row, column) "
        f"{torch.nonzero(~ok)[:4].tolist()}")
    both = fin_w & fin_g
    return bwd_gaps(torch.where(both, got, 0.0), torch.where(both, want, 0.0))


@pytest.mark.gpu
class TestExactBackwards:
    """B2 and B5, one kernel body (csrc/exact_bwd.cuh), on the edge cases of
    the compact warp blocks and the cull, and on every tile shape their
    forwards take: within 1e-5 of each row's (plane's) largest magnitude
    of the plain version, exact zeros outside the segments, in rows 9-15
    and in invalid or uncounted slots, and two launches equal to the bit."""

    @pytest.mark.parametrize("case", ["odd_24x10", "odd_24x4",
                                      "one_warp_8x4", "rows_512x2",
                                      "saturate", "graze", "degenerate",
                                      "threshold", "long_32x16", *LARGE])
    def test_b2_matches_plain(self, cuda, case):
        s = edge_stream(case)
        a = _args(s, cuda)
        out, tfin = composite_stream(*a)
        g_out, g_tfin = (c.to(cuda) for c in _cotangents(s, 4))
        before = stream.bwd_launches
        got, _ = stream.composite_stream_bwd(*a, out, tfin, g_out, g_tfin)
        again, _ = stream.composite_stream_bwd(*a, out, tfin, g_out, g_tfin)
        torch.cuda.synchronize()
        assert stream.bwd_launches == before + 2
        want, _ = stream.composite_stream_bwd_plain(*a, out, tfin, g_out,
                                                    g_tfin)
        gaps = exact_row_gaps(got[:9], want[:9], a[0])
        print(f"{case}: B2 per-row " + " ".join(f"{g:.1e}" for g in gaps))
        assert max(gaps) <= BWD_REL
        assert torch.equal(got, again)
        outside = ~_segment_mask(s, cuda)
        assert bool((got[:, outside] == 0).all())
        assert bool((got[9:] == 0).all())

    @pytest.mark.parametrize("geometry", ["24x10", "8x4", "512x2", "32x16",
                                          "64x32", "48x48", "128x8"])
    def test_b5_matches_plain(self, cuda, geometry):
        tw, th = (int(v) for v in geometry.split("x"))
        s = random_tables(6, tiles_x=4, tiles_y=3, tile_w=tw, tile_h=th,
                          k=384)
        a = _padded_args(s, cuda)
        out, tfin = composite._padded_fwd(*a)
        t, p = out.shape[:2]
        rng = np.random.RandomState(6)
        g_out = torch.from_numpy(rng.randn(t, p, 3).astype(np.float32)).to(cuda)
        g_tfin = torch.from_numpy(rng.randn(t, p).astype(np.float32)).to(cuda)
        gpl, grgb, _ = composite.composite_padded_bwd(*a, out, tfin, g_out,
                                                      g_tfin)
        again = composite.composite_padded_bwd(*a, out, tfin, g_out, g_tfin)
        torch.cuda.synchronize()
        wpl, wrgb, _ = composite.composite_padded_bwd_plain(
            *a, out, tfin, g_out, g_tfin)
        gaps = bwd_gaps(torch.cat([gpl, grgb.permute(2, 0, 1)]),
                        torch.cat([wpl, wrgb.permute(2, 0, 1)]))
        print(f"{geometry}: B5 per-plane " + " ".join(f"{g:.1e}" for g in gaps))
        assert max(gaps) <= BWD_REL
        assert torch.equal(gpl, again[0]) and torch.equal(grgb, again[1])
        # invalid slots inside the counted range, and slots at and past it
        valid = torch.from_numpy(s["valid"] > 0).to(cuda)
        slot = torch.arange(valid.shape[1], device=cuda)
        counted = slot[None, :] < a[3].long()[:, None]
        assert bool((counted & ~valid).any()) and bool((~counted).any())
        dead = ~valid | ~counted
        assert bool((gpl[:, dead] == 0).all()) and bool((grgb[dead] == 0).all())

    def test_exact_train_step_at_24x10_launches_b2(self, cuda, monkeypatch):
        from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
            RasterConfig
        for name in ("composite_stream_plain", "composite_stream_bwd_plain"):
            monkeypatch.setattr(stream, name, _refuse)
        before = _launch_counts()
        _one_train_step(cuda, RasterConfig(tile_w=24, tile_h=10))
        after = _launch_counts()
        assert [x - y for x, y in zip(after, before)] == [1, 1, 0, 0, 0, 0]


def _padded_args(s, device):
    return ([torch.from_numpy(s[k]).to(device) for k in
             ("planes", "rgb", "valid", "counts", "bg")]
            + [s["tiles_x"], s["tile_w"], s["tile_h"]])


@pytest.mark.gpu
class TestPaddedKernels:
    @pytest.mark.parametrize("geometry", ["16x16", "32x16"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_kernels_match_plain(self, cuda, geometry, seed):
        tw = 16 if geometry == "16x16" else 32
        s = random_tables(seed, tiles_x=6, tiles_y=5, tile_w=tw)
        a = _padded_args(s, cuda)
        before = (composite.launches, composite.bwd_launches)
        out, tfin = composite._padded_fwd(*a)
        t, p = out.shape[:2]
        rng = np.random.RandomState(seed)
        g_out = torch.from_numpy(rng.randn(t, p, 3).astype(np.float32)).to(cuda)
        g_tfin = torch.from_numpy(rng.randn(t, p).astype(np.float32)).to(cuda)
        gpl, grgb, gbg = composite.composite_padded_bwd(*a, out, tfin, g_out,
                                                        g_tfin)
        torch.cuda.synchronize()
        assert (composite.launches, composite.bwd_launches) == (
            before[0] + 1, before[1] + 1)
        ref, rtfin = composite.composite_padded_plain(*a)
        gap = max(float((out - ref).abs().max()),
                  float((tfin - rtfin).abs().max()))
        wpl, wrgb, wbg = composite.composite_padded_bwd_plain(
            *a, out, tfin, g_out, g_tfin)
        gaps = bwd_gaps(torch.cat([gpl, grgb.permute(2, 0, 1)]),
                        torch.cat([wpl, wrgb.permute(2, 0, 1)]))
        print(f"{geometry} seed {seed}: B4 vs plain {gap:.2e}; B5 per-plane "
              + " ".join(f"{g:.1e}" for g in gaps))
        assert gap <= TOL and max(gaps) <= BWD_REL
        dead = torch.from_numpy(s["valid"] == 0).to(cuda)
        assert bool(dead.any())
        assert bool((gpl[:, dead] == 0).all()) and bool((grgb[dead] == 0).all())
        torch.testing.assert_close(gbg, wbg, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("geometry", ["24x10", "512x2", "64x32", "48x48",
                                          "128x8"])
    def test_b4_any_tile(self, cuda, geometry):
        """B4 on the shared forward body at odd, thin and large tiles (walked
        in parts): within 2e-4 of its plain version, two launches equal to
        the bit."""
        tw, th = (int(v) for v in geometry.split("x"))
        s = random_tables(7, tiles_x=4, tiles_y=3, tile_w=tw, tile_h=th,
                          k=384)
        a = _padded_args(s, cuda)
        before = composite.launches
        out, tfin = composite._padded_fwd(*a)
        again = composite._padded_fwd(*a)
        torch.cuda.synchronize()
        assert composite.launches == before + 2
        ref, rtfin = composite.composite_padded_plain(*a)
        gap = max(float((out - ref).abs().max()),
                  float((tfin - rtfin).abs().max()))
        print(f"{geometry}: B4 vs plain {gap:.2e}")
        assert gap <= TOL
        assert torch.equal(out, again[0]) and torch.equal(tfin, again[1])

    def test_autograd_routes_to_padded_kernels(self, cuda, monkeypatch):
        for name in ("composite_padded_plain", "composite_padded_bwd_plain",
                     "composite_tiles_jnp"):
            monkeypatch.setattr(composite, name, _refuse)
        s = random_tables(2, tiles_x=5, tiles_y=4, tile_w=32)
        a = _padded_args(s, cuda)
        planes = a[0].clone().requires_grad_()
        rgb = a[1].clone().requires_grad_()
        before = (composite.launches, composite.bwd_launches)
        out, tfin = composite.composite_padded(planes, rgb, *a[2:])
        (out.square().sum() + tfin.sum()).backward()
        torch.cuda.synchronize()
        assert (composite.launches, composite.bwd_launches) == (
            before[0] + 1, before[1] + 1)
        assert float(planes.grad[0].abs().max()) > 0
        assert bool(torch.isfinite(rgb.grad).all())

    def test_pallas_train_step_launches_padded_kernels(self, cuda,
                                                       monkeypatch):
        from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
            RasterConfig
        for name in ("composite_padded_plain", "composite_padded_bwd_plain",
                     "composite_tiles_jnp"):
            monkeypatch.setattr(composite, name, _refuse)
        before = _launch_counts()
        _one_train_step(cuda, RasterConfig(backend="pallas", tile_w=32,
                                           tile_h=16, tile_capacity=256))
        after = _launch_counts()
        assert [x - y for x, y in zip(after, before)] == [0, 0, 0, 0, 1, 1]


class TestPaddedWrapperOnCPU:
    @pytest.mark.parametrize("bad", ["planes", "valid", "counts", "tile"])
    def test_rejects_malformed_inputs(self, bad):
        a = _padded_args(random_tables(3, tiles_x=2, tiles_y=2, k=64), "cpu")
        if bad == "planes":
            a[0] = a[0][:5]
        elif bad == "valid":
            a[2] = a[2] > 0
        elif bad == "counts":
            a[3] = a[3].long()
        else:                     # an empty tile
            a[6], a[7] = 16, 0
        with pytest.raises((ValueError, TypeError)):
            composite._padded_fwd(*a)

    def test_cpu_tensors_take_plain_versions(self):
        s = random_tables(4, tiles_x=3, tiles_y=2, k=96)
        a = _padded_args(s, "cpu")
        before = (composite.launches, composite.bwd_launches)
        out, tfin = composite._padded_fwd(*a)
        ref, rtfin = composite.composite_padded_plain(*a)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        torch.testing.assert_close(tfin, rtfin, rtol=0, atol=0)
        gpl, grgb, _ = composite.composite_padded_bwd(
            *a, out, tfin, torch.ones_like(out), torch.zeros_like(tfin))
        assert (composite.launches, composite.bwd_launches) == before
        dead = torch.from_numpy(s["valid"] == 0)
        assert float(gpl.abs().max()) > 0
        assert not gpl[:, dead].any() and not grgb[dead].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fast", "exact", "pallas"])
def test_train_step_at_64x32(cuda, monkeypatch, mode):
    """One training step at 64×32 tiles (two parts a tile) in each mode
    launches that mode's two kernels once each and nothing else."""
    from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
    for mod, names in ((stream, ("composite_stream_plain",
                                 "composite_stream_bwd_plain",
                                 "composite_stream_fast_plain",
                                 "composite_stream_bwd_fast_plain")),
                       (composite, ("composite_padded_plain",
                                    "composite_padded_bwd_plain",
                                    "composite_tiles_jnp"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    cfg = {"fast": RasterConfig(tile_w=64, tile_h=32, fast_math=True),
           "exact": RasterConfig(tile_w=64, tile_h=32),
           "pallas": RasterConfig(backend="pallas", tile_w=64, tile_h=32,
                                  tile_capacity=512)}[mode]
    want = {"fast": [0, 0, 1, 1, 0, 0], "exact": [1, 1, 0, 0, 0, 0],
            "pallas": [0, 0, 0, 0, 1, 1]}[mode]
    before = _launch_counts()
    _one_train_step(cuda, cfg)
    after = _launch_counts()
    assert [x - y for x, y in zip(after, before)] == want


@pytest.fixture
def baseline(cuda):
    """The kernel library of another tree's ``csrc`` (``$GS_BASELINE_CSRC``,
    for instance the parent commit's, unpacked with ``git archive``), built
    by ``profile_kernels.build``; skips where the variable is not set."""
    import os

    from mvs_gaussian_splatting_tpu_torch import kernels, profile_kernels
    csrc = os.environ.get("GS_BASELINE_CSRC")
    if not csrc:
        pytest.skip("GS_BASELINE_CSRC names no baseline tree")
    return (profile_kernels.build(pathlib.Path(csrc), "libgs_baseline")[0],
            kernels.library())


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["16x16", "32x16"])
def test_one_part_tiles_bit_equal_to_baseline(baseline, geometry):
    """At tiles of one part (the main path's 16×16 and 32×16) every kernel
    gives the baseline tree's bits: B1, B3f, B2, B3b, B5 run their
    one-part instantiation, the parent's code; B4 its redesign, which
    replays the same per-entry arithmetic in the same order.

        GS_BASELINE_CSRC=build/parent/mvs_gaussian_splatting_tpu_torch/csrc \
            python -m pytest --noconftest -p no:cacheprovider -m gpu \
            tests/test_torch_kernels.py -k baseline
    """
    from mvs_gaussian_splatting_tpu_torch import profile_kernels as pk
    old, new = baseline
    tw = 16 if geometry == "16x16" else 32
    s = random_stream(8, tiles_x=6, tiles_y=5, tile_w=tw, tile_h=16,
                      far=0.2)
    call = tuple(_args(s, "cuda"))
    tab = random_tables(8, tiles_x=6, tiles_y=5, tile_w=tw, k=384)
    tables = tuple(_padded_args(tab, "cuda"))
    gaps, equal = {}, {}
    for kernel in pk.ENTRY:
        c = tables if kernel.startswith("padded") else call
        bwd = None
        if kernel.endswith(("bwd", "bwd_fast")):
            fwd = {"stream_bwd": "stream_fwd", "padded_bwd": "padded_fwd",
                   "stream_bwd_fast": "stream_fwd_fast"}[kernel]
            bwd = pk.backward_inputs(new, c, 8, fwd)
        got = pk.launch(new, kernel, c, bwd)
        want = pk.launch(old, kernel, c, bwd)
        torch.cuda.synchronize()
        gaps[kernel] = max(float((a - b).abs().max())
                           for a, b in zip(got, want))
        equal[kernel] = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"{geometry}: max abs against the baseline {gaps}")
    assert all(equal.values()), gaps
