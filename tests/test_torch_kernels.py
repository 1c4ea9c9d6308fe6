"""The port's stream composite wrapper (ops/stream.py) and its CUDA kernel
(csrc/stream_fwd.cu).

This file imports neither JAX nor the JAX package, so the tests marked
``gpu`` also run on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Each ``gpu`` test skips inside its body when there is no card. The kernel is
held against ``composite_stream_plain`` within 2e-4 max abs (the bound the
JAX package's kernels were held to against CPU f32; the two differ only in
the last bits of exp, and a flipped 1/255 or 1e-4 threshold).
"""

import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu_torch.ops import stream
from mvs_gaussian_splatting_tpu_torch.ops.stream import (
    composite_stream, composite_stream_plain, random_stream)

torch.set_num_threads(1)

TOL = 2e-4


def synthetic_stream(seed, long_len=2700):
    return random_stream(seed, tiles_x=6, tiles_y=5, long_len=long_len)


def _args(s, device):
    return ([torch.from_numpy(s[k]).to(device) for k in
             ("attrs", "seg_start", "counts", "bg", "tile_ids")]
            + [s["tiles_x"], s["tile_w"], s["tile_h"]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


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
        elif bad == "tile":
            a[6], a[7] = 64, 32
        else:
            a[0] = a[0][:, ::2]
        with pytest.raises((ValueError, TypeError)):
            composite_stream(*a)


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
