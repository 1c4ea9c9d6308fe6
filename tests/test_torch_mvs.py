"""The port's MVS branch (``mvs/``: homography, model, dataset) held
against the JAX package's on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the JAX
references are ``jax.jit``-ed whole. The model's weights are drawn with
numpy into the flax variable tree (its shapes from ``jax.eval_shape``, no
flax init) and carried into the port by ``params_from_flax``.

Tolerances: the sampler, warp and cost volume within 1e-5 of each output's
largest magnitude (``F.grid_sample`` recovers a pixel coordinate from its
normalized form with one more rounding than the JAX sampler's direct
taps); the model's outputs and its parameter gradients within 1e-5 of
each leaf's largest magnitude (measured: outputs 0.3-1.2e-7, gradients
0.9e-7 to 2.1e-6; the convolutions' sums are taken in other orders); the synthetic groups' images within 2e-4
max abs (the composite's contract) and their poses exactly.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mvs_gaussian_splatting_tpu.mvs import dataset as jdata
from mvs_gaussian_splatting_tpu.mvs import homography as jhom
from mvs_gaussian_splatting_tpu_torch.mvs import dataset as tdata
from mvs_gaussian_splatting_tpu_torch.mvs import homography as thom

torch.set_num_threads(1)

REL = 1e-5
GRAD_REL = 1e-5
IMG_TOL = 2e-4


def rel_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


# ---- homography ----

class TestBilinear:
    """The JAX package's three facts (tests/test_mvs.py::TestBilinear)."""

    def test_exact_at_centers(self):
        img = t(np.arange(12, dtype=np.float32).reshape(1, 3, 4))
        v = thom.bilinear_sample(img, t([2.0]), t([1.0]))
        assert float(v[0, 0]) == 6.0

    def test_interpolates(self):
        img = t(np.array([[[0.0, 2.0]]]))
        v = thom.bilinear_sample(img, t([0.5]), t([0.0]))
        assert float(v[0, 0]) == pytest.approx(1.0)

    def test_outside_zero(self):
        v = thom.bilinear_sample(torch.ones(1, 4, 4), t([-5.0]), t([0.0]))
        assert float(v[0, 0]) == 0.0

    def test_matches_jax_with_taps_outside(self):
        rng = np.random.RandomState(0)
        img = rng.rand(5, 9, 13).astype(np.float32)
        # a margin beyond the image on every side: partial and empty taps
        x = rng.uniform(-2.5, 14.5, (7, 11)).astype(np.float32)
        y = rng.uniform(-2.5, 10.5, (7, 11)).astype(np.float32)
        want = jax.jit(jhom.bilinear_sample)(img, x, y)
        got = thom.bilinear_sample(t(img), t(x), t(y))
        assert got.shape == (5, 7, 11)
        assert rel_gap(got.numpy(), want) <= REL


class TestPlaneSweep:
    def test_identity_pose_identity_warp(self):
        """Warping a view into itself at any depth is the identity."""
        feat = t(np.random.RandomState(0).rand(4, 16, 16))
        K = t(np.array([[16.0, 0, 8], [0, 16.0, 8], [0, 0, 1]]))
        warped = thom.plane_sweep_warp(feat, torch.linalg.inv(K), K,
                                       torch.eye(3), torch.zeros(3),
                                       t([1.0, 3.0]), 16, 16)
        for d in range(2):
            np.testing.assert_allclose(warped[d].numpy(), feat.numpy(),
                                       atol=1e-4)

    def test_cost_volume_zero_for_identical_views(self):
        feat = t(np.random.RandomState(1).rand(4, 8, 8))
        K = t(np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]]))
        vol = thom.build_cost_volume(feat, feat[None], torch.linalg.inv(K),
                                     K[None], torch.eye(3)[None],
                                     torch.zeros(1, 3), t([2.0]), 8, 8)
        assert float(vol.abs().max()) < 1e-6

    def test_warp_and_volume_match_jax(self):
        rng = np.random.RandomState(3)
        h, w, c, v = 12, 16, 6, 2
        ref = rng.rand(c, h, w).astype(np.float32)
        srcs = rng.rand(v, c, h, w).astype(np.float32)
        K = np.array([[14.0, 0, 8], [0, 14.0, 6], [0, 0, 1]], np.float32)
        k_inv = np.linalg.inv(K).astype(np.float32)
        Ks = np.stack([K, K * np.array([1.05, 1.0, 1.0], np.float32)[:, None]])
        Rs = np.stack([rot_y(0.15), rot_y(-0.2)])
        ts = np.array([[0.3, 0.02, 0.0], [-0.25, 0.0, 0.1]], np.float32)
        # the nearest plane puts the second view's points behind it
        depths = np.array([0.05, 1.0, 2.0, 3.5, 6.0], np.float32)
        jwarp = jax.jit(jhom.plane_sweep_warp, static_argnums=(6, 7))
        want = jwarp(srcs[1], k_inv, Ks[1], Rs[1], ts[1], depths, h, w)
        got = thom.plane_sweep_warp(t(srcs[1]), t(k_inv), t(Ks[1]),
                                    t(Rs[1]), t(ts[1]), t(depths), h, w)
        assert rel_gap(got.numpy(), want) <= REL
        jvol = jax.jit(jhom.build_cost_volume, static_argnums=(7, 8))
        want = jvol(ref, srcs, k_inv, Ks, Rs, ts, depths, h, w)
        got = thom.build_cost_volume(t(ref), t(srcs), t(k_inv), t(Ks),
                                     t(Rs), t(ts), t(depths), h, w)
        assert got.shape == (5, c, h, w)
        assert rel_gap(got.numpy(), want) <= REL


# ---- the model ----

H, W = 32, 48


def model_inputs(seed=2):
    rng = np.random.RandomState(seed)
    ref = rng.rand(3, H, W).astype(np.float32)
    srcs = rng.rand(2, 3, H, W).astype(np.float32)
    hf, wf = H // 4, W // 4
    K = np.array([[wf, 0, wf / 2], [0, wf, hf / 2], [0, 0, 1]], np.float32)
    Ks = np.stack([K, K])
    Rs = np.stack([rot_y(0.1), rot_y(-0.1)])
    ts = np.array([[0.2, 0.0, 0.0], [-0.2, 0.05, 0.0]], np.float32)
    return ref, srcs, K, Ks, Rs, ts, np.float32(1.0), np.float32(5.0)


def flax_weights(model, inputs, seed=4):
    """The flax variable tree of ``model``, its leaves drawn with numpy:
    kernels N(0, 1 / fan-in), biases N(0, 0.05²)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


OUT_KEYS = ("xyz_cam", "rotation", "log_scaling", "opacity_logit", "colors",
            "depth")


def cotangents(shapes, seed=6):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*shapes[k].shape).astype(np.float32)
            for k in OUT_KEYS}


# ---- the dataset ----

CAM_TXT = """extrinsic
0.9702 0.0 0.2425 -0.1
0.0 1.0 0.0 0.05
-0.2425 0.0 0.9702 2.0
0.0 0.0 0.0 1.0

intrinsic
361.54 0.0 82.9
0.0 360.39 66.7
0.0 0.0 1.0

425.0 2.5 192 905.0
"""

PAIR_TXT = """2
0
3 10 2346.41 1 2036.53 9 1243.89
1
2 9 2850.87 10 2583.94
"""


class TestParsers:
    @pytest.mark.parametrize("depth_line", ["425.0 2.5 192 905.0",
                                            "425.0 2.5", ""])
    def test_parse_cam_txt(self, depth_line):
        txt = CAM_TXT.replace("425.0 2.5 192 905.0", depth_line)
        got = tdata.parse_cam_txt(txt)
        want = jdata.parse_cam_txt(txt)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
        assert got[0][2, 3] == pytest.approx(2.0)
        assert got[1][0, 0] == pytest.approx(361.54)

    def test_parse_pair_txt(self):
        assert tdata.parse_pair_txt(PAIR_TXT) == {0: [10, 1, 9], 1: [9, 10]}
        assert tdata.parse_pair_txt(PAIR_TXT) == jdata.parse_pair_txt(
            PAIR_TXT)

    def test_load_dtu_scan_matches_jax(self, tmp_path):
        """A fabricated scan in the MVSNeRF layout: 4 views of 200×150
        (downsized to 96 by ``max_dim``), a pair file, cam files under
        ``Cameras/train``."""
        rng = np.random.RandomState(9)
        cams = tmp_path / "Cameras" / "train"
        cams.mkdir(parents=True)
        imgs = tmp_path / "Rectified" / "scan1_train"
        imgs.mkdir(parents=True)
        (tmp_path / "Cameras" / "pair.txt").write_text(
            "4\n" + "".join(f"{v}\n3 " + " ".join(
                f"{(v + j) % 4} {10.0 - j}" for j in (1, 2, 3)) + "\n"
                for v in range(4)))
        for v in range(4):
            (cams / f"{v:08d}_cam.txt").write_text(
                CAM_TXT.replace("2.0\n", f"{2.0 + 0.1 * v}\n"))
            Image.fromarray(rng.randint(0, 256, (150, 200, 3), np.uint8)
                            ).save(imgs / f"rect_{v + 1:03d}_3_r5000.png")
        got = tdata.load_dtu_scan(str(tmp_path), "scan1", max_dim=96)
        want = jdata.load_dtu_scan(str(tmp_path), "scan1", max_dim=96)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for a, b in zip([g.ref, *g.srcs, g.target],
                            [w.ref, *w.srcs, w.target]):
                assert a.image.shape == (3, 72, 96)
                np.testing.assert_array_equal(a.image, b.image)
                np.testing.assert_array_equal(a.K, b.K)
                np.testing.assert_array_equal(a.w2c, b.w2c)
                assert (a.near, a.far) == (b.near, b.far)
