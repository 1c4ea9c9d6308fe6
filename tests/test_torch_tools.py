"""The port's toy and host tools held against the JAX package: the 2D toy
(``toy2d/splat2d.py``), ``cli/convert.py`` against a stub ``colmap``,
``cli/video.py`` and ``cli/visualize.py``, and the native COLMAP reader
(``native/``, through ``data/colmap.py``).

The JAX toy's random draws are made once under its keys and fed to the
port as data; the JAX references are jitted whole. Tolerances are stated
where they are used.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mvs_gaussian_splatting_tpu import native as jnative
from mvs_gaussian_splatting_tpu.data import colmap as jcolmap
from mvs_gaussian_splatting_tpu.toy2d import splat2d as jtoy
from mvs_gaussian_splatting_tpu_torch import native as tnative
from mvs_gaussian_splatting_tpu_torch.cli import convert, video, visualize
from mvs_gaussian_splatting_tpu_torch.data import colmap as tcolmap
from mvs_gaussian_splatting_tpu_torch.toy2d import splat2d as ttoy

torch.set_num_threads(1)


def target_image(h=48, w=48):
    """A soft two-blob RGB image."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    g1 = np.exp(-(((xs - w * 0.3) ** 2 + (ys - h * 0.3) ** 2)
                  / (2 * (w * 0.12) ** 2)))
    g2 = np.exp(-(((xs - w * 0.7) ** 2 + (ys - h * 0.65) ** 2)
                  / (2 * (w * 0.18) ** 2)))
    img = np.stack([g1, g2, 0.5 * (g1 + g2)], 0)
    return np.clip(img, 0, 1).astype(np.float32)


class TestToy2D:
    def test_render_and_gradient_match_jax(self):
        """64 slots (32 alive) drawn by the JAX toy, rendered at 32×40 with
        a correlation term: the image within 1e-6 of the JAX package's, and
        the render's gradient for every parameter (its VJP with a seeded
        cotangent) within 1e-6 of that parameter's largest gradient. Dead
        slots stay black."""
        jp, jalive = jtoy.init_splats(jax.random.PRNGKey(0), 64, 32)
        rng = np.random.RandomState(0)
        jp = jp._replace(rho=jnp.asarray(
            rng.uniform(-1, 1, 64).astype(np.float32)))
        cot = rng.randn(3, 32, 40).astype(np.float32)

        @jax.jit
        def jref(p):
            img, vjp = jax.vjp(
                lambda q: jtoy.render_splats2d(q, jalive, 32, 40), p)
            return img, vjp(jnp.asarray(cot))[0]

        jimg, jgrad = jref(jp)
        params = ttoy.params_from_numpy(jp, device="cpu")
        alive = torch.tensor(np.asarray(jalive))
        leaves = [p.requires_grad_() for p in params]
        img = ttoy.render_splats2d(ttoy.Splat2DParams(*leaves), alive, 32, 40)
        np.testing.assert_allclose(img.detach().numpy(), jimg, atol=1e-6,
                                   rtol=0)
        grads = torch.autograd.grad(img, leaves, torch.from_numpy(cot))
        for name, g, want in zip(ttoy.Splat2DParams._fields, grads, jgrad):
            want = np.asarray(want)
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)
        with torch.no_grad():
            dark = ttoy.render_splats2d(params, torch.zeros_like(alive), 32,
                                        32)
        assert float(dark.abs().max()) == 0.0

    def test_fit_matches_jax_with_its_draws(self):
        """51 epochs on a 48×48 target at the toy's default learning rate,
        capacity 256 (64 alive), densifying at epochs 25 and 50, the JAX
        toy's initial splats and split jitters fed in: the logged losses
        (epochs 0 and 50) within 1e-5 and the alive counts and mask equal
        to the JAX fit's; the loss falls and the rounds grow the set. (At
        lr 0.02 or more Adam amplifies the two packages' last-bit
        differences until a densification threshold flips a splat.)"""
        tgt = target_image()
        kw = dict(capacity=256, n_init=64, epochs=51,
                  densification_interval=25, seed=0)
        _, jalive, jhist = jtoy.fit_image(tgt, **kw)
        # the JAX fit's draws: split once for the init, once a round
        key = jax.random.PRNGKey(0)
        key, sub = jax.random.split(key)
        jp, ja = jtoy.init_splats(sub, 256, 64)
        jitters = []
        for _ in range(2):
            key, sub = jax.random.split(key)
            jitters.append(torch.tensor(np.asarray(
                jax.random.normal(sub, (256, 2)))))
        init = (ttoy.params_from_numpy(jp, "cpu"),
                torch.tensor(np.asarray(ja)))
        _, alive, hist = ttoy.fit_image(tgt, device="cpu", init=init,
                                        jitters=jitters, **kw)
        assert hist["n_alive"] == jhist["n_alive"]
        np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
        np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5,
                                   rtol=0)
        assert hist["n_alive"][1] > hist["n_alive"][0]
        assert hist["loss"][-1] < 0.7 * hist["loss"][0]

    def test_fit_draws_from_its_seed(self):
        """Without draws given, one seed gives one fit."""
        tgt = target_image(24, 24)
        kw = dict(capacity=64, n_init=16, epochs=21,
                  densification_interval=10, device="cpu")
        runs = [ttoy.fit_image(tgt, seed=s, **kw)[2]["loss"]
                for s in (3, 3, 4)]
        assert runs[0] == runs[1] and runs[0] != runs[2]

    def test_cli_with_reference_config(self, tmp_path):
        """The script entry accepts the reference's config.yml keys
        (2D-Gaussian-Splatting-main/config.yml) and writes a fitted render."""
        import yaml

        rng = np.random.RandomState(0)
        img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "target.png")
        with open(tmp_path / "config.yml", "w") as f:
            yaml.safe_dump({
                "image_size": [32, 32, 3],
                "primary_samples": 50,
                "backup_samples": 100,
                "num_epochs": 30,
                "densification_interval": 20,
                "learning_rate": 0.02,
                "image_file_name": str(tmp_path / "target.png"),
                "gradient_threshold": 0.002,
                "gaussian_threshold": 0.75,
            }, f)
        out = str(tmp_path / "fit.png")
        ttoy.main(["--config", str(tmp_path / "config.yml"), "--out", out,
                   "--device", "cpu"])
        assert Image.open(out).size == (32, 32)


@pytest.fixture
def scene(tmp_path):
    src = tmp_path / "scene"
    os.makedirs(src / "input")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src / "input" / "0.png")
    return src


def _script(path, body):
    path.write_text(body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


@pytest.fixture
def stub_colmap(tmp_path, scene):
    """A fake colmap that records argv and fabricates undistorter outputs."""
    log = tmp_path / "colmap_calls.log"
    script = _script(tmp_path / "colmap", f"""#!/bin/sh
echo "$@" >> {log}
case "$1" in
  image_undistorter)
    mkdir -p {scene}/sparse
    touch {scene}/sparse/cameras.bin {scene}/sparse/images.bin \\
          {scene}/sparse/points3D.bin
    mkdir -p {scene}/images
    cp {scene}/input/0.png {scene}/images/0.png
    ;;
esac
exit 0
""")
    return script, log


class TestConvert:
    def test_full_pipeline(self, scene, stub_colmap):
        script, log = stub_colmap
        convert.main(["-s", str(scene), "--colmap_executable", str(script),
                      "--no_gpu"])
        calls = log.read_text().strip().splitlines()
        assert [c.split()[0] for c in calls] == [
            "feature_extractor", "exhaustive_matcher", "mapper",
            "image_undistorter"]
        assert "--SiftExtraction.use_gpu 0" in calls[0]
        assert "--ImageReader.camera_model OPENCV" in calls[0]
        assert os.path.exists(scene / "sparse" / "0" / "cameras.bin")
        assert not os.path.exists(scene / "sparse" / "cameras.bin")

    def test_skip_matching_and_resize(self, scene, stub_colmap, tmp_path):
        script, log = stub_colmap
        mlog = tmp_path / "magick_calls.log"
        magick = _script(tmp_path / "magick",
                         f"#!/bin/sh\necho \"$@\" >> {mlog}\nexit 0\n")
        convert.main(["-s", str(scene), "--colmap_executable", str(script),
                      "--magick_executable", str(magick), "--resize",
                      "--skip_matching"])
        assert [c.split()[0] for c in log.read_text().strip().splitlines()
                ] == ["image_undistorter"]
        for d in ("images_2", "images_4", "images_8"):
            assert os.path.exists(scene / d / "0.png"), d
        mcalls = mlog.read_text().strip().splitlines()
        assert len(mcalls) == 3
        assert any("-resize 50%" in c for c in mcalls)
        assert any("-resize 12.5%" in c for c in mcalls)

    def test_failed_stage_exits(self, scene, tmp_path):
        bad = _script(tmp_path / "colmap", "#!/bin/sh\nexit 3\n")
        with pytest.raises(SystemExit):
            convert.main(["-s", str(scene), "--colmap_executable", str(bad)])


class TestVideoAndVisualize:
    def test_strips_written(self, tmp_path):
        base = tmp_path / "model" / "test" / "ours_30" / "renders"
        gts = tmp_path / "model" / "test" / "ours_30" / "gt"
        os.makedirs(base)
        os.makedirs(gts)
        rng = np.random.RandomState(0)
        for i in range(2):
            Image.fromarray((rng.rand(16, 24, 3) * 255).astype(np.uint8)
                            ).save(base / f"{i:05d}.png")
            Image.fromarray((rng.rand(16, 24, 3) * 255).astype(np.uint8)
                            ).save(gts / f"{i:05d}.png")
        # a later iteration without renders is not picked when one is named
        os.makedirs(tmp_path / "model" / "test" / "ours_40")
        video.main(["-m", str(tmp_path / "model"), "--iteration", "30"])
        out = tmp_path / "model" / "test" / "ours_30" / "strips"
        files = sorted(os.listdir(out))
        assert files == ["00000.png", "00001.png"]
        strip = np.asarray(Image.open(out / files[0]))
        assert strip.shape == (16, 72, 3)     # [render | gt | heatmap]
        np.testing.assert_array_equal(
            strip[:, :24], np.asarray(Image.open(base / files[0])))

    def test_latest_iteration_picked(self, tmp_path):
        for it in (5, 40):
            d = tmp_path / "m" / "test" / f"ours_{it}"
            os.makedirs(d / "renders")
            os.makedirs(d / "gt")
        arr = np.zeros((8, 8, 3), np.uint8)
        Image.fromarray(arr).save(tmp_path / "m/test/ours_40/renders/a.png")
        Image.fromarray(arr).save(tmp_path / "m/test/ours_40/gt/a.png")
        video.main(["-m", str(tmp_path / "m")])
        assert os.path.exists(tmp_path / "m/test/ours_40/strips/a.png")

    def test_sphere_plot_and_points_file(self, tmp_path):
        out = str(tmp_path / "sphere.png")
        visualize.main(["--num_dirs", "64", "--out", out])
        assert os.path.getsize(out) > 0
        np.savetxt(tmp_path / "points.txt",
                   np.random.RandomState(0).randn(10, 3))
        out = str(tmp_path / "p.png")
        visualize.main(["--points", str(tmp_path / "points.txt"),
                        "--out", out])
        assert os.path.getsize(out) > 0


@pytest.fixture(scope="module")
def colmap_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("colmap")
    rng = np.random.RandomState(0)
    cams = {1: tcolmap.CameraIntrinsics(1, "PINHOLE", 640, 480,
                                        np.array([500.0, 500.0, 320.0,
                                                  240.0])),
            2: tcolmap.CameraIntrinsics(2, "SIMPLE_PINHOLE", 320, 240,
                                        np.array([250.0, 160.0, 120.0])),
            3: tcolmap.CameraIntrinsics(3, "OPENCV", 64, 48,
                                        rng.randn(8))}
    images = {}
    for i in range(5):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        images[i + 1] = tcolmap.ImageExtrinsics(i + 1, q, rng.randn(3),
                                                1 + i % 3, f"img_{i:03d}.png")
    xyz = rng.randn(100, 3)
    rgb = (rng.rand(100, 3) * 255).astype(np.uint8)
    tcolmap.write_cameras_binary(cams, str(d / "cameras.bin"))
    tcolmap.write_images_binary(images, str(d / "images.bin"))
    tcolmap.write_points3d_binary(xyz, rgb, str(d / "points3D.bin"))
    return d, cams, images, xyz, rgb


def _assert_same(a, b):
    """Two parses equal: every array and every name."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


class TestNative:
    def test_builds_outside_the_source(self):
        """g++ builds the port's library under the kernels' build
        directory, not beside ``gsio.cpp``."""
        lib = tnative.load()
        if lib is None:
            pytest.skip("no C++ compiler")
        so = tnative.library_path()
        assert so.is_file() and so.parent.name == "native"
        assert so.parent.parent.name == "torch_kernels"
        assert not (tnative.SOURCE.parent / "libgsio.so").exists()

    def test_equals_jax_native_and_python(self, colmap_files, monkeypatch):
        """The port's native parses equal the JAX package's native parses
        and both packages' Python parsers: every array equal, every name
        equal; the port's readers took the native path (``parses``)."""
        d, cams, images, xyz, rgb = colmap_files
        if tnative.load() is None or jnative.load() is None:
            pytest.skip("no C++ compiler")
        for name in ("cameras", "images", "points3D"):
            path = str(d / f"{name}.bin")
            reader = {"cameras": "read_cameras_binary",
                      "images": "read_images_binary",
                      "points3D": "read_points3d_binary"}[name]
            before = tnative.parses
            got = getattr(tcolmap, reader)(path)
            assert tnative.parses == before + 1, name
            with monkeypatch.context() as m:     # the Python parsers
                m.setattr(tnative, "load", lambda: None)
                m.setattr(jnative, "load", lambda: None)
                _assert_same(got, getattr(tcolmap, reader)(path))
                _assert_same(got, getattr(jcolmap, reader)(path))
            _assert_same(got, getattr(jcolmap, reader)(path))
            raw = {"cameras": tnative.read_cameras,
                   "images": tnative.read_images,
                   "points3D": tnative.read_points3d}[name](path)
            jraw = {"cameras": jnative.read_cameras,
                    "images": jnative.read_images,
                    "points3D": jnative.read_points3d}[name](path)
            _assert_same(raw, jraw)
        np.testing.assert_array_equal(
            tcolmap.read_points3d_binary(str(d / "points3D.bin"))[1], rgb)
        assert {k: v.name for k, v in tcolmap.read_images_binary(
            str(d / "images.bin")).items()} == {
            k: v.name for k, v in images.items()}

    def test_falls_back_without_a_library(self, colmap_files, monkeypatch):
        """No library (no compiler): the readers take the Python parsers
        (no native parse counted) and return the written cameras."""
        d, cams, _, _, _ = colmap_files
        monkeypatch.setattr(tnative, "load", lambda: None)
        before = tnative.parses
        got = tcolmap.read_cameras_binary(str(d / "cameras.bin"))
        assert tnative.parses == before
        _assert_same(got, cams)
