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

import numpy as np
import pytest
import torch
from PIL import Image

from mvs_gaussian_splatting_tpu import native as jnative
from mvs_gaussian_splatting_tpu.data import colmap as jcolmap
from mvs_gaussian_splatting_tpu_torch import native as tnative
from mvs_gaussian_splatting_tpu_torch.cli import convert, video, visualize
from mvs_gaussian_splatting_tpu_torch.data import colmap as tcolmap

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
