"""The port's render CLI held against the JAX package's (moved from
``test_torch_io.py``, whose helpers and fixtures it uses)."""

import json
import os
import shutil

import numpy as np
from PIL import Image
import torch
from test_torch_io import (W, H, cli_model)

from mvs_gaussian_splatting_tpu.cli import render as jcli
from mvs_gaussian_splatting_tpu.data import colmap as jcolmap
from mvs_gaussian_splatting_tpu.train import config as jconfig
from mvs_gaussian_splatting_tpu_torch.cli import render as tcli
from mvs_gaussian_splatting_tpu_torch.data import colmap as tcolmap
from mvs_gaussian_splatting_tpu_torch.train import config as tconfig

torch.set_num_threads(1)


class TestRenderCLI:
    def test_pngs_match_jax_cli(self, cli_model, tmp_path):
        jdir, tdir = tmp_path / "jax", tmp_path / "torch"
        shutil.copytree(cli_model, jdir)
        shutil.copytree(cli_model, tdir)
        jcli.main(["-m", str(jdir)])
        tcli.main(["-m", str(tdir), "--device", "cpu"])
        n_files = 0
        for split, count in (("train", 7), ("test", 2)):
            for kind in ("renders", "gt"):
                sub = os.path.join(split, "ours_7", kind)
                names = sorted(os.listdir(tdir / sub))
                assert names == sorted(os.listdir(jdir / sub))
                assert len(names) == count
                for name in names:
                    a = np.asarray(Image.open(tdir / sub / name), np.int16)
                    b = np.asarray(Image.open(jdir / sub / name), np.int16)
                    assert a.shape == (H, W, 3)
                    assert np.abs(a - b).max() <= 1, (sub, name)
                    n_files += 1
        assert n_files == 18

    def test_retained_model_fallback(self, cli_model, tmp_path):
        mdir = tmp_path / "retained"
        shutil.copytree(cli_model, mdir)
        ply = mdir / "point_cloud/iteration_7/point_cloud.ply"
        import gzip
        with open(ply, "rb") as fi, gzip.open(
                mdir / "point_cloud_final.ply.gz", "wb") as fo:
            fo.write(fi.read())
        shutil.rmtree(mdir / "point_cloud")
        tcli.main(["-m", str(mdir), "--device", "cpu", "--skip_train",
                   "--no-adaptive_budgets"])
        assert len(os.listdir(mdir / "test/ours_final/renders")) == 2

    def test_scene_needs_and_layout_match_jax(self, cli_model):
        from mvs_gaussian_splatting_tpu.data.scene import Scene as JScene
        from mvs_gaussian_splatting_tpu.train.loop import eval_config as jeval
        from mvs_gaussian_splatting_tpu_torch.data.scene import \
            Scene as TScene
        from mvs_gaussian_splatting_tpu_torch.train.loop import \
            eval_config as teval
        cfg_j = jconfig.load_cfg_args(str(cli_model))
        cfg_t = tconfig.load_cfg_args(str(cli_model))
        sj = JScene(cfg_j, load_iteration=7, shuffle=False)
        st = TScene(cfg_t, load_iteration=7, shuffle=False)
        cams_j = sj.get_train_cameras() + sj.get_test_cameras()
        cams_t = st.get_train_cameras() + st.get_test_cameras()
        assert [c.image_name for c in cams_t] == [c.image_name
                                                  for c in cams_j]
        for a, b in zip(cams_t, cams_j):
            np.testing.assert_array_equal(a.full_proj, b.full_proj)
            np.testing.assert_array_equal(a.image, b.image)
        ply = str(cli_model / "point_cloud/iteration_7/point_cloud.ply")
        needs_t = tcli.measure_tile_needs(
            tcli.params_from_ply(ply, 3, device="cpu"), cams_t, 16, 16)
        needs_j = jcli.measure_tile_needs(jcli.params_from_ply(ply, 3),
                                          cams_j, 16, 16)
        np.testing.assert_array_equal(needs_t, needs_j)
        pipe_t, pipe_j = tconfig.PipelineConfig(), jconfig.PipelineConfig()
        rc_t = tcli.eval_raster_config(pipe_t, n_gaussians=60)
        rc_j = jcli.eval_raster_config(pipe_j, n_gaussians=60)
        assert rc_t._fields == rc_j._fields and tuple(rc_t) == tuple(rc_j)
        assert (tuple(tcli.adaptive_eval_config(rc_t, needs_t, log=len))
                == tuple(jcli.adaptive_eval_config(rc_j, needs_j, log=len)))
        from mvs_gaussian_splatting_tpu.train.loop import \
            raster_config_from_pipe as jfrom
        from mvs_gaussian_splatting_tpu_torch.train.loop import \
            raster_config_from_pipe as tfrom
        assert tuple(teval(tfrom(pipe_t))) == tuple(jeval(jfrom(pipe_j)))

    def test_colmap_copy_reads_like_jax(self, cli_model):
        with open(cli_model / "cfg_args.json") as f:
            scene = json.load(f)["source_path"]
        for name in ("cameras", "images"):
            path = os.path.join(scene, "sparse/0", f"{name}.bin")
            a = getattr(tcolmap, f"read_{name}_binary")(path)
            b = getattr(jcolmap, f"read_{name}_binary")(path)
            assert a.keys() == b.keys()
            for k in a:
                for x, y in zip(a[k], b[k]):
                    np.testing.assert_array_equal(np.asarray(x),
                                                  np.asarray(y))
