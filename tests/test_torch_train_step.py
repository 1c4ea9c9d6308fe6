"""One train step, checkpoints both ways and the training CLI held against
the JAX package (moved from ``test_torch_train.py``, whose helpers and
bounds they use)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_grad import leaves64, loss64, render64
from test_torch_train import (jrast, FIELDS, to_np, rel_gap,
                              jax_stream_interpret, jax_state, torch_state, W,
                              H, _camera, scene_state, write_synthetic_scene)

from mvs_gaussian_splatting_tpu.train import checkpoint as jckpt
from mvs_gaussian_splatting_tpu.train.config import OptimizationConfig
from mvs_gaussian_splatting_tpu.train.step import \
    make_train_step as jmake_train_step
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render
from mvs_gaussian_splatting_tpu_torch.train import checkpoint as tckpt
from mvs_gaussian_splatting_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)


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
