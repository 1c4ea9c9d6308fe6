"""The train step in the default fast-math configuration held against the
JAX package's (moved from ``test_torch_fast.py``, whose helpers and
bounds it uses)."""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_train import (FIELDS, H, W, _camera, jax_state, rel_gap,
                              scene_state, torch_state)
from test_torch_fast import (jax_stream_interpret)

from mvs_gaussian_splatting_tpu.train.config import \
    PipelineConfig as JPipelineConfig
from mvs_gaussian_splatting_tpu.train.loop import \
    raster_config_from_pipe as jraster_config_from_pipe
from mvs_gaussian_splatting_tpu.train.step import \
    make_train_step as jmake_train_step
from mvs_gaussian_splatting_tpu_torch.train.config import PipelineConfig
from mvs_gaussian_splatting_tpu_torch.train.loop import \
    raster_config_from_pipe
from mvs_gaussian_splatting_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)


def test_train_step_default_config_matches_jax(jax_stream_interpret):
    """One training step under the default ``PipelineConfig`` (fast math,
    16×16 tiles, the default budgets) against the JAX package's step on its
    stream backend, with ``tests/test_torch_train.py::TestTrainStep``'s
    tolerances but one: a parameter's step, read as new − old parameter,
    may differ by one ulp of the new parameter beyond 1e-5 of the largest
    step (both packages round p − step to f32; on this scene the same step
    in exact mode differs by as much)."""
    from mvs_gaussian_splatting_tpu.train.config import \
        OptimizationConfig as JOptimizationConfig
    from mvs_gaussian_splatting_tpu_torch.train.config import \
        OptimizationConfig

    p, mu, nu, aux = scene_state(180, 256, seed=15)
    jcam, tcam = _camera()
    gt = np.random.RandomState(16).rand(3, H, W).astype(np.float32)
    bg = np.array([0.2, 0.3, 0.1], np.float32)
    jcfg = jraster_config_from_pipe(JPipelineConfig())._replace(
        backend="stream")
    tcfg = raster_config_from_pipe(PipelineConfig())
    assert jcfg.fast_math and tcfg.fast_math
    jstep = jmake_train_step(JOptimizationConfig(), jcfg, 4.2)
    jp, jadam, jaux = jax_state(p, mu, nu, aux, count=20)
    jnew, jst, _, jm = jstep(jp, jadam, jaux, jcam, jnp.asarray(gt),
                             jnp.asarray(bg), jnp.int32(21),
                             jnp.asarray(True), width=W, height=H,
                             sh_degree=3, render_n=192)
    tstep = make_train_step(OptimizationConfig(), tcfg, 4.2)
    tp, tadam, taux = torch_state(p, mu, nu, aux, count=20)
    tnew, tst, _, tm = tstep(tp, tadam, taux, tcam, torch.tensor(gt),
                             torch.tensor(bg), 21, True, width=W, height=H,
                             sh_degree=3, render_n=192)
    assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5
    for k in ("n_visible", "overflow_tiles", "overflow_capacity",
              "instance_load", "nonfinite_grad_rows"):
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
    gaps, steps = {}, {}
    for k in FIELDS:
        gj = np.asarray(getattr(jst.mu, k)) - 0.9 * mu[k]
        gt_ = getattr(tst.mu, k).numpy() - 0.9 * mu[k]
        gaps[k] = rel_gap(gt_[:180], gj[:180])
        np.testing.assert_allclose(getattr(tst.nu, k).numpy(),
                                   np.asarray(getattr(jst.nu, k)),
                                   rtol=1e-4, atol=1e-12, err_msg=k)
        # the step read back as new − old parameter carries the rounding of
        # the new parameter: 1e-5 of the largest step plus one ulp of it
        new_j = np.asarray(getattr(jnew, k))
        step_j, step_t = new_j - p[k], getattr(tnew, k).numpy() - p[k]
        excess = (np.abs(step_t - step_j) - np.spacing(np.abs(new_j))
                  ) / np.abs(step_j).max()
        steps[k] = float(excess.max())
    print("default-config step: gradient gaps " + ", ".join(
        f"{k} {v:.1e}" for k, v in gaps.items()) + "; step gaps beyond an "
        "ulp " + ", ".join(f"{k} {v:.1e}" for k, v in steps.items()))
    assert max(steps.values()) <= 1e-5
    assert max(gaps.values()) <= 2e-5
