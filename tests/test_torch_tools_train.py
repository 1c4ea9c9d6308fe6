"""The port's train bench (``tools/train_bench.py``) held against the JAX
repository's ``train_bench.py`` recipe: the first full step's loss within
1e-5 and its counters equal, the JAX step's stream kernels interpreted
(the helpers of ``test_torch_tools_bench.py``)."""

import jax.numpy as jnp
import torch
from test_torch_tools_bench import (_jax_bench, jax_raster_config,
                                    jax_stream_interpret)

from mvs_gaussian_splatting_tpu.models.gaussians import (GaussianAux,
                                                         GaussianParams)
from mvs_gaussian_splatting_tpu.train.config import OptimizationConfig
from mvs_gaussian_splatting_tpu.train.optim import adam_init
from mvs_gaussian_splatting_tpu.train.step import make_train_step
from mvs_gaussian_splatting_tpu_torch.tools import bench, train_bench

torch.set_num_threads(1)


def test_train_bench_step_matches_jax(jax_stream_interpret):
    """The first step of the fern workload's recipe, shrunk to 96×64 with
    30 % of the cloud behind the camera, in the default fast mode."""
    w, h, n = 96, 64, 1500
    cam, params, adam, aux, gt, bg = train_bench.setup(w, h, n, 0.7,
                                                       device="cpu")
    cfg = bench.raster_config(fast=True)
    tstep = train_bench.make_train_step(
        train_bench.OptimizationConfig(), cfg, train_bench.SPATIAL_LR_SCALE)
    _, _, _, tm = tstep(params, adam, aux, cam, gt, bg, train_bench.STEP,
                        True, width=w, height=h, sh_degree=3)
    jparams = GaussianParams(*(None if a is None else jnp.asarray(a.numpy())
                               for a in params))
    jaux = GaussianAux(*(jnp.asarray(a.numpy()) for a in aux))
    jcam = type(_jax_bench().build_scene(1, w, h)[0])(
        *(jnp.asarray(a.numpy()) for a in cam))
    jstep = make_train_step(OptimizationConfig(), jax_raster_config(True),
                            spatial_lr_scale=train_bench.SPATIAL_LR_SCALE)
    _, _, _, jm = jstep(jparams, adam_init(jparams), jaux, jcam,
                        jnp.asarray(gt.numpy()), jnp.zeros(3),
                        jnp.int32(train_bench.STEP), jnp.bool_(True),
                        width=w, height=h, sh_degree=3, instance_cap=0,
                        visible_cap=0, tier_fracs=())
    print(f"first step's loss: port {float(tm.loss):.8f}, "
          f"JAX {float(jm.loss):.8f}")
    assert int(tm.mask_visible) == int(jm.mask_visible) < n
    assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5
    for k in ("overflow_tiles", "overflow_capacity", "instance_load"):
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
