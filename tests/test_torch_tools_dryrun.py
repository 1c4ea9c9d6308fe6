"""The port's ``tools/graft_entry.py:dryrun_multichip`` over 2 gloo ranks:
every mode's loss and gradients finite, and its camera-batched step's loss
within 1e-5 of the JAX batched step on a mesh of 2 of the conftest's
virtual devices, from the same inputs (the JAX repository's own
``dryrun_multichip`` is not run: it takes minutes)."""

import math

import jax.numpy as jnp
import numpy as np
import torch
import torch_parallel_ranks as R
from test_torch_tools_entry import _jax_graft

from mvs_gaussian_splatting_tpu.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu.parallel import (make_batch_train_step,
                                                 make_mesh)
from mvs_gaussian_splatting_tpu.parallel.data_parallel import stack_cameras
from mvs_gaussian_splatting_tpu.train import OptimizationConfig, adam_init
from mvs_gaussian_splatting_tpu_torch.tools import graft_entry

torch.set_num_threads(1)


def test_dryrun_two_ranks_matches_jax_batch_step():
    # the ranks run (at a lower priority) while this process computes the
    # JAX step
    ranks = R.niced(graft_entry.dryrun_multichip, 2, "cpu")
    graft = _jax_graft()
    w = h = graft_entry.DRYRUN_SIZE
    mesh = make_mesh(2)
    params, aux = graft._synthetic(128, 256)
    cfg = RasterConfig(tile_capacity=64, max_tiles_per_gaussian=8,
                       tile_batch=8, backend="jnp")
    step, place = make_batch_train_step(OptimizationConfig(), cfg, 1.0, mesh)
    cams = stack_cameras([graft._camera(w, h, 2 * math.pi * i / 2)
                          for i in range(2)])
    gts = jnp.zeros((2, 3, h, w)) + 0.5
    args = place(params, adam_init(params), aux, cams, gts, jnp.zeros(3))
    with mesh:
        _, _, _, m = step(*args, jnp.int32(1), jnp.asarray(True), width=w,
                          height=h, sh_degree=0)
    jloss = float(m.loss)
    losses = ranks.result()
    assert set(losses) == {"batch", "tile_train", "grid_train",
                           "gauss_train", "grow_spec_batch"}
    assert all(np.isfinite(v) for v in losses.values())
    print(f"batched loss: port {losses['batch']:.8f}, JAX {jloss:.8f}")
    assert abs(losses["batch"] - jloss) <= 1e-5
