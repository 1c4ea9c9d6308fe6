"""The port's MVS train step and schedule (``mvs/train.py``) held against
the JAX package's on the CPU.

One group at 48×32 from the port's ``make_synthetic_groups`` goes through
both packages' ``make_mvs_train_step`` on the raster configuration each
loop picks off an accelerator (the ``"jnp"`` tile compositor), with the
model's weights drawn with numpy into the flax tree and carried across by
``params_from_flax``. The JAX step is ``jax.jit``-ed whole, once: its
optimizer is an identity transformation that keeps the gradient as its
state, and ``lambda_depth`` 1 runs it on the group with and without a
depth map (``has_depth`` 0 drops the term, as ``lambda_depth`` 0 does).

Tolerances: the loss within 1e-6 absolute, the depth term within 1e-5 of
its size; the gradients within 1e-5 of each leaf's largest magnitude
(measured 0.4-2.9e-6: the render's backward and the CNNs' sums are taken
in other orders); the
learning rates within 1e-6 relative of optax's (float32 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvs_gaussian_splatting_tpu.mvs import train as jtrain
from mvs_gaussian_splatting_tpu.mvs.model import MVSGaussianModel as JModel
from mvs_gaussian_splatting_tpu_torch.mvs import train as ttrain
from mvs_gaussian_splatting_tpu_torch.mvs.dataset import make_synthetic_groups
from mvs_gaussian_splatting_tpu_torch.mvs.model import (MVSGaussianModel,
                                                        params_from_flax)
from test_torch_mvs import flax_weights, rel_gap

torch.set_num_threads(1)

LOSS_TOL = 1e-6
GRAD_REL = 1e-5
W, H = 48, 32
DIMS = (8, 16, 16)
DEPTHS = 8


def keep_grads():
    """An optax transformation that leaves the parameters and keeps the
    gradient as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX step's (loss, l1, grads) on the group with its depth map
    and without, and the group and weights it ran on."""
    group = make_synthetic_groups(n_groups=1, width=W, height=H, n_gauss=200,
                                  seed=1, device="cpu")[0]
    jm = JModel(num_depths=DEPTHS, feat_dims=DIMS)
    batch = jtrain.group_to_batch(group)
    variables = flax_weights(jm, (batch.ref_image, batch.src_images,
                                  batch.k_ref_feat, batch.k_src_feats,
                                  batch.rel_rs, batch.rel_ts, batch.near,
                                  batch.far))
    cfg = jtrain.MVSConfig(num_depths=DEPTHS, feat_dims=DIMS,
                           lambda_depth=1.0)
    tx = keep_grads()
    step, _ = jtrain.make_mvs_train_step(jm, cfg, jtrain.RasterConfig(
        tile_capacity=512, max_tiles_per_gaussian=16, tile_batch=32,
        backend="jnp"), W, H, tx)
    # compiled once for both runs, without LLVM's costlier passes: half the
    # compile time (the loss moves in its last bits, far inside LOSS_TOL)
    step = step.lower(variables, tx.init(variables), batch).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    out = {}
    for has_depth in (1.0, 0.0):
        b = batch._replace(has_depth=jnp.float32(has_depth))
        _, grads, loss, l1 = step(variables, tx.init(variables), b)
        out[has_depth] = (float(loss), float(l1),
                          params_from_flax(jax.tree.map(np.asarray, grads)))
    return group, variables, out


@pytest.mark.parametrize("lambda_depth", [0.0, 1.0])
def test_train_step_matches_jax(jax_steps, lambda_depth):
    group, variables, out = jax_steps
    want_loss, want_l1, want_grads = out[1.0 if lambda_depth else 0.0]
    model = MVSGaussianModel(num_depths=DEPTHS, feat_dims=DIMS)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        variables)))
    cfg = ttrain.MVSConfig(num_depths=DEPTHS, feat_dims=DIMS,
                           lambda_depth=lambda_depth, iterations=100)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-8)
    step, _ = ttrain.make_mvs_train_step(
        model, cfg, ttrain.raster_config("cpu"), W, H, optimizer)
    loss, l1 = step(ttrain.group_to_batch(group, "cpu"), 0)
    assert optimizer.param_groups[0]["lr"] == cfg.lr
    print(f"lambda_depth {lambda_depth}: loss {float(loss):.7f} JAX "
          f"{want_loss:.7f}, l1 {float(l1):.7f} JAX {want_l1:.7f}")
    assert abs(float(l1) - want_l1) <= LOSS_TOL
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    if lambda_depth:
        depth_term = want_loss - out[0.0][0]
        assert depth_term > 1e-3
        assert (abs((float(loss) - out[0.0][0]) - depth_term)
                <= 1e-5 * depth_term + LOSS_TOL)
    gaps = {name: rel_gap(p.grad.numpy(), want_grads[name].numpy())
            for name, p in model.named_parameters()}
    print("step grads vs JAX: " + ", ".join(f"{k} {v:.1e}"
                                            for k, v in gaps.items()))
    assert max(gaps.values()) <= GRAD_REL, gaps


def test_learning_rates_match_optax():
    cfg = ttrain.MVSConfig(iterations=500, lr=5e-4, lr_final_factor=0.1)
    sched = optax.exponential_decay(cfg.lr, cfg.iterations,
                                    cfg.lr_final_factor)
    ks = np.arange(0, 2 * cfg.iterations + 1, 37)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(ks)))
    got = np.array([ttrain.lr_at(cfg, int(k)) for k in ks])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert ttrain.lr_at(cfg, 0) == cfg.lr
    assert ttrain.lr_at(cfg, cfg.iterations) == pytest.approx(cfg.lr * 0.1)
