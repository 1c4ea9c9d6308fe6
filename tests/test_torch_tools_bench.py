"""The port's single-device benches (``tools/bench.py``,
``tools/train_bench.py``, ``tools/profile_step.py``) held against the JAX
repository's ``bench.py`` and ``train_bench.py`` on the CPU.

Inputs come from the bench's seeded numpy draws, which the port copies:
its ``build_scene`` arrays are bit-equal to the JAX one's. The JAX stream
path runs its Pallas kernels in interpret mode, jitted whole; the port
runs the kernels' plain versions. Bounds: the bench's image and loss 2e-4
max abs; exact gradients 5e-6 of each leaf's largest magnitude
(``test_torch_grad.py``'s REL), fast-math gradients 2e-5
(``test_torch_fast.py``'s); the train bench's first step's loss 1e-5.
The fast-math gradients and the records' keys are in
``test_torch_tools_fast.py``, the train bench's step in
``test_torch_tools_train.py`` (each JAX program's compile is ~10 s of the
CPU's time, so each file keeps one or two).
"""

import functools
import importlib
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.ops.preprocess import preprocess
from mvs_gaussian_splatting_tpu.utils.transforms import normalize
from mvs_gaussian_splatting_tpu_torch.tools import bench, profile_step

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
jrast = importlib.import_module("mvs_gaussian_splatting_tpu.ops.rasterize")
W, H, N = 128, 64, 2000
TOL = 2e-4
REL = {False: 5e-6, True: 2e-5}     # exact, fast


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_stream_interpret(monkeypatch):
    """The JAX package's rasterize() through its Pallas stream kernels in
    interpret mode (the CPU has no TPU to lower them)."""
    monkeypatch.setattr(jrast, "_rasterize_stream", functools.partial(
        jrast._rasterize_stream, interpret=True))


def rel_gap(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0
    return float(np.abs(got - want).max()) / scale


def jax_raster_config(fast):
    cfg = bench.raster_config(fast)
    return jrast.RasterConfig(**cfg._asdict())


def test_build_scene_bit_equal():
    jcam, jarrays = _jax_bench().build_scene(N, W, H)
    tcam, tarrays = bench.build_scene(N, W, H, device="cpu")
    for j, t in zip(jarrays, tarrays):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for j, t in zip(jcam, tcam):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def check_loss_and_grads(fast):
    jcam, jarrays = _jax_bench().build_scene(N, W, H)
    cfg = jax_raster_config(fast)

    def loss_fn(means, log_scales, quats, opac_logit, shs):
        p = preprocess(means, jax.nn.sigmoid(opac_logit), jcam, W, H,
                       scales=jnp.exp(log_scales), rotations=normalize(quats),
                       shs=shs, sh_degree=3, tile_w=cfg.tile_w,
                       tile_h=cfg.tile_h)
        img, _ = jrast.rasterize(p, W, H, jnp.zeros(3), cfg)
        return img.mean(), img

    (jloss, jimg), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jarrays)
    tcam, tarrays = bench.build_scene(N, W, H, device="cpu")
    tloss, timg, tgrads, aux = bench.loss_and_grads(
        tarrays, tcam, W, H, bench.raster_config(fast), torch.zeros(3))
    assert int(aux["overflow_capacity"]) == 0
    assert abs(float(tloss) - float(jloss)) <= TOL
    assert float(np.abs(timg.numpy() - np.asarray(jimg)).max()) <= TOL
    gaps = [rel_gap(t.numpy(), np.asarray(j))
            for t, j in zip(tgrads, jgrads)]
    print(f"fast={fast}: gradient gaps " + " ".join(f"{g:.1e}" for g in gaps))
    assert max(gaps) <= REL[fast]


def test_loss_and_grads_match_jax(jax_stream_interpret):
    check_loss_and_grads(fast=False)


def test_profile_step_components():
    res = profile_step.run(64, 32, 300, fast=True, iters=1, device="cpu")
    assert set(res["components_ms"]) == {
        "preprocess", "depth_argsort", "binning", "pack", "pack_fwd_bwd",
        "pack_transpose_scatter", "unsort_scatter", "kernel_fwd",
        "kernel_fwd_bwd", "raster_fwd_bwd", "full_fwd", "full_fwd_bwd"}
    assert all(v > 0 for v in res["components_ms"].values())
    assert res["stages_sum_ms"] == pytest.approx(
        sum(res["components_ms"][k] for k in profile_step.STAGES))
    assert res["instances"] > 0 and res["overflow_capacity"] == 0
    assert res["clock"].startswith("host") and res["card"] is None
    json.dumps(res)
