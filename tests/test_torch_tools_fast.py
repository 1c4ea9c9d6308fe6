"""The port's 1080p bench in fast-math mode held against the JAX
repository's ``bench.py``, and the JSON records of the port's benches
(the helpers and bounds of ``test_torch_tools_bench.py``)."""

import json

import pytest
import torch
from test_torch_tools_bench import check_loss_and_grads, jax_stream_interpret

from mvs_gaussian_splatting_tpu_torch.tools import bench, train_bench

torch.set_num_threads(1)


def test_loss_and_grads_match_jax_fast(jax_stream_interpret):
    check_loss_and_grads(fast=True)


def test_json_lines():
    """The records keep the JAX benches' keys, name the device, and count
    the overflow; nothing on the CPU is reported as a device figure."""
    for forward in (False, True):
        res = bench.run(64, 32, 300, forward=forward, iters=1, device="cpu")
        assert res["metric"] == ("1080p_forward_fps" if forward
                                 else "1080p_fwdbwd_fps")
        assert res["vs_baseline"] == pytest.approx(res["value"] / 30.0)
        extra = res["extra"]
        assert extra["finite"] and extra["device"] == "cpu"
        assert extra["tile_capacity_overflow_entries"] == 0
        for k in ("device_ms_per_step", "busy_share",
                  "max_memory_allocated", "card"):
            assert extra[k] is None, k
        json.dumps(res)
    res = train_bench.run("bicycle", iters=1, width=64, height=48, n=400,
                          device="cpu")
    assert res["metric"] == "bicycle_r4_train_it_s"
    assert res["vs_baseline"] == pytest.approx(res["value"] / 15.0)
    for k in ("ms_per_step", "visible_cap", "mask_visible",
              "overflow_visible", "overflow_capacity", "baseline"):
        assert k in res["extra"], k
    assert res["extra"]["finite"]
    assert res["extra"]["nonfinite_grad_rows"] == 0
    json.dumps(res)
