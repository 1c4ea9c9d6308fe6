"""The port's scaling bench (``tools/scaling_bench.py``) at a tiny size on
1 and 2 gloo ranks: every leg of the JAX repository's ``scaling_bench.py``
runs at each count it is defined for; a sharded step's loss equals the
unsharded one's and a sharded render's image the unsharded one's (each
tile and each Gaussian is owned by one rank: equal within 1e-6 of
scale); nothing overflows; the collectives each mode issues are counted
(none at one rank)."""

import json

import pytest
import torch
import torch_parallel_ranks as R

from mvs_gaussian_splatting_tpu_torch.tools import scaling_bench

torch.set_num_threads(1)


def test_legs_at_one_and_two_ranks():
    res = R.niced(scaling_bench.run, 2, "cpu", iters=1, width=64, height=48,
                  capacity=512, n_init=256).result()
    json.dumps(res)
    legs = res["legs"]
    assert res["devices"] == 2 and "gloo" in res["reading"]
    for leg in ("tile_train", "gauss_train", "camera_dp_b2",
                "tile_stream_fwd", "gauss_stream_fwd",
                "replicated_adam_tail"):
        assert set(legs[leg]["by_devices"]) == {"1", "2"}, leg
    assert set(legs["grid_train_2xT"]["by_devices"]) == {"2"}

    def at(leg, d):
        return legs[leg]["by_devices"][str(d)]

    approx = pytest.approx
    base = at("tile_train", 1)["loss"]
    for leg, d in (("tile_train", 2), ("gauss_train", 1),
                   ("gauss_train", 2)):
        assert at(leg, d)["loss"] == approx(base, rel=1e-6), (leg, d)
    batch = at("camera_dp_b2", 1)["loss"]
    assert at("camera_dp_b2", 2)["loss"] == approx(batch, rel=1e-6)
    assert at("grid_train_2xT", 2)["loss"] == approx(batch, rel=1e-6)
    # the batch's mean loss is the mean of the two cameras' losses
    assert batch == approx(base / 2, rel=1e-6)
    image = at("tile_stream_fwd", 1)["overflow"]["image_mean"]
    for leg in ("tile_stream_fwd", "gauss_stream_fwd"):
        for d in (1, 2):
            assert at(leg, d)["overflow"]["image_mean"] == approx(
                image, rel=1e-6), (leg, d)
    for leg, rec in legs.items():
        for d, entry in rec["by_devices"].items():
            assert entry["ms"] > 0
            assert not entry["overflow"].get("tiles"), (leg, d)
            assert not entry["overflow"].get("capacity"), (leg, d)
            if d == "1":
                assert entry["collectives_per_iteration"] == {}, leg
    assert "all_to_all" in at("gauss_train", 2)["collectives_per_iteration"]
    assert "all_reduce" in at("tile_train", 2)["collectives_per_iteration"]
    assert at("gauss_stream_fwd", 1)["overhead_vs_d1"] > 0
