"""The stream binning's round-robin remap, destination-major as the JAX
package lays it out (moved from ``test_torch_gauss_stream.py``, whose
helpers it uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R
from test_torch_gauss_stream import (W, H, TX, TY)

from mvs_gaussian_splatting_tpu.ops import CameraView, preprocess
from mvs_gaussian_splatting_tpu.ops.binning import \
    bin_instances_stream as jbin_instances_stream
from mvs_gaussian_splatting_tpu.utils.transforms import normalize
from mvs_gaussian_splatting_tpu_torch.ops.binning import \
    bin_instances_stream

torch.set_num_threads(1)


@pytest.mark.parametrize("d", [2, 4])
def test_round_robin_remap_is_destination_major(d):
    """``bin_instances_stream(round_robin=D)``: the same segments as the
    plain layout, position k holding tile (k mod ⌈T/D⌉)·D + k div ⌈T/D⌉,
    pad positions empty, each owner's tiles one contiguous span, and the
    JAX package's layout (``ops/binning.py:342-367,427-428``)."""
    leaves = R.leaves_of(R.splats_np(152, 0), False)
    proc = R.torch_processed(leaves, R.torch_camera(R.camera_np(W, H)), W, H)
    kw = dict(tile_w=16, tile_h=16, tier_budgets=(4, 12),
              tier_fracs=(0.25, 0.1))
    plain = bin_instances_stream(proc, TX, TY, 16, 8192, **kw)
    rr = bin_instances_stream(proc, TX, TY, 16, 8192, round_robin=d, **kw)
    t = TX * TY
    t_per = -(-t // d)
    assert rr.seg_start.shape == (d * t_per,)
    k = np.arange(d * t_per)
    tile = (k % t_per) * d + k // t_per
    real = tile < t
    np.testing.assert_array_equal(rr.counts.numpy()[real],
                                  plain.counts.numpy()[tile[real]])
    assert not rr.counts.numpy()[~real].any()
    # segments tile the stream in position order: one span per owner
    start = rr.seg_start.numpy().astype(np.int64)
    np.testing.assert_array_equal(start[1:], (start + rr.counts.numpy())[:-1])
    # the same instances, rank for rank, in each tile
    for pos in np.nonzero(real)[0]:
        s, c = start[pos], int(rr.counts[pos])
        ps = int(plain.seg_start[tile[pos]])
        np.testing.assert_array_equal(rr.inst_rank.numpy()[s:s + c],
                                      plain.inst_rank.numpy()[ps:ps + c])
    # and the JAX package's remap gives the same layout
    cam = CameraView(*(jnp.asarray(a) for a in R.camera_np(W, H)))
    means, scales, quats, opac, cols = (jnp.asarray(a)
                                        for a in R.splats_np(152, 0))
    jproc = preprocess(means, opac, cam, W, H, scales=scales,
                       rotations=normalize(quats), colors_precomp=cols)
    jrr = jax.jit(lambda p: jbin_instances_stream(
        p, TX, TY, 16, 8192, tile_w=16, tile_h=16, tier_budgets=(4, 12),
        tier_fracs=(0.25, 0.1), round_robin=d))(jproc)
    for k in ("seg_start", "counts", "inst_rank", "inst_valid"):
        np.testing.assert_array_equal(getattr(rr, k).numpy(),
                                      np.asarray(getattr(jrr, k)), err_msg=k)
