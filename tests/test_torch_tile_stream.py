"""The port's tile-sharded stream render (``parallel/tile_stream.py``)
held against the JAX package's single-device stream render (Pallas in
interpret mode, jitted whole; ``tests/test_tile_stream.py`` holds the JAX
sharded render to it) and against itself across 1, 2 and 4 gloo ranks
(twins of ``tests/test_tile_stream.py``).

The ranks are spawned once for the file (``parallel.multihost.spawn``,
bodies in ``torch_parallel_ranks.py``). 80×48 at 16×16 is 15 tiles, so
2 and 4 ranks hold pad tiles. Tolerances: the JAX tests' (image 1e-5
abs + 1e-4 rel; gradients 1e-5 abs + 1e-4 rel for strips, 2e-5 + 1e-3
for round-robin); across rank counts the port is held to the bit: each
instance slot belongs to one tile, so the SUM of the ranks' packed
gradients adds only zeros, and a gradient W times too large could not
hide.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as R

from mvs_gaussian_splatting_tpu.ops import CameraView, preprocess
from mvs_gaussian_splatting_tpu.ops.rasterize import (RasterConfig,
                                                      _rasterize_stream)
from mvs_gaussian_splatting_tpu.utils.transforms import normalize
from mvs_gaussian_splatting_tpu_torch.ops import stream as tstream
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import \
    bin_and_pack_stream
from mvs_gaussian_splatting_tpu_torch.parallel.mesh import make_mesh as tmesh
from mvs_gaussian_splatting_tpu_torch.parallel.tile_stream import (
    shard_tiles, unshard_order)

torch.set_num_threads(1)

W, H = R.TS_W, R.TS_H
CFG = RasterConfig(max_tiles_per_gaussian=16, backend="stream")


@pytest.fixture(scope="module")
def ranks():
    return R.Ranks("tile_stream")


def _jcam():
    return CameraView(*(jnp.asarray(a) for a in R.camera_np(W, H)))


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """(image of 100 splats over bg, gradients of 80 splats' cotangent
    loss) from the JAX single-device stream render: one jitted call."""
    tx, ty = -(-W // 16), -(-H // 16)

    def pre(means, scales, quats, opac, cols):
        return preprocess(means, opac, _jcam(), W, H, scales=scales,
                          rotations=normalize(quats), colors_precomp=cols)

    @jax.jit
    def refs(args_img, bg, args_grad, cot):
        def loss(*a):
            img, _ = _rasterize_stream(pre(*a), W, H, jnp.zeros(3), CFG, tx,
                                       ty, interpret=True)
            return (img * cot).sum()
        img, _ = _rasterize_stream(pre(*args_img), W, H, bg, CFG, tx, ty,
                                   interpret=True)
        return img, jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args_grad)

    img, grads = refs(_jargs(100, 0), jnp.array([0.2, 0.3, 0.4]),
                      _jargs(80, 7), jnp.asarray(R.cotangent_np(W, H, 1)))
    return np.asarray(img), [np.asarray(g) for g in grads]


def _jargs(n, seed):
    return tuple(jnp.asarray(a) for a in R.splats_np(n, seed))


@pytest.mark.parametrize("mode", ["strips", "rr"])
def test_tile_sharded_stream_matches_jax(ranks, mode):
    want = _jax_refs()[0]
    ranks = ranks.get()
    r0 = ranks[0]
    for n in R.SIZES:
        img, overflow = r0[("image_" + mode, n)]
        np.testing.assert_allclose(img, want, atol=1e-5, rtol=1e-4,
                                   err_msg=f"{mode}, {n} ranks")
        assert overflow == 0
        # every rank of the mesh assembles the same image
        for r in range(n):
            np.testing.assert_array_equal(ranks[r][("image_" + mode, n)][0],
                                          img)


@pytest.mark.parametrize("mode, atol, rtol", [("strips", 1e-5, 1e-4),
                                              ("rr", 2e-5, 1e-3)])
def test_tile_sharded_stream_gradients_match_jax(ranks, mode, atol, rtol):
    want = _jax_refs()[1]
    r0 = ranks.get()[0]
    names = ("means", "scales", "quats", "opac", "cols")
    for n in R.SIZES:
        for got, w, name in zip(r0[("grads_" + mode, n)], want, names):
            np.testing.assert_allclose(got, w, atol=atol,
                                       rtol=rtol,
                                       err_msg=f"{mode}, {n} ranks, {name}")


@pytest.mark.parametrize("mode", ["strips", "rr", "strips_fast", "rr_fast"])
def test_rank_count_invariance(ranks, mode):
    """Image and gradients at 2 and 4 ranks equal 1 rank's to the bit, on
    every rank, exact (B1/B2's plain versions) and fast (B3f/B3b's): no
    gradient is W-fold."""
    ranks = ranks.get()
    for n in (2, 4):
        for r in range(n):
            np.testing.assert_array_equal(
                ranks[r][("image_" + mode, n)][0],
                ranks[0][("image_" + mode, 1)][0])
            for got, want in zip(ranks[r][("grads_" + mode, n)],
                                 ranks[0][("grads_" + mode, 1)]):
                np.testing.assert_array_equal(got, want)


def test_round_robin_subset_passes_kernel_checks():
    """A round-robin shard with pad tiles is what the kernels take: int32
    tile ids not in arange order, seg_start ascending, pad tiles empty at
    the stream's end; the tile order check accepts its heaviest-first
    order; and the shards' outputs reassemble the unsharded call."""
    leaves = R.leaves_of(R.splats_np(100, 0), False)
    cam = R.torch_camera(R.camera_np(W, H))
    proc = R.torch_processed(leaves, cam, W, H)
    tiles_x, tiles_y = -(-W // 16), -(-H // 16)
    bins, attrs = bin_and_pack_stream(proc, tiles_x, tiles_y,
                                      R.TS_CFG)
    bg = torch.tensor([0.1, 0.2, 0.3])
    full = tstream.composite_stream(
        attrs, bins.seg_start, bins.counts, bg,
        torch.arange(tiles_x * tiles_y, dtype=torch.int32), tiles_x, 16, 16)
    for d in (2, 4):
        outs = []
        for r in range(d):
            seg, cnt, ids = shard_tiles(bins, d, r, tiles_x * tiles_y, True)
            assert bool((seg[1:] >= seg[:-1]).all())
            assert ids.dtype == torch.int32 and int(ids[-1]) >= 15 - d
            tstream._check(attrs, seg, cnt, bg, ids, 16, 16)
            tstream.check_order(tstream.heaviest_first(cnt), cnt)
            outs.append(tstream.composite_stream(attrs, seg, cnt, bg, ids,
                                                 tiles_x, 16, 16))
        order = unshard_order(tiles_x * tiles_y, d, True, "cpu")
        for k in range(2):
            got = torch.cat([o[k] for o in outs])[order]
            torch.testing.assert_close(got, full[k], rtol=0, atol=0)


def test_mesh_larger_than_world_is_refused():
    with pytest.raises(ValueError, match="world"):
        tmesh(2, axes=("tile",))
