"""The per-warp cull of the port's stream kernels (B1, B3f, B3b): an entry
is skipped for a warp of 8×4 pixels when the warp's pixel rectangle misses
the entry's cull box (``csrc/stream_common.cuh:cull_box``). The cull is
exact only if no (entry, block) pair with a contributing pixel (power ≤ 0
and min(0.99, op·e^power) ≥ 1/255, in the kernels' float32 rounding) is
culled. These tests hold the box's PyTorch mirror
(``ops/stream.py:cull_box``, the same formula and margins) to that on the
CPU, on seeded random streams (16×16, 32×16 and an odd 24×10 tile,
far-centred wide splats, opacities past the 0.99 clamp) and on entries
built to graze a block, with opacities at 1/255 and degenerate conics. The
kernels' outputs themselves are held to their plain versions on the card
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu_torch.ops.composite import (_stream_view,
                                                           random_tables)
from mvs_gaussian_splatting_tpu_torch.ops.stream import cull_box, random_stream

torch.set_num_threads(1)

BLOCK_W, BLOCK_H = 8, 4
MIN_ALPHA = np.float32(1.0 / 255.0)


def contributes(x, y, ca, cb, cc, op, px, py):
    """[E, K] whether entry e contributes at pixel (px, py)[e, k]: the
    kernels' arithmetic, one float32 operation at a time."""
    dx = x[:, None] - px
    dy = y[:, None] - py
    quad = (ca[:, None] * dx) * dx + (cc[:, None] * dy) * dy
    power = -0.5 * quad - (cb[:, None] * dx) * dy
    alpha = torch.minimum(op[:, None] * torch.exp(power),
                          torch.tensor(0.99, dtype=torch.float32))
    return (power <= 0) & (alpha >= torch.tensor(MIN_ALPHA))


def check(ent, ox, oy, tile_w, tile_h):
    """Entries ``ent`` [E, 6] (x, y, a, b, c, op) of tiles whose first pixel
    is (ox, oy)[e]: asserts that no block of an entry's tile with a
    contributing pixel is culled; returns (pairs culled, pairs)."""
    ent = torch.as_tensor(ent, dtype=torch.float32)
    x, y, ca, cb, cc, op = ent.unbind(1)
    hx, hy = cull_box(ca, cb, cc, op)
    ox = torch.as_tensor(ox, dtype=torch.float32)
    oy = torch.as_tensor(oy, dtype=torch.float32)
    culled = pairs = 0
    for by in range(0, tile_h, BLOCK_H):
        for bx in range(0, tile_w, BLOCK_W):
            lx = torch.arange(bx, min(bx + BLOCK_W, tile_w))
            ly = torch.arange(by, min(by + BLOCK_H, tile_h))
            gy, gx = torch.meshgrid(ly.float(), lx.float(), indexing="ij")
            px = ox[:, None] + gx.reshape(1, -1)
            py = oy[:, None] + gy.reshape(1, -1)
            live = contributes(x, y, ca, cb, cc, op, px, py).any(1)
            # the kernels' box test (stream_common.cuh:box_hits) against
            # the block's centre and half extents
            cx, ex = 0.5 * (px.amin(1) + px.amax(1)), 0.5 * (px.amax(1)
                                                           - px.amin(1))
            cy, ey = 0.5 * (py.amin(1) + py.amax(1)), 0.5 * (py.amax(1)
                                                           - py.amin(1))
            hit = (((x - cx).abs() - hx <= ex)
                   & ((y - cy).abs() - hy <= ey))
            bad = live & ~hit
            assert not bool(bad.any()), (
                f"block ({bx}, {by}) culls contributing entries "
                f"{ent[bad][:5].tolist()}")
            culled += int((~hit).sum())
            pairs += len(hit)
    return culled, pairs


def stream_entries(s):
    """(entries [E, 6], tile origins) of a ``random_stream``."""
    cols = np.concatenate([np.arange(st, st + c) for st, c in
                           zip(s["seg_start"], s["counts"])])
    tile = np.repeat(s["tile_ids"], s["counts"])
    ent = s["attrs"][:6, cols].T
    ox = (tile % s["tiles_x"]) * s["tile_w"]
    oy = (tile // s["tiles_x"]) * s["tile_h"]
    return ent, ox, oy


@pytest.mark.parametrize("geometry", [(16, 16), (32, 16), (24, 10)])
@pytest.mark.parametrize("far", [0.0, 0.5])
def test_no_contributing_block_culled(geometry, far):
    tw, th = geometry
    s = random_stream(7, tiles_x=5, tiles_y=4, tile_w=tw, tile_h=th,
                      long_len=500, far=far)
    ent, ox, oy = stream_entries(s)
    rng = np.random.RandomState(8)
    # a fifth of the entries far past the clamp (op e^power > 0.99 over a
    # wide core)
    pick = rng.rand(len(ent)) < 0.2
    ent[pick, 5] = rng.uniform(1.0, 40.0, int(pick.sum()))
    culled, pairs = check(ent, ox, oy, tw, th)
    # the test means something: the box does cull
    assert culled > 0.1 * pairs


@pytest.mark.parametrize("geometry", [(16, 16), (24, 10)])
def test_padded_tables(geometry):
    """B5 stages a table's slots as B2 stages a stream's entries, an invalid
    slot with opacity 0 (``ops/composite.py:_stream_view`` lays the tables
    out so for the plain versions): no (slot, block) pair with a
    contributing pixel is culled, and an invalid slot has no box."""
    tw, th = geometry
    s = random_tables(7, tiles_x=4, tiles_y=3, tile_w=tw, tile_h=th, k=256)
    valid = torch.from_numpy(s["valid"])
    attrs, seg_start, counts = _stream_view(
        *(torch.from_numpy(s[key]) for key in ("planes", "rgb")), valid,
        torch.from_numpy(s["counts"]))
    tile = torch.repeat_interleave(torch.arange(len(counts)), counts.long())
    cols = torch.cat([torch.arange(int(st), int(st) + int(c))
                      for st, c in zip(seg_start, counts)])
    ent = attrs[:6, cols].T
    culled, pairs = check(ent, (tile % s["tiles_x"]) * tw,
                          (tile // s["tiles_x"]) * th, tw, th)
    assert culled > 0.1 * pairs
    invalid = valid.reshape(-1)[cols] == 0
    assert bool(invalid.any())
    hx, hy = cull_box(*ent[invalid, 2:6].T)
    assert bool((hx == -torch.inf).all()) and bool((hy == -torch.inf).all())


def grazing_entries(rng, n, tile_w, tile_h):
    """Entries whose alpha = 1/255 boundary passes within a pixel of a
    block edge of a tile at the origin, from round to rho = 0.999."""
    sx = rng.uniform(0.5, 30.0, n)
    sy = rng.uniform(0.5, 30.0, n)
    rho = rng.choice([0.0, 0.5, 0.9, 0.99, 0.998, 0.999], n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    ca, cb, cc = sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det
    op = rng.uniform(0.01, 0.99, n)
    big_l = np.log(255.0 * op)
    half_x = np.sqrt(2 * big_l * cc / (ca * cc - cb * cb))
    edge = rng.choice(np.arange(0, tile_w + 1, BLOCK_W), n)
    side = rng.choice([-1.0, 1.0], n)
    x = edge + side * (half_x + rng.uniform(-1.0, 1.0, n)) - 0.5
    y = rng.uniform(-5.0, tile_h + 5.0, n)
    return np.stack([x, y, ca, cb, cc, op], 1).astype(np.float32)


@pytest.mark.parametrize("geometry", [(16, 16), (32, 16)])
def test_grazing_boxes(geometry):
    tw, th = geometry
    rng = np.random.RandomState(9)
    ent = grazing_entries(rng, 4000, tw, th)
    zeros = np.zeros(len(ent))
    culled, pairs = check(ent, zeros, zeros, tw, th)
    assert 0 < culled < pairs


def test_pixel_on_the_boundary():
    """Entries whose alpha = 1/255 ellipse reaches its extreme x (or y) at a
    pixel centre on a block's edge, op stepped a few floats across
    op e^power = 1/255 there: where that pixel contributes, rounding in the
    box must not cull its block."""
    rng = np.random.RandomState(10)
    rows = []
    for _ in range(600):
        s = rng.uniform(0.7, 12.0)
        d = float(rng.randint(1, 13))
        op = np.float32(np.exp(d * d / (2 * s * s)) / 255.0)
        if not 1 / 255.0 < op < 1e4:
            continue
        for step in range(-4, 5):
            o = op
            for _ in range(abs(step)):
                o = np.nextafter(o, np.float32(np.sign(step) * np.inf))
            # pixel (8, 8) is the left / top edge of its 8x4 block; the
            # centre d to its left / above
            rows.append((8.0 - d, 8.0, 1 / s ** 2, 0.0, 1 / s ** 2, o))
            rows.append((8.0, 8.0 - d, 1 / s ** 2, 0.0, 1 / s ** 2, o))
    ent = np.array(rows, np.float32)
    zeros = np.zeros(len(ent))
    culled, pairs = check(ent, zeros, zeros, 16, 16)
    assert culled > 0


def test_opacity_at_the_threshold():
    """op one float below 1/255 has no box; one above, centred on a pixel
    (where it contributes, at power 0), keeps that pixel's block."""
    below = np.nextafter(MIN_ALPHA, np.float32(0))
    above = np.nextafter(MIN_ALPHA, np.float32(1))
    ent = np.array([[5.0, 2.0, 0.5, 0.0, 0.5, below],
                    [5.0, 2.0, 0.5, 0.0, 0.5, MIN_ALPHA],
                    [5.0, 2.0, 0.5, 0.0, 0.5, above],
                    [13.0, 7.0, 50.0, 10.0, 3.0, above]], np.float32)
    hx, hy = cull_box(*torch.from_numpy(ent[:, 2:]).unbind(1))
    assert float(hx[0]) == float(hy[0]) == -np.inf
    assert bool((hx[1:] >= 1.0).all()) and bool((hy[1:] >= 1.0).all())
    zeros = np.zeros(len(ent))
    check(ent, zeros, zeros, 16, 16)


def test_degenerate_conics_never_culled():
    """det <= 0, rho > 0.999, a or c <= 0 and non-finite conics get the
    whole plane; a NaN opacity gets none (it never contributes)."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    conics = [(1.0, 1.0, 1.0), (1.0, 2.0, 1.0), (1.0, 0.9995, 1.0),
              (0.0, 0.0, 1.0), (-1.0, 0.0, -1.0), (nan, 0.0, 1.0),
              (1.0, inf, 1.0), (inf, 0.0, 1.0), (1e-30, 0.0, 1e-30)]
    ent = np.array([(3.0, 3.0, *c, 0.5) for c in conics], np.float32)
    hx, hy = cull_box(*torch.from_numpy(ent[:, 2:]).unbind(1))
    assert bool(torch.isinf(hx).all()) and bool((hx > 0).all())
    assert bool(torch.isinf(hy).all()) and bool((hy > 0).all())
    zeros = np.zeros(len(ent))
    check(ent, zeros, zeros, 16, 16)
    hx, hy = cull_box(*torch.tensor([[1.0, 0.0, 1.0, np.nan]]).unbind(1))
    assert float(hx[0]) == -np.inf
