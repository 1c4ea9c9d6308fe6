"""Pair, operation and byte counts on scenes small enough to count by
hand."""

import math

import pytest
import torch

from gsbench import work
from gsbench.reference import plain


def one(conic, opacity, rect_max=(4, 4)):
    t = torch.tensor([[4.0, 4.0, conic, 0.0, conic, opacity, 1, 1, 1]],
                     dtype=torch.float64)
    s = plain.Screen(t, torch.ones(1, dtype=torch.float64),
                     torch.zeros((1, 2), dtype=torch.long),
                     torch.tensor([rect_max]), torch.ones(1, dtype=torch.bool))
    lists = plain.tile_lists(s, 8, 8, 2, 2)
    return plain.render(s, lists, 8, 8, 2, 2,
                        torch.zeros(3, dtype=torch.float64), 1 << 12)


def by_hand(conic, opacity, x_tiles=4, y_tiles=4):
    n = 0
    for y in range(2 * y_tiles):
        for x in range(2 * x_tiles):
            power = -0.5 * conic * ((x - 4) ** 2 + (y - 4) ** 2)
            if min(0.99, opacity * math.exp(power)) >= 1 / 255:
                n += 1
    return n


@pytest.mark.parametrize("conic,opacity", [(0.5, 0.9), (2.0, 0.5),
                                           (0.1, 0.2)])
def test_contributing_pairs(conic, opacity):
    _, pairs, rows = one(conic, opacity)
    assert pairs == by_hand(conic, opacity)
    assert rows == (1 if pairs else 0)


def test_rect_cuts_pairs():
    _, pairs, _ = one(0.1, 0.9, rect_max=(2, 2))
    assert pairs == by_hand(0.1, 0.9, 2, 2)


def test_least_times():
    w = work.ViewWork(pairs=1_000_000, rows=10_000, pixels=100_000)
    ops = 1e6 * work.FWD_PAIR_OPS + 1e5 * work.FWD_PIXEL_OPS
    by = 1e4 * work.ROW_BYTES + 1e5 * work.FWD_PIXEL_BYTES
    assert work.composite_fwd_s(w) == pytest.approx(
        max(ops / 67e12, by / 3.35e12))
    bwd = work.composite_bwd_s(w)
    assert bwd == pytest.approx(max(
        (1e6 * work.BWD_PAIR_OPS_F32 + 1e5 * work.BWD_PIXEL_OPS) / 67e12
        + 1e6 * work.BWD_PAIR_OPS_SUM / 495e12,
        (1e4 * 72 + 1e5 * 32) / 3.35e12))
    # a view's training step holds its render
    assert work.train_flops(w, 20_000, 20_000 * 59) > \
        work.render_flops(w, 20_000) > 0
