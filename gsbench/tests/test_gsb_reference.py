"""The plain reference against hand-worked cases."""

import math

import pytest
import torch

from gsbench.reference import plain, step


def screen_of(rows, depth, rect_min, rect_max):
    t = torch.tensor(rows, dtype=torch.float64)
    n = t.shape[0]
    return plain.Screen(t, torch.tensor(depth, dtype=torch.float64),
                        torch.tensor(rect_min).reshape(n, 2),
                        torch.tensor(rect_max).reshape(n, 2),
                        torch.ones(n, dtype=torch.bool))


def render(screen, w=4, h=4, tw=2, th=2, bg=(0.1, 0.2, 0.3), block=1 << 12):
    lists = plain.tile_lists(screen, w, h, tw, th)
    return plain.render(screen, lists, w, h, tw, th,
                        torch.tensor(bg, dtype=torch.float64), block)


def test_one_gaussian_by_hand():
    # isotropic conic 0.5 at pixel (1, 1): power at (x, y) = -0.25 r²
    s = screen_of([[1.0, 1.0, 0.5, 0.0, 0.5, 0.8, 1.0, 0.5, 0.0]], [2.0],
                  [0, 0], [2, 2])
    img, pairs, rows = render(s)
    bg = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    for (x, y) in [(1, 1), (0, 1), (3, 3)]:
        a = min(0.99, 0.8 * math.exp(-0.25 * ((x - 1) ** 2 + (y - 1) ** 2)))
        want = torch.tensor([1.0, 0.5, 0.0], dtype=torch.float64) * a \
            + (1 - a) * bg
        assert torch.allclose(img[:, y, x], want, atol=1e-12)
    # every pixel of the rect's 4×4 block has alpha >= 1/255 here
    assert pairs == 16 and rows == 1


def test_tile_rect_limits_reach():
    # the same Gaussian with a rect of one tile reaches its 4 pixels only
    s = screen_of([[1.0, 1.0, 0.5, 0.0, 0.5, 0.8, 1.0, 0.5, 0.0]], [2.0],
                  [0, 0], [1, 1])
    img, pairs, _ = render(s)
    assert pairs == 4
    assert torch.allclose(img[:, 3, 3], torch.tensor(
        [0.1, 0.2, 0.3], dtype=torch.float64))


def test_skips_and_termination():
    # front Gaussian alpha 0.99 everywhere near, back one skipped once
    # T·(1 − α) < 1e-4: 0.01 · (1 − 0.99) = 1e-4 is not below, a third
    # entry ends the pixel and is left out
    flat = [0.0, 0.0, 0.0]            # conic 0: power 0, alpha = opacity
    rows = [[1.0, 1.0] + flat + [0.99, 1.0, 0.0, 0.0],
            [1.0, 1.0] + flat + [0.99, 0.0, 1.0, 0.0],
            [1.0, 1.0] + flat + [0.5, 0.0, 0.0, 1.0],
            [1.0, 1.0] + flat + [0.003, 1.0, 1.0, 1.0]]   # < 1/255: skipped
    s = screen_of(rows, [1.0, 2.0, 3.0, 0.5], [0, 0] * 4, [1, 1] * 4)
    img, pairs, rows_touched = render(s, w=2, h=2)
    want = torch.tensor([0.99, 0.01 * 0.99, 0.0], dtype=torch.float64) \
        + 0.01 * 0.01 * torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    assert torch.allclose(img[:, 0, 0], want, atol=1e-12)
    assert pairs == 2 * 4 and rows_touched == 2


@pytest.mark.parametrize("block", [512, 1 << 16])
def test_blocks_and_vjp_match_a_whole_composite(block):
    g = torch.Generator().manual_seed(3)
    n, w, h = 60, 24, 16
    xy = torch.rand((n, 2), generator=g, dtype=torch.float64) \
        * torch.tensor([w, h], dtype=torch.float64)
    conic = torch.stack([0.05 + 0.2 * torch.rand(n, generator=g,
                                                  dtype=torch.float64),
                         0.01 * torch.randn(n, generator=g,
                                            dtype=torch.float64),
                         0.05 + 0.2 * torch.rand(n, generator=g,
                                                  dtype=torch.float64)], 1)
    op = 0.2 + 0.7 * torch.rand((n, 1), generator=g, dtype=torch.float64)
    rgb = torch.rand((n, 3), generator=g, dtype=torch.float64)
    table = torch.cat([xy, conic, op, rgb], 1)
    rect_min = torch.zeros((n, 2), dtype=torch.long)
    rect_max = torch.tensor([[3, 2]] * n)
    depth = torch.rand(n, generator=g, dtype=torch.float64)
    s = plain.Screen(table, depth, rect_min, rect_max,
                     torch.ones(n, dtype=torch.bool))
    bg = torch.tensor([0.3, 0.2, 0.1], dtype=torch.float64)
    lists = plain.tile_lists(s, w, h, 8, 8)
    img, _, _ = plain.render(s, lists, w, h, 8, 8, bg, block)
    # one block holding every Gaussian in depth order, every tile
    order = torch.argsort(depth)
    leaf = table.clone().requires_grad_(True)
    tiles = torch.arange(6)
    rows = leaf[order][None].expand(6, n, 9)
    colour, _, _ = plain._composite_block(
        rows, torch.ones((6, n), dtype=torch.bool), tiles, 3, 8, 8, bg)
    whole = torch.zeros((3, h, w), dtype=torch.float64)
    plain._place(whole, colour.detach(), tiles, 3, 8, 8)
    assert torch.allclose(img, whole, atol=1e-12)
    g_img = torch.randn((3, h, w), generator=g, dtype=torch.float64)
    (want,) = torch.autograd.grad(
        colour, leaf, plain._pick(g_img, tiles, 3, 8, 8))
    got = plain.render_vjp(s, lists, w, h, 8, 8, bg, g_img, block)
    assert torch.allclose(got, want, atol=1e-10)


def test_loss_adam_and_schedule():
    img = torch.rand((3, 20, 20), dtype=torch.float64)
    assert float(plain.ssim(img, img)) == pytest.approx(1.0, abs=1e-12)
    assert float(plain.loss_fn(img, img, 0.2)) == pytest.approx(0.0,
                                                                abs=1e-12)
    opt = {"position_lr_init": 1.6e-4, "position_lr_final": 1.6e-6,
           "position_lr_max_steps": 30000, "feature_lr": 0.0025,
           "scaling_lr": 0.005, "rotation_lr": 0.001, "opacity_lr": 0.05,
           "growdirs_lr": 0.005}
    assert plain.xyz_lr(0, opt, 2.0) == pytest.approx(3.2e-4)
    assert plain.xyz_lr(30000, opt, 2.0) == pytest.approx(3.2e-6)
    assert plain.xyz_lr(15000, opt, 1.0) == pytest.approx(1.6e-5)
    p = {"opacity": torch.tensor([[1.0]], dtype=torch.float64)}
    g = {"opacity": torch.tensor([[0.5]], dtype=torch.float64)}
    z = {"opacity": torch.zeros((1, 1), dtype=torch.float64)}
    new_p, m, v = plain.adam(p, g, z, z, 1, 0, opt, 1.0)
    # first step: m̂ = g, v̂ = g², the step is lr·sign(g)
    assert float(new_p["opacity"]) == pytest.approx(1.0 - 0.05, abs=1e-12)
    assert float(m["opacity"]) == pytest.approx(0.05)
    assert float(v["opacity"]) == pytest.approx(0.00025)


def test_grow_set_selection_and_straight_through():
    n, s = 10, 3
    g = torch.Generator().manual_seed(0)
    p = {"xyz": torch.randn((n, 3), generator=g),
         "f_dc": torch.randn((n, 1, 3), generator=g),
         "f_rest": torch.randn((n, 15, 3), generator=g),
         "scaling": torch.randn((n, 3), generator=g),
         "rotation": torch.randn((n, 4), generator=g),
         "opacity": torch.randn((n, 1), generator=g),
         "dirs_prob": torch.randn((n, 8), generator=g).requires_grad_()}
    denom = torch.full((n,), 10.0)
    hot = torch.tensor([0, 1, 0, 1, 1, 0, 1, 0, 0, 0], dtype=torch.bool)
    accum = torch.where(hot, 1e-2, 1e-5)
    dirs = torch.eye(8, 3)
    setup = step.Setup({"densify_grad_threshold": 2e-4}, 16, 16,
                       torch.zeros(3), 1.0, 1 << 12, dirs, s)
    out, alive = step.grow_set(p, accum, denom, setup)
    assert out["xyz"].shape == (n + 2 * s, 3)
    assert alive.tolist() == [True] * n + [True] * s + [False] * s
    # the first three hot rows, moved by their argmax direction × max scale
    for j, row in enumerate([1, 3, 4]):
        k = int(torch.argmax(p["dirs_prob"][row]))
        shift = float(torch.exp(p["scaling"][row]).max())
        assert torch.allclose(out["xyz"][n + j],
                              p["xyz"][row] + dirs[k] * shift)
    # the straight-through gradient is the softmax's
    out["xyz"][n:n + s].sum().backward()
    soft = torch.softmax(p["dirs_prob"][1].detach(), -1)
    up = dirs.sum(1) * float(torch.exp(p["scaling"][1]).max())
    want = soft * (up - (soft * up).sum())
    assert torch.allclose(p["dirs_prob"].grad[1], want, atol=1e-6)
    assert float(p["dirs_prob"].grad[0].abs().sum()) == 0.0
