"""The tile shapes the port's composite kernels take, the part grid they walk
a large tile in, and the CLIs' refusal of an empty tile before any data is
read.

The kernels run one thread per pixel in one CTA per tile, at most 1,024
pixels a CTA; a tile that one CTA cannot cover (more pixels, or for the
fast backward B3b a side over 64, past which its pixel moments would not
be exact in TF32) is walked by its CTA as a grid of parts of at most 32×32
(``ops/stream.py:tile_parts``, the mirror of
``csrc/stream_common.cuh:tile_parts``). So every shape the JAX package
takes runs, on every device: ``ops/stream.py:tile_limit`` refuses only an
empty tile, and ``cli/train.py`` and ``cli/render.py`` refuse it right
after parsing their arguments. Also the tile order the kernels walk:
``ops/stream.py:check_order`` refuses one they would read out of bounds.
"""

import pytest
import torch

from mvs_gaussian_splatting_tpu_torch.cli import render as render_cli
from mvs_gaussian_splatting_tpu_torch.cli import train as train_cli
from mvs_gaussian_splatting_tpu_torch.ops.stream import (FAST_BWD_SIDE,
                                                         check_order,
                                                         heaviest_first,
                                                         tile_limit,
                                                         tile_parts)

torch.set_num_threads(1)


@pytest.mark.parametrize("cli,flags,refused", [
    ("train", ["--tile_w", "64", "--tile_h", "32", "--device", "cpu"],
     None),
    ("render", ["--tile_w", "64", "--tile_h", "32"], None),
    # fast math on a card: B3b walks the 128-wide tile in parts
    ("train", ["--tile_w", "128", "--tile_h", "8", "--device", "cuda"],
     None),
    ("train", ["--tile_w", "128", "--tile_h", "8", "--device", "cuda",
               "--no-fast_math"], None),
    ("train", ["--tile_w", "128", "--tile_h", "8", "--device", "cpu"], None),
    ("render", ["--tile_w", "64", "--tile_h", "32", "--backend", "jnp"],
     None),
    # an empty tile, on every backend and device
    ("train", ["--tile_w", "0", "--tile_h", "16", "--device", "cuda",
               "--backend", "pallas"], "is empty"),
    ("render", ["--tile_w", "16", "--tile_h", "0", "--backend", "jnp"],
     "is empty"),
])
def test_cli_tile_limits(cli, flags, refused, tmp_path, capsys):
    """A refused tile stops the CLI with its reason named, before the
    (missing) scene or model is read; a tile it takes gets as far as
    reading them, which raises FileNotFoundError (render) or ValueError
    (train: no scene type recognised)."""
    missing = str(tmp_path / "missing")
    argv = ["-m", missing, *flags]
    if cli == "train":
        argv = ["-s", missing, *argv]
    main = train_cli.main if cli == "train" else render_cli.main
    if refused is None:
        with pytest.raises((FileNotFoundError, ValueError)) as exc:
            main(argv)
        assert "missing" in str(exc.value)
        return
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"--tile_w {flags[1]} --tile_h {flags[3]}" in err
    assert refused in err


@pytest.mark.parametrize("shape,fast,refused", [
    ((64, 32), False, None),   # 2 parts
    ((0, 16), False, "is empty"),
    ((128, 8), True, None),    # B3b: 4 parts
    ((128, 8), False, None),
    ((24, 10), True, None),    # not whole warps: fine
    ((8, 4), True, None),
    ((512, 2), False, None),   # row-order warps
    ((-4, -4), False, "is empty"),
])
def test_tile_limit(shape, fast, refused):
    """Only an empty tile is refused, in either mode."""
    why = tile_limit(*shape)
    if refused is None:
        assert why is None
        side = FAST_BWD_SIDE if fast else 1024
        w, h, nx, ny = tile_parts(*shape, side)
        assert w * h <= 1024 and nx * w >= shape[0] and ny * h >= shape[1]
    else:
        assert why is not None and refused in why


@pytest.mark.parametrize("shape,side,want", [
    # within one CTA: the tile itself, whatever its warps' layout
    ((16, 16), 1024, (16, 16, 1, 1)),
    ((32, 16), 1024, (32, 16, 1, 1)),
    ((24, 10), 1024, (24, 10, 1, 1)),
    ((512, 2), 1024, (512, 2, 1, 1)),
    ((128, 8), 1024, (128, 8, 1, 1)),
    ((64, 16), FAST_BWD_SIDE, (64, 16, 1, 1)),
    # parts of at most 32 x 32, the last row and column cut to the tile
    ((64, 32), 1024, (32, 32, 2, 1)),
    ((48, 48), 1024, (32, 32, 2, 2)),
    ((33, 40), 1024, (32, 32, 2, 2)),
    ((2048, 1), 1024, (32, 1, 64, 1)),
    ((128, 8), FAST_BWD_SIDE, (32, 8, 4, 1)),
    ((8, 100), FAST_BWD_SIDE, (8, 32, 1, 4)),
])
def test_tile_parts(shape, side, want):
    """The part grid: its nominal part shape and count; every pixel of the
    tile lies in exactly one part, the parts at the right and bottom edges
    masked to the tile."""
    got = tile_parts(*shape, side)
    assert got == want
    w, h, nx, ny = got
    tw, th = shape
    cover = torch.zeros((th, tw), dtype=torch.int32)
    for i in range(nx * ny):
        x0, y0 = (i % nx) * w, (i // nx) * h
        pw, ph = min(w, tw - x0), min(h, th - y0)
        assert pw > 0 and ph > 0 and pw * ph <= 1024
        assert max(pw, ph) <= side
        cover[y0:y0 + ph, x0:x0 + pw] += 1
    assert bool((cover == 1).all())


@pytest.mark.parametrize("order,refused", [
    (None, False),                                   # heaviest_first
    (torch.arange(6), False),
    (torch.arange(6, dtype=torch.int32), True),      # not int64
    (torch.arange(5), True),                         # too short
    (torch.arange(12).reshape(2, 6), True),          # not one index a tile
])
def test_check_order(order, refused):
    counts = torch.tensor([3, 0, 7, 1, 7, 2], dtype=torch.int32)
    order = heaviest_first(counts) if order is None else order
    if refused:
        with pytest.raises(ValueError, match="int64 tile indices"):
            check_order(order, counts)
    else:
        check_order(order, counts)
