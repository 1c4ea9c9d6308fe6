"""The tile shapes the port's composite kernels take, and the CLIs' refusal
of the others before any data is read.

The kernels run one thread per pixel, at most 1,024 pixels a tile, on
every device; the fast backward (B3b) keeps its pixel moments exact in TF32
only for sides up to 64, on a card. Within those limits every shape runs,
multiples of 32 pixels or not (the exact backwards B2 and B5 since their
redesign). The JAX package checks none of these (it has no such kernels):
``ops/stream.py:tile_limit`` names the port's limits, and ``cli/train.py``
and ``cli/render.py`` refuse a tile that breaks them right after parsing
their arguments; the ``jnp`` backend runs no kernel and takes any tile.
Also the tile order the kernels walk: ``ops/stream.py:check_order`` refuses
one they would read out of bounds.
"""

import pytest
import torch

from mvs_gaussian_splatting_tpu_torch.cli import render as render_cli
from mvs_gaussian_splatting_tpu_torch.cli import train as train_cli
from mvs_gaussian_splatting_tpu_torch.ops.stream import (check_order,
                                                         heaviest_first,
                                                         tile_limit)

torch.set_num_threads(1)


@pytest.mark.parametrize("cli,flags,refused", [
    ("train", ["--tile_w", "64", "--tile_h", "32", "--device", "cpu"],
     "at most 1024 a tile"),
    ("render", ["--tile_w", "64", "--tile_h", "32"], "at most 1024 a tile"),
    # fast math on a card: B3b's sides; refused before the card is touched
    ("train", ["--tile_w", "128", "--tile_h", "8", "--device", "cuda"],
     "sides of at most 64"),
    # taken: exact mode, the CPU's plain fast backward, the jnp backend
    ("train", ["--tile_w", "128", "--tile_h", "8", "--device", "cuda",
               "--no-fast_math"], None),
    ("train", ["--tile_w", "128", "--tile_h", "8", "--device", "cpu"], None),
    ("render", ["--tile_w", "64", "--tile_h", "32", "--backend", "jnp"],
     None),
])
def test_cli_tile_limits(cli, flags, refused, tmp_path, capsys):
    """A refused tile stops the CLI with its limit named, before the
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
    ((64, 32), False, "1024"),
    ((0, 16), False, "1024"),
    ((128, 8), True, "64"),
    ((128, 8), False, None),
    ((24, 10), True, None),    # not whole warps: fine
    ((8, 4), True, None),
    ((512, 2), False, None),   # row-order warps
])
def test_tile_limit(shape, fast, refused):
    why = tile_limit(*shape, fast)
    if refused is None:
        assert why is None
    else:
        assert why is not None and f"at most {refused}" in why


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
