"""Argparse wiring for the CLI drivers — the reference's flag surface
(arguments/__init__.py:47-108) mapped onto the typed dataclass configs."""

from __future__ import annotations

import argparse
import dataclasses

from ..train.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                            TrainRunConfig)

_SHORTHAND = {"source_path": "-s", "model_path": "-m", "images": "-i",
              "resolution": "-r", "white_background": "-w"}


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = "",
                       sentinel: bool = False):
    """sentinel=True parses with None defaults so a caller can distinguish
    'user passed this flag' from 'dataclass default' (the reference's
    ModelParams(sentinel) pattern used by render.py/get_combined_args)."""
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        flags = [name]
        if f.name in _SHORTHAND:
            flags.append(_SHORTHAND[f.name])
        default = f.default if f.default is not dataclasses.MISSING else None
        if sentinel:
            default = None
        if f.type in ("bool", bool):
            parser.add_argument(*flags, action="store_true",
                                default=None if sentinel else bool(default))
        elif f.type in ("List[int]", "list"):
            parser.add_argument(*flags, nargs="+", type=int,
                                default=None if sentinel
                                else list(f.default_factory()))
        else:
            t = {"int": int, "float": float, "str": str}.get(
                f.type if isinstance(f.type, str) else f.type.__name__, str)
            parser.add_argument(*flags, type=t, default=default)


def merge_with_saved(cls, args: argparse.Namespace, saved):
    """CLI value if explicitly passed (non-None), else saved config value,
    else the dataclass default."""
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(args, f.name, None)
        if v is None:
            v = getattr(saved, f.name) if saved is not None else (
                f.default if f.default is not dataclasses.MISSING
                else f.default_factory())
        out[f.name] = v
    return cls(**out)


def extract(cls, args: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


def build_parser(description: str, *, optimization: bool = True,
                 run: bool = True) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    add_dataclass_args(parser, ModelConfig)
    add_dataclass_args(parser, PipelineConfig)
    if optimization:
        add_dataclass_args(parser, OptimizationConfig)
    if run:
        add_dataclass_args(parser, TrainRunConfig)
    return parser
