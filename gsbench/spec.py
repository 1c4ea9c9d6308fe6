"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix; each is a file of its
own, found by name (``configs/<config>.json``, ``traffic/<mix>.json``),
and so are the cell's correctness limits (``limits/<cell>.json``), each
per-layer metric's reader (``metrics/<metric>.py``), the loop a traffic
file names (``drivers/<driver>.py``) and the capture shape a
configuration names (``captures/<capture>.py``). A later cell, mix,
loop, shape or metric is added with files and entries alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # metric entries the cell reports untraced
    per_layer: list       # metric entries the cell reports traced


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether a cell reports a metric: listed under the metric's
    ``workloads``, or, without that key, wherever the end-to-end metric it
    moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m, name, names)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def module(kind: str, name: str):
    """The module ``gsbench/<kind>/<name>.py``: a traffic file's
    ``driver`` (kind ``drivers``) or a configuration's ``capture`` (kind
    ``captures``)."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"gsbench.{kind}.{name}")


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    modspec = importlib.util.spec_from_file_location(
        "gsbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(modspec)
    modspec.loader.exec_module(mod)
    return mod.read
