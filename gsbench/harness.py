"""One run of one cell, end to end, and its result line.

``run_cell`` is what ``run.py`` calls on the card; the tests call it on the
CPU at a small size, with a cell built from small files and, for the
fault tests, a broken step or image underneath.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from . import bench, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "mvs_gaussian_splatting_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    that no run may load, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def cache_dirs(root=spec.ROOT) -> None:
    """Fixed cache directories inside the checkout, unless the caller set
    them. The kernels themselves build into the checkout's
    ``build/torch_kernels`` (``kernels.py``)."""
    base = os.path.join(root, "build", "gsbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def power_limit():
    """The card's power limit in watts from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
             device, t0: float, hooks=None) -> bench.Run:
    run = bench.Run(cell, seed, seconds, trace_on, device, t0, hooks)
    spec.module("drivers", cell.traffic["driver"]).run(run)
    return run


def checks(run: bench.Run) -> dict:
    """{name: {"value", "limit"}} of every compared number."""
    out = {}
    for name, value in run.checks.items():
        out[name] = {"value": value, "limit": run.cell.limits[name]}
    return out


def result(run: bench.Run, device_name: str, count: int, power=None) -> dict:
    """The result line's object."""
    cell = run.cell
    if run.trace_on:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.values[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": device_name, "count": count,
              "memory_peak_bytes": run.peak_bytes,
              "power_limit_w": power}
    out = {"correct": None, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace_on and run.summary is not None:
        s = run.summary
        device["busy_s"] = s.busy_us / 1e6
        device["window_s"] = s.window_us / 1e6
        from .trace import top_ops
        out["breakdown"] = {"device_ops": top_ops(s),
                            "idle_gaps": [[n, us / 1e6] for n, us in s.gaps]}
    cmp = checks(run)
    out["correct"] = all(c["value"] <= c["limit"] for c in cmp.values())
    out["checks"] = cmp
    return out


def report(out: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
