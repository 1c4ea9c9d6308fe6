"""Cells of the benchmark at a size the CPU runs in seconds: the real
configuration, traffic and limit files with their sizes cut."""

from __future__ import annotations

import copy

from gsbench import spec

SIZES = {"n_gaussians": 4000, "width": 96, "height": 64, "n_cameras": 12,
         "test_every": 4}
TRAFFIC = {"trace_steps": 4, "work_views": 2, "max_window_steps": 400,
           "poses": 8, "trace_views": 4, "check_views": 3,
           "slot_limit": 1 << 20}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(SIZES)
    cfg["reference"] = {"block_elems": 1 << 16}
    cfg["pipeline"]["spec_capacity"] = 64
    traffic = {k: TRAFFIC.get(k, v) for k, v in cell.traffic.items()}
    return cell._replace(config=cfg, traffic=traffic)
