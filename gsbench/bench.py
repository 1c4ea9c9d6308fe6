"""What every driver shares: one run of a cell and its measured window,
the numbers the correctness checks are made of, and the plumbing of the
seeded inputs into the program's types."""

from __future__ import annotations

import os
import statistics
import tempfile
import time

import torch

from . import trace
from .reference import step as ref

PORT_RANGES = ("train_step/forward", "train_step/backward",
               "train_step/update")
GIB = float(1 << 30)


class Run:
    """One run of a cell: its inputs, and what the driver measured."""

    def __init__(self, cell, seed: int, seconds: float, trace_on: bool,
                 device, t0: float, hooks=None):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace_on = trace_on
        self.device = torch.device(device)
        self.t0 = t0
        self.hooks = hooks or {}
        self.values = {}        # end-to-end metrics by name
        self.checks = {}        # compared numbers by name
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.summary = None     # trace.Summary of a traced window
        self.window_steps = 0
        self.window_s = 0.0
        self.work = []          # [(step in window, work.ViewWork)]
        self.n_rows = 0         # rows through the render per step
        self.n_params = 0
        self.grow_rows = 0
        self.counts = {}        # the program's counters over the window
        self.program = None     # what the timed path produced, as compared
        self.reference = None   # the same, from the plain reference
        self.readings = {}      # the compared numbers' ingredients

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def reset_peak(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def close_setup(self):
        self.sync()
        self.values["setup_s"] = time.perf_counter() - self.t0
        self.peak_bytes = self.peak()
        self.reset_peak()

    def window(self, body, fixed_steps: int):
        """Run ``body(k)`` for k = 0, 1, ... : ``fixed_steps`` calls under
        the profiler when tracing, else until ``seconds`` have passed.
        Returns (calls, seconds); the window ends in a synchronise."""
        if not self.trace_on:
            self.sync()
            t = time.perf_counter()
            k = 0
            while True:
                body(k)
                k += 1
                if time.perf_counter() - t >= self.seconds:
                    break
            self.sync()
            return k, time.perf_counter() - t
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        with profile(activities=acts) as prof:
            for _ in range(trace.LEAD_FILLS):
                torch.zeros(1, device=self.device)
            self.sync()
            with record_function(trace.WINDOW):
                t = time.perf_counter()
                for k in range(fixed_steps):
                    body(k)
                self.sync()
                dt = time.perf_counter() - t
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            self.summary = trace.summarize(trace.load(path), PORT_RANGES)
        finally:
            os.remove(path)
        return fixed_steps, dt

    def close_window(self, steps: int, secs: float):
        self.window_steps, self.window_s = steps, secs
        self.attempted = steps
        self.values["peak_mem_gib"] = self.peak() / GIB
        self.peak_bytes = max(self.peak_bytes, self.peak())


def gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def worst_leaf(prog: dict, refs: dict, keys, floor: bool = True) -> float:
    """Largest |‖prog‖ − ‖ref‖| over the leaves ``keys``, each against its
    reference norm or, with ``floor``, the larger of that and the median
    leaf's."""
    med = statistics.median(refs.values()) if floor else 0.0
    return max(abs(prog[k] - refs[k]) / max(refs[k], med, 1e-30)
               for k in keys)


def rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    d = a.float() - b.float().to(a.device)
    return float(torch.sqrt((d * d).mean()))


def background(cfg: dict, device) -> torch.Tensor:
    return (torch.ones(3, device=device) if cfg["white_background"]
            else torch.zeros(3, device=device))


def camera_views(views):
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView
    return [CameraView(v.viewmatrix, v.projmatrix, v.campos, v.tanfovx,
                       v.tanfovy) for v in views]


def tile_areas(params: dict, views, cfg: dict, device):
    """Per view, the sum of the visible rows' tile-rect areas (the most
    tile slots binning can fill), and per row the largest area over the
    views, by the program's own projection."""
    from mvs_gaussian_splatting_tpu_torch.ops.preprocess import preprocess
    pipe = cfg["pipeline"]
    sums = []
    need = torch.zeros(params["xyz"].shape[0], dtype=torch.int64,
                       device=device)
    with torch.no_grad():
        scales = torch.exp(params["scaling"])
        q = params["rotation"]
        quats = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                         keepdim=True),
                                min=1e-12)
        opac = torch.sigmoid(params["opacity"][:, 0])
        dummy = torch.zeros_like(params["xyz"])
        for v, cv in zip(views, camera_views(views)):
            p = preprocess(params["xyz"], opac, cv, v.width, v.height,
                           scales=scales, rotations=quats,
                           colors_precomp=dummy, tile_w=pipe["tile_w"],
                           tile_h=pipe["tile_h"])
            span = torch.clamp(p.rect_max - p.rect_min, min=0)
            area = torch.where(p.mask, span[:, 0] * span[:, 1], 0)
            sums.append(area.sum())
            need = torch.maximum(need, area)
    return [int(s) for s in torch.stack(sums).cpu()], need


def pipeline_config(cfg: dict):
    from mvs_gaussian_splatting_tpu_torch.train.config import PipelineConfig
    pipe = dict(cfg["pipeline"])
    for k in ("tier_budgets", "tier_fracs"):
        pipe[k] = tuple(pipe[k])
    return PipelineConfig(**pipe)


def ref_setup(cfg: dict, device, lr_scale: float = 0.0, sphere_dirs=None,
              spec: int = 0) -> ref.Setup:
    pipe = cfg["pipeline"]
    return ref.Setup(cfg["optimization"], pipe["tile_w"], pipe["tile_h"],
                     background(cfg, device), lr_scale,
                     cfg["reference"]["block_elems"], sphere_dirs, spec)
