"""Timing helpers of the tools: host time of a synchronised burst, device
time by CUDA events, the device's busy share from ``torch.profiler``
traces, and the card's name and power limit (``chip_smoke.py``,
``profile_kernels.py`` and ``ref_scale_validation.py`` read the last two
here too).

A time taken on the CPU is the CPU's: the tools label every result with
the device it ran on, and the device-only figures (event times, busy
share, power limit) are None there.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, iters: int, device: torch.device, warmup: int = 1) -> float:
    """Mean host milliseconds of ``fn()`` over ``iters`` calls after
    ``warmup`` calls; the timed window ends in a device synchronise, so
    it measures the work, not its enqueue."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def event_ms(fn, iters: int, device: torch.device, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` by CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls; on the CPU, :func:`host_ms`."""
    if device.type != "cuda":
        return host_ms(fn, iters, device, warmup)
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / iters


def busy(fn, steps: int, device: torch.device):
    """``fn()`` ``steps`` times under ``torch.profiler``: the device
    milliseconds per step (kernels, copies and fills) and the busy share
    of the window from the first device event's start to the last one's
    end. None on the CPU, or where the trace holds no device event."""
    if device.type != "cuda":
        return {"device_ms_per_step": None, "busy_share": None}
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        _, dev = trace_events(path)
    finally:
        os.remove(path)
    if not dev:
        return {"device_ms_per_step": None, "busy_share": None}
    window, total = busy_window(dev)
    return {"device_ms_per_step": total / steps / 1e3,
            "busy_share": total / max(window, 1e-9)}


def trace_events(path):
    """(every event, the device's events) of a ``torch.profiler`` chrome
    trace; the device's are its kernels, copies and fills."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return events, [e for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_window(dev):
    """(window, busy) microseconds of device events: from the first one's
    start to the last one's end, and their summed durations."""
    start = min(e["ts"] for e in dev)
    end = max(e["ts"] + e["dur"] for e in dev)
    return end - start, sum(e["dur"] for e in dev)


def card():
    """``nvidia-smi``'s "name, power.limit" of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def peak_memory(device: torch.device):
    """``max_memory_allocated`` since the last reset; None on the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
