"""Timing helpers of the tools: host time of a synchronised burst, device
time by CUDA events, the device's busy share from ``torch.profiler``
traces and each named stage's device time from one, and the card's name
and power limit (``chip_smoke.py``,
``profile_kernels.py`` and ``ref_scale_validation.py`` read the last two
here too).

A time taken on the CPU is the CPU's: the tools label every result with
the device it ran on, and the device-only figures (event times, busy
share, power limit) are None there.
"""

from __future__ import annotations

import bisect
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


RANGE_PREFIX = "stage:"
PROFILER_LEAD_FILLS = 256


def stage_times(stages, iters: int, device: torch.device, warmup: int = 1):
    """``{name: {"ms", "device_ms"}}`` of each zero-argument callable of the
    dict ``stages``. ``ms`` is :func:`event_ms` over ``iters`` calls after
    ``warmup``; ``device_ms`` the summed duration of the device events that
    ``iters`` more calls launched, from one ``torch.profiler`` window over
    every stage (:func:`range_device_ms`), a mean per call. Where the host
    enqueues slower than the card runs, the event span holds the host's gaps
    and the device time does not. ``device_ms`` is None on the CPU."""
    out = {name: {"ms": event_ms(fn, iters, device, warmup)}
           for name, fn in stages.items()}
    dev = range_device_ms(stages, iters, device)
    for name, rec in out.items():
        rec["device_ms"] = None if dev is None else dev[name]
    return out


def range_device_ms(stages, iters: int, device: torch.device):
    """``{name: device ms per call}``: every stage's ``iters`` calls inside
    a ``record_function`` range of its own, all under one profiler window,
    and each device event credited to the range whose host call launched it
    (:func:`device_ms_by_range`). None on the CPU, and for a stage of which
    some launch has no device record in the trace."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile, record_function
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # A window's first device records were seen to go missing from its
        # trace (one of them in a fresh process, 37-51 in one that had
        # profiled for minutes): a burst of fills outside every range takes
        # their place.
        for _ in range(PROFILER_LEAD_FILLS):
            torch.zeros(1, device=device)
        sync(device)
        for name, fn in stages.items():
            with record_function(RANGE_PREFIX + name):
                for _ in range(iters):
                    fn()
            sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events, _ = trace_events(path)
    finally:
        os.remove(path)
    totals = device_ms_by_range(events)
    return {name: None if totals.get(name) is None else totals[name] / iters
            for name in stages}


def _launches(name: str) -> bool:
    """Whether a CUDA API call of this name puts work on the device (a
    kernel, a copy or a fill)."""
    return any(k in name for k in ("Launch", "Memcpy", "Memset"))


def device_ms_by_range(events):
    """Device milliseconds a ``record_function`` range (named with
    ``RANGE_PREFIX``) launched, from a chrome trace's events: a kernel,
    copy or fill is matched by correlation id to the CUDA API call that
    launched it, and credited to the range whose host span holds that
    call. A range some of whose launches have no device record in the trace
    is None."""
    cut = len(RANGE_PREFIX)
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][cut:])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(RANGE_PREFIX))
    starts = [r[0] for r in ranges]

    def range_of(ts):
        k = bisect.bisect_right(starts, ts) - 1
        return ranges[k][2] if k >= 0 and ts <= ranges[k][1] else None
    launched = {}
    for e in events:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and _launches(e.get("name", ""))):
            launched[e["args"]["correlation"]] = range_of(e["ts"])
    totals = {r[2]: 0.0 for r in ranges}
    recorded = set()
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        corr = e.get("args", {}).get("correlation")
        name = launched.get(corr)
        if name is not None:
            totals[name] += e["dur"] / 1e3
            recorded.add(corr)
    for corr, name in launched.items():
        if name is not None and corr not in recorded:
            totals[name] = None
    return totals


def checked_device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device on a machine without a
    card exits non-zero, since a measurement never falls back to the
    CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA card for --device {name}; "
                         "pass --device cpu to run on the CPU")
    return device


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
