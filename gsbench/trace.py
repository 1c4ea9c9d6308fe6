"""Reading a ``torch.profiler`` chrome trace of the benchmark's window.

The window is one ``record_function`` range (:data:`WINDOW`) opened by the
benchmark. A device record (kernel, copy or fill) belongs to the window
when the host call that launched it, matched by correlation id, lies in
the window's host span; likewise it is credited to a program range
(``train_step/forward`` ...) when its launch lies in that range. The
window is opened after a burst of :data:`LEAD_FILLS` fills, since a
profiler window's first device records were seen to go missing from its
trace (the correlation crediting and the lead fills are copied from
``tools/measure.py``). Idle time is measured over the window's host
span, from its opening to the end of the synchronise that closes it.
"""

from __future__ import annotations

import bisect
import json
from typing import NamedTuple

WINDOW = "gsbench/window"
LEAD_FILLS = 256
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def launches_work(name: str) -> bool:
    """Whether a CUDA API call of this name puts work on the device."""
    return any(k in name for k in ("Launch", "Memcpy", "Memset"))


class Summary(NamedTuple):
    window_us: float          # the window's host span
    busy_us: float            # union of device records inside it
    launches: int             # launches made inside it
    missing: int              # of those, launches with no device record
    ops: list                 # [(name, ts, dur)] device records, launch order
    range_us: dict            # {program range: device us, None if missing}
    gaps: list                # [(host activity, us)] idle gaps, longest first


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events, cat: str):
    return [e for e in events if e.get("cat") == cat and "dur" in e]


def _union(intervals, lo: float, hi: float) -> tuple:
    """(covered length, gaps [(start, end)]) of intervals clipped to
    [lo, hi]."""
    covered, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            covered += e - max(s, cur)
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return covered, gaps


def _innermost(spans, ts: float):
    """Name of the latest-starting span holding ``ts`` (spans sorted by
    start), or None."""
    starts = [s["ts"] for s in spans]
    k = bisect.bisect_right(starts, ts) - 1
    best = None
    # walk back over earlier spans until one holds ts (nesting)
    for j in range(k, max(k - 64, -1), -1):
        s = spans[j]
        if s["ts"] <= ts <= s["ts"] + s["dur"]:
            best = s["name"]
            break
    return best


def summarize(events, ranges=()) -> Summary:
    """The window's figures; ``ranges`` names the program ranges whose
    device time is wanted."""
    notes = _spans(events, "user_annotation")
    win = [e for e in notes if e["name"] == WINDOW]
    if not win:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    lo = win[0]["ts"]
    hi = lo + win[0]["dur"]
    progs = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in notes
                   if e["name"] in ranges)
    starts = [r[0] for r in progs]

    def range_of(ts):
        k = bisect.bisect_right(starts, ts) - 1
        return progs[k][2] if k >= 0 and ts <= progs[k][1] else None

    launched, api = {}, set()
    for e in events:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})):
            api.add(e["args"]["correlation"])
            if launches_work(e.get("name", "")) and lo <= e["ts"] <= hi:
                launched[e["args"]["correlation"]] = range_of(e["ts"])
    ops, seen = [], set()
    totals = {r: 0.0 for r in ranges}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr not in api and lo <= e["ts"] <= hi:
            # a launch the trace holds no host call of: placed by its
            # device time
            launched[corr] = None
        if corr not in launched:
            continue
        seen.add(corr)
        ops.append((e["name"], e["ts"], e["dur"]))
        if launched[corr] is not None:
            totals[launched[corr]] += e["dur"]
    missing = {c for c in launched if c not in seen}
    for c in missing:
        if launched[c] is not None:
            totals[launched[c]] = None
    busy, gaps = _union([(t, t + d) for _, t, d in ops], lo, hi)
    host = sorted(_spans(events, "cpu_op") + notes, key=lambda e: e["ts"])
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        mid = 0.5 * (s + e)
        labelled.append((_innermost(host, mid) or "host: outside any op",
                         e - s))
    ops.sort(key=lambda o: o[1])
    return Summary(hi - lo, busy, len(launched), len(missing), ops,
                   {r: totals[r] for r in ranges}, labelled)


def top_ops(summary: Summary, k: int = 10) -> list:
    """[(name, seconds)] of the device operations that took most time."""
    by = {}
    for name, _, dur in summary.ops:
        by[name] = by.get(name, 0.0) + dur
    return [[n, us / 1e6] for n, us in
            sorted(by.items(), key=lambda x: x[1], reverse=True)[:k]]


def kernel_times(summary: Summary, match) -> list:
    """Durations (us) of the device records whose name ``match`` accepts,
    in launch order."""
    return [d for name, _, d in summary.ops if match(name)]
