"""Shared arithmetic of the per-layer readers: a kernel's share of its
roofline and a whole step's share of the card's float32 peak, from a
traced window and the reference's work counts of sampled steps."""

from __future__ import annotations

from . import trace, work


def kernel_share(run, match, least_s):
    """100 × Σ least time ÷ Σ device time of the kernel over the sampled
    steps (the k-th record the kernel's k-th call, one call a step), or
    None where the trace or the counts are incomplete."""
    if run.summary is None or run.summary.missing or not run.work:
        return None
    times = trace.kernel_times(run.summary, match)
    if len(times) != run.window_steps:
        return None
    least = sum(least_s(w) for _, w in run.work)
    spent = sum(times[j] for j, _ in run.work) / 1e6
    return 100.0 * least / spent if spent > 0 else None


def step_mfu(run, flops_of):
    """100 × mean operations of the sampled steps ÷ (seconds a step of
    the traced window × the float32 peak)."""
    if not run.work or not run.window_steps:
        return None
    flops = sum(flops_of(w) for _, w in run.work) / len(run.work)
    per_step = run.window_s / run.window_steps
    return 100.0 * flops / (per_step * work.F32_FLOPS)


def idle_pct(run):
    s = run.summary
    if s is None or s.missing or s.window_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)


def launches(run):
    s = run.summary
    if s is None or not run.window_steps:
        return None
    return s.launches / run.window_steps


def range_ms(run, name: str):
    s = run.summary
    if s is None or s.range_us.get(name) is None or not run.window_steps:
        return None
    return s.range_us[name] / 1e3 / run.window_steps


def fwd_kernel(fast: bool):
    """Matches the stream forward kernel ``fwd_kernel<StreamSlots, fast,
    parts>`` of ``csrc/fwd_body.cuh``: B3f when ``fast``, else B1."""
    flag = "true" if fast else "false"

    def match(name: str) -> bool:
        if "fwd_kernel<" not in name or "StreamSlots" not in name:
            return False
        args = name.split("StreamSlots", 1)[1].lstrip(", ")
        return args.startswith(flag)
    return match


def b3b(name: str) -> bool:
    return "stream_bwd_fast_kernel" in name
