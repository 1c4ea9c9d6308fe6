"""The pack backward's row scatter and its alternatives, timed on the card.

Counterpart of the JAX repository's ``exp_scatter.py``, ``exp_scatter2.py``
and ``exp_scatter3.py``. The backward of the port's instance gather
(``ops/rasterize.py:_GatherInstRows``) adds CAP rows of 16 floats into an
``[N, 16]`` table with one colliding ``index_add_``. The JAX package
splits that scatter into target buckets (``_bucketed_scatter_add``,
``_widened_scatter_add``) because the TPU's scatter ran six times slower a
row once its target outgrew on-chip memory. This module asks the same of
the card, whose 50 MB L2 takes that memory's place (an ``[N, 16]`` f32
target crosses it at about 820,000 rows)::

    python -m mvs_gaussian_splatting_tpu_torch.tools.exp_scatter
        [--workload 1080p|bicycle] [--iters N] [--device cpu]

Shapes (``SHAPES``, the JAX scripts' own): bicycle, 500,000 target rows
and CAP 2,146,432; 1080p, 200,000 and 851,968; width 16; the row ids drawn
uniformly with ``numpy.random.RandomState(0)``, as there.

Sections (the JAX lines they answer):

- variants (``exp_scatter.py:45-125``, its (e) being the 1080p shape):
  (a) the port's colliding ``index_add_``; (a') the same under
  ``torch.use_deterministic_algorithms(True)``, the path of the repeatable
  exact steps; (b) a permutation scatter into ``max(CAP, N)`` rows; (c) a
  sort, a row gather and a segment sum by cumsum difference; (d) a row
  gather of 2·CAP rows; (f) the scatter in two halves; the K-pass bucketed
  and the widened single-pass forms at K = 2, 3, 4
  (``exp_scatter2.py:73-91``, ``exp_scatter3.py:47-70``), written here in
  torch as experiments; a bf16 accumulator (``exp_scatter2.py:93-99``);
  the cumsum of (c) alone, attribute-major and along the rows of
  ``[CAP, 16]`` as the JAX script lays it out (one call: it is slow).
- sweeps (bicycle only; ``exp_scatter2.py:51-71``): the colliding scatter
  of the CAP rows into targets of 125,000 to 4,000,000 rows at width 16 (8
  to 256 MB, across the L2), each drawn anew in its range, and into
  500,000 rows at widths 8, 9, 12 and 16.

Checks: every scatter is within ``REL`` (1e-6) of its largest magnitude
from the same sum taken in float64 on the device; the cumsum-difference
forms, lossy by construction (a running f32 sum of CAP rows loses the
small segments' low bits), within ``CUMSUM_REL``; the permutation scatter
places every row exactly; the bf16 accumulator's error is reported only.
Timing as ``tools/exp_binning.py``'s: each item's CUDA-event span and its
summed device time, a call, beside ns a row of each.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from . import measure

SHAPES = {"1080p": (200_000, 851_968), "bicycle": (500_000, 2_146_432)}
WIDTH = 16
SWEEP_ROWS = (125_000, 250_000, 500_000, 750_000, 1_000_000, 1_500_000,
              2_000_000, 3_000_000, 4_000_000)
SWEEP_WIDTHS = (8, 9, 12, 16)
SWEEP_AT = "bicycle"
KS = (2, 3, 4)
REL = 1e-6                 # a scatter against its float64 sum, of scale
# the cumsum-difference forms against the float64 sum, of scale: a running
# f32 sum over CAP rows keeps ~24 bits of a total of ~CAP/2, so a small
# segment's difference carries an error of a few of the total's ulps
# (measured on the card at both shapes: see PERF.md, "Floors on the card")
CUMSUM_REL = 5e-2


@contextlib.contextmanager
def deterministic():
    """The block under ``torch.use_deterministic_algorithms(True)``
    (``index_add_`` sorts its rows instead of adding with atomics), with
    uninitialised memory left as it is, as the repeatable exact steps run
    it."""
    import torch.utils.deterministic as tdet
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = tdet.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    tdet.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)
        tdet.fill_uninitialized_memory = fill


def colliding(rows, idx, n: int):
    """(a) ``rows`` [M, W] summed into [n, W] at ``idx`` by one
    ``index_add_``: ``_GatherInstRows.backward``'s scatter."""
    return rows.new_zeros((n, rows.shape[1])).index_add_(0, idx, rows)


def colliding_deterministic(rows, idx, n: int):
    """(a') :func:`colliding` under deterministic algorithms."""
    with deterministic():
        return colliding(rows, idx, n)


def permutation(rows, perm, n_out: int):
    """(b) every row to its own slot of [n_out, W]."""
    return rows.new_zeros((n_out, rows.shape[1])).index_copy_(0, perm, rows)


def sort_segment_sum(rows, idx, n: int):
    """(c) the sum by a sort of the ids, a row gather, and
    :func:`segment_sum_presorted`."""
    sid, order = torch.sort(idx)
    return segment_sum_presorted(rows[order], sid, n)


def segment_sum_presorted(rows_sorted, sid, n: int):
    """The sum of rows already in target order (``sid`` ascending): a
    cumsum over the rows and its difference at each target's segment
    ends. The cumsum runs attribute-major (``[W, M]``, the layout the
    pack's gradient arrives in); along the rows of ``[M, W]``
    (:func:`cumsum_rows`) it is hundreds of times slower on the card."""
    cs = torch.cumsum(rows_sorted.T.contiguous(), 1)
    csz = torch.cat([cs.new_zeros((cs.shape[0], 1)), cs], 1)
    target = torch.arange(n, dtype=sid.dtype, device=sid.device)
    ends = torch.searchsorted(sid, target, right=True)
    starts = torch.searchsorted(sid, target)
    return (csz[:, ends] - csz[:, starts]).T


def cumsum_rows(rows):
    """The cumsum of (c) as the JAX script lays it out: along the rows of
    ``[M, W]``."""
    return torch.cumsum(rows, 0)


def row_gather(rows, gidx):
    """(d) a row gather."""
    return rows[gidx]


def half_scatters(rows, idx, n: int):
    """(f) the colliding scatter in two halves of the rows."""
    h = rows.shape[0] // 2
    out = colliding(rows[:h], idx[:h], n)
    return out.index_add_(0, idx[h:], rows[h:])


def bucketed(rows, idx, n: int, k: int):
    """The JAX package's K-pass form: pass j adds the rows whose target
    lies in bucket j (of ceil(n / k) rows) into that bucket, the rest into
    a dump row."""
    b = -(-n // k)
    outs = []
    for j in range(k):
        local = idx - j * b
        inb = (local >= 0) & (local < b)
        acc = colliding(torch.where(inb[:, None], rows, 0.0),
                        torch.where(inb, local, b), b + 1)
        outs.append(acc[:b])
    return torch.cat(outs)[:n]


def widened(rows, idx, n: int, k: int):
    """The JAX package's single widened pass: each row goes to column block
    ``idx // b`` of a [b, K·W] accumulator at row ``idx mod b``, then the
    K blocks are stacked into [n, W]."""
    w = rows.shape[1]
    b = -(-n // k)
    bucket = torch.div(idx, b, rounding_mode="floor")
    onehot = (bucket[:, None] == torch.arange(k, device=idx.device)[None, :]
              ).to(rows.dtype)
    wide = (onehot[:, :, None] * rows[:, None, :]).reshape(rows.shape[0],
                                                           k * w)
    acc = colliding(wide, idx - bucket * b, b)
    return acc.reshape(b, k, w).transpose(0, 1).reshape(k * b, w)[:n]


def bf16_accumulator(rows, idx, n: int):
    """The colliding scatter into a bf16 table (a measurement only)."""
    return colliding(rows.to(torch.bfloat16), idx, n)


def rel_err(got, want) -> float:
    """max |got − want| / max |want| (want in float64)."""
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    return err / scale if scale > 0 else err


def inputs(n: int, cap: int, width: int, device, seed: int = 0):
    """(rows [CAP, W] uniform in [0, 1), row ids [CAP] in [0, n), a
    permutation's first CAP entries, gather ids [2·CAP] in [0, CAP)) from
    ``RandomState(seed)``, in the JAX script's order."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, size=cap)
    rows = rng.rand(cap, width).astype(np.float32)
    perm = rng.permutation(max(cap, n))[:cap]
    gidx = rng.randint(0, cap, size=2 * cap)

    def t(a):
        return torch.as_tensor(a, device=device)
    return t(rows), t(idx.astype(np.int64)), t(perm.astype(np.int64)), \
        t(gidx.astype(np.int64))


def timed(times, name, rows: int) -> dict:
    """``times[name]`` with ns a row of its event and device times."""
    rec = dict(times[name])
    rec["ns_per_row"] = rec["ms"] * 1e6 / rows
    rec["device_ns_per_row"] = (None if rec["device_ms"] is None
                                else rec["device_ms"] * 1e6 / rows)
    return rec


def run(workload: str = "bicycle", iters: int = 10, device="cuda",
        n: int = 0, cap: int = 0, sweep_rows=None,
        sweep_widths=None) -> dict:
    """The experiment's JSON record. ``n``/``cap`` (0: the shape's) and the
    sweeps (None: ``SWEEP_ROWS`` and ``SWEEP_WIDTHS`` at bicycle, none at
    1080p) shrink it for tests."""
    device = torch.device(device)
    n0, cap0 = SHAPES[workload]
    n, cap = n or n0, cap or cap0
    at = workload == SWEEP_AT
    sweep_rows = tuple(SWEEP_ROWS if at else ()) if sweep_rows is None \
        else tuple(sweep_rows)
    sweep_widths = tuple(SWEEP_WIDTHS if at else ()) \
        if sweep_widths is None else tuple(sweep_widths)
    rows, idx, perm, gidx = inputs(n, cap, WIDTH, device)
    ref = colliding(rows.double(), idx, n)
    n_out = max(cap, n)
    items = {
        "a_colliding": (lambda: colliding(rows, idx, n), REL),
        "a_deterministic": (lambda: colliding_deterministic(rows, idx, n),
                            REL),
        "b_permutation": (lambda: permutation(rows, perm, n_out), None),
        "c_sort_segment_sum": (lambda: sort_segment_sum(rows, idx, n),
                               CUMSUM_REL),
        "d_row_gather_2cap": (lambda: row_gather(rows, gidx), None),
        "f_half_scatters": (lambda: half_scatters(rows, idx, n), REL),
        "bf16_accumulator": (lambda: bf16_accumulator(rows, idx, n), None),
    }
    for k in KS:
        items[f"bucketed_k{k}"] = (lambda k=k: bucketed(rows, idx, n, k),
                                   REL)
        items[f"widened_k{k}"] = (lambda k=k: widened(rows, idx, n, k), REL)
    times = measure.stage_times({k: v[0] for k, v in items.items()}, iters,
                                device)
    # the row-major cumsum takes ~0.35 us a row on the card: timed once
    times.update(measure.stage_times(
        {"cumsum_rows_dim0": lambda: cumsum_rows(rows),
         "cumsum_attribute_major": lambda: torch.cumsum(rows.T.contiguous(),
                                                        1)}, 1, device))
    items["cumsum_rows_dim0"] = items["cumsum_attribute_major"] = \
        (None, None)
    variants, checks = {}, {}
    for name, (fn, tol) in items.items():
        rec = timed(times, name, 2 * cap if name.startswith("d_") else cap)
        if fn is None:
            variants[name] = rec
            continue
        out = fn()
        if name == "b_permutation":
            checks[name] = bool(torch.equal(out[perm], rows))
        elif name.startswith("d_"):
            checks[name] = bool(torch.equal(out, rows.index_select(0, gidx)))
        else:
            rec["rel_err"] = rel_err(out, ref)
            if tol is not None:
                checks[name] = rec["rel_err"] <= tol
        variants[name] = rec
    del ref

    sweep = []
    rng = np.random.RandomState(1)
    for n_t in sweep_rows:
        ix = torch.as_tensor(rng.randint(0, n_t, size=cap).astype(np.int64),
                             device=device)
        rec = timed(measure.stage_times(
            {"s": lambda: colliding(rows, ix, n_t)}, iters, device), "s", cap)
        rec.update(rows=n_t, mb=n_t * WIDTH * 4 / 1e6,
                   rel_err=rel_err(colliding(rows, ix, n_t),
                                   colliding(rows.double(), ix, n_t)))
        checks[f"sweep_rows_{n_t}"] = rec["rel_err"] <= REL
        sweep.append(rec)
    widths = []
    for w in sweep_widths:
        rw = rows[:, :w].contiguous()
        rec = timed(measure.stage_times(
            {"s": lambda: colliding(rw, idx, n)}, iters, device), "s", cap)
        rec.update(width=w, mb=n * w * 4 / 1e6,
                   rel_err=rel_err(colliding(rw, idx, n),
                                   colliding(rw.double(), idx, n)))
        checks[f"sweep_width_{w}"] = rec["rel_err"] <= REL
        widths.append(rec)
    return {
        "experiment": "exp_scatter",
        "workload": f"{workload}: N={n}, CAP={cap}, width {WIDTH}",
        "device": measure.device_name(device),
        "card": measure.card() if device.type == "cuda" else None,
        "clock": (("CUDA events" if device.type == "cuda" else "host")
                  + f", mean of {iters} after a warm-up; device_ms from "
                  "torch.profiler over as many calls"),
        "target_mb": n * WIDTH * 4 / 1e6,
        "tolerances": {"rel": REL, "cumsum_rel": CUMSUM_REL},
        "variants": variants,
        "sweep_rows": sweep,
        "sweep_widths": widths,
        "checks": checks,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=sorted(SHAPES), default="bicycle")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    result = run(args.workload, args.iters,
                 measure.checked_device(args.device))
    print(json.dumps(result), flush=True)
    if not all(result["checks"].values()):
        sys.exit(f"exp_scatter: checks failed: {result['checks']}")
    return result


if __name__ == "__main__":
    main()
