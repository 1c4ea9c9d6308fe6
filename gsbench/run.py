"""Run one cell of the port's benchmark once and print its result line.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits and metric readers are files under
``gsbench/``. The run makes its inputs on the card from the seed, builds
and warms up the program's step (set-up), measures for ``--seconds``
(``--trace 1``: a fixed number of steps under ``torch.profiler``), checks
what the timed path produced against the plain reference, prints each
compared number beside its limit as the last lines of standard error and
one JSON object as the last line of standard output. It exits non-zero,
printing no result, without a CUDA card, or if JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gsbench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the program: outside a checkout this fails, and nothing is printed
    import mvs_gaussian_splatting_tpu_torch  # noqa: F401
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded what no run may load: {bad}", file=sys.stderr)
        return 3
    out = harness.result(run, torch.cuda.get_device_name(0), cell.chips,
                         harness.power_limit())
    print(json.dumps(run.readings), file=sys.stderr)
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
