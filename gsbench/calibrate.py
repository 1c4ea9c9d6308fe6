"""The readings that the correctness limits are set from, on the card.

    python3 gsbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control K] [--faults K] [--seconds S] [--out FILE]

For each seed, one run of the cell with a short window gives the program's
readings against the reference (the lower end of each limit). For the
first ``K`` seeds, ``--control`` puts the reference computed in bfloat16,
the nearest precision below the configuration's float32, in the
program's place, and ``--faults`` (training) puts there the reference with
the half-batch fault planted (the loss over the image's first half of
rows, the mean taken over them) and the program's own readings with the
densification statistics left unchanged. Each goes through the driver's
own ``judge`` and ``harness.result``, so ``correct`` itself has to come
out false. One JSON line per seed; the benchmark's own runs never run
this.
"""

import copy
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from gsbench import harness, scene, spec  # noqa: E402


def in_place(run, driver, readings) -> dict:
    """``harness.result``'s correct and checks with ``readings`` put in
    the program's place."""
    other = copy.copy(run)
    driver.judge(other, readings)
    out = harness.result(other, "", run.cell.chips)
    return {"correct": out["correct"],
            "checks": {k: c["value"] for k, c in out["checks"].items()}}


def controls(run, control: bool, faults: bool) -> dict:
    """The control's and the faults' results for one sound run."""
    cell, seed = run.cell, run.seed
    driver = spec.module("drivers", cell.traffic["driver"])
    cfg, tr, dev = cell.config, cell.traffic, run.device
    rec = {}
    if tr["driver"] == "train":
        order = run.readings["cameras"]
        if control:
            rec["control"] = in_place(run, driver, driver.follow_reference(
                cfg, tr, seed, order, dev, torch.bfloat16))
        if faults:
            rec["half_batch"] = in_place(run, driver, driver.follow_reference(
                cfg, tr, seed, order, dev, loss_rows=cfg["height"] // 2))
            if run.program.stats:
                rec["stats_unchanged"] = in_place(
                    run, driver, run.program._replace(
                        stats={k: 0.0 for k in run.program.stats}))
    elif control:
        orbit = scene.orbit_views(cfg, tr["poses"], dev)
        poses = sorted(run.reference)
        low = {p: img.cpu() for p, (img, _, _) in zip(
            poses, driver.reference_images(cfg, seed, orbit, poses, dev,
                                           torch.bfloat16))}
        rec["control"] = in_place(run, driver, low)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    harness.cache_dirs()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = harness.run_cell(cell, seed, args.seconds, False, "cuda", t)
        res = harness.result(run, "", cell.chips)
        rec = {"workload": cell.name, "seed": seed,
               "program": {"correct": res["correct"],
                           "checks": {k: c["value"] for k, c in
                                      res["checks"].items()}},
               "readings": run.readings, "values": run.values}
        rec.update(controls(run, i < args.control, i < args.faults))
        rec["seconds"] = time.perf_counter() - t
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del run
        torch.cuda.empty_cache()
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded what no run may load: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
