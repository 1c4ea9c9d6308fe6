"""A/B of the offline render's adaptive tile budgets on one trained model.

Counterpart of the JAX repository's ``scripts/adaptive_budget_ab.sh``:
train the specular flagship scene 5,000 iterations
(``ref_scale_validation.py``), then
render the same saved model's test views with the fixed tier ladder
(``cli/render.py --no-adaptive_budgets``) and with the budgets sized from
the measured tile needs (the default), score each with ``eval/metrics.py``,
and print both beside the loop's own evaluation::

    python -m mvs_gaussian_splatting_tpu_torch.tools.adaptive_budget_ab
        [--out runs/torch_specadapt] [--device cpu]

The fixed-tier metrics are kept as ``<out>/model/results_fixed_tiers.json``
and ``per_view_fixed_tiers.json``, the adaptive ones as ``results.json``
and ``per_view.json``.
"""

from __future__ import annotations

import argparse
import json
import os


ITERATIONS = 5000


def run(out: str, device: str = "cuda") -> dict:
    from .. import ref_scale_validation
    from ..cli import render
    from ..eval import metrics

    ref_scale_validation.main(["--out", out, "--scene_style", "specular",
                               "--iterations", str(ITERATIONS), "--device",
                               device])
    model = os.path.join(out, "model")
    print("=== offline render: fixed tiers ===", flush=True)
    render.main(["-m", model, "--skip_train", "--no-adaptive_budgets",
                 "--device", device])
    metrics.main(["-m", model, "--device", device])
    for name in ("results", "per_view"):
        os.replace(os.path.join(model, f"{name}.json"),
                   os.path.join(model, f"{name}_fixed_tiers.json"))
    print("=== offline render: adaptive budgets ===", flush=True)
    render.main(["-m", model, "--skip_train", "--device", device])
    metrics.main(["-m", model, "--device", device])
    with open(os.path.join(out, "history.json")) as f:
        loop_eval = json.load(f)["psnr_test"]
    result = {"loop_eval_psnr": loop_eval}
    for tag in ("results_fixed_tiers", "results"):
        with open(os.path.join(model, f"{tag}.json")) as f:
            result[tag] = json.load(f)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("runs", "torch_specadapt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    return run(args.out, args.device)


if __name__ == "__main__":
    main()
