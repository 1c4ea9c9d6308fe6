"""Full training checkpoints: parameters, Adam moments, statistics, step.

Port of the JAX package's ``train/checkpoint.py`` with the same ``.npz``
layout (``params.<field>``, ``mu.<field>``, ``nu.<field>``, ``aux.<field>``,
``adam.count`` and a JSON ``__meta__``), so a checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ..models.gaussians import (GaussianAux, GaussianParams, aux_from_numpy,
                                params_from_numpy, to_numpy)
from .optim import AdamState, adam_from_numpy


def save_checkpoint(path: str, params: GaussianParams, adam: AdamState,
                    aux: GaussianAux, iteration: int,
                    active_sh_degree: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for prefix, tree in (("params", params), ("mu", adam.mu),
                         ("nu", adam.nu), ("aux", aux)):
        for name, arr in to_numpy(tree).items():
            arrays[f"{prefix}.{name}"] = arr
    arrays["adam.count"] = np.asarray(int(adam.count), np.int32)
    meta = {"iteration": iteration, "active_sh_degree": active_sh_degree,
            "capacity": int(params.xyz.shape[0])}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(path: str, device="cuda") -> Tuple[
        GaussianParams, AdamState, GaussianAux, int, int]:
    """(params, adam, aux, iteration, active_sh_degree) on ``device``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))

        def group(prefix, fields):
            return {f: data[f"{prefix}.{f}"] for f in fields
                    if f"{prefix}.{f}" in data}

        params = params_from_numpy(group("params", GaussianParams._fields),
                                   device)
        adam = adam_from_numpy(data["adam.count"],
                               group("mu", GaussianParams._fields),
                               group("nu", GaussianParams._fields), device)
        aux = aux_from_numpy(group("aux", GaussianAux._fields), device)
    return params, adam, aux, meta["iteration"], meta["active_sh_degree"]
