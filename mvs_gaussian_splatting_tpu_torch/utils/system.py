"""Host-side helpers: output dirs, RNG seeding, checkpoint discovery.

Copy of the JAX package's ``utils/system.py`` (itself replacing the
reference's utils/system_utils.py mkdir_p / searchForMaxIteration and the
seeding part of general_utils.safe_state).
"""

from __future__ import annotations

import errno
import os
import random

import numpy as np


def mkdir_p(path: str) -> None:
    try:
        os.makedirs(path)
    except OSError as exc:
        if exc.errno == errno.EEXIST and os.path.isdir(path):
            pass
        else:
            raise


def search_max_iteration(folder: str) -> int:
    """Largest N among entries named like 'iteration_N' in ``folder``."""
    saved = [int(fname.split("_")[-1]) for fname in os.listdir(folder)]
    return max(saved)


def seed_everything(seed: int = 0) -> None:
    """Seed the host RNGs (Python's and numpy's)."""
    random.seed(seed)
    np.random.seed(seed)
