"""The generalizable MVS→Gaussian branch (BASELINE config #4): the JAX
package's ``mvs/`` ported to PyTorch."""

from .dataset import (MVSGroup, MVSView, load_dtu_scan,  # noqa: F401
                      make_synthetic_groups)
from .homography import build_cost_volume, plane_sweep_warp  # noqa: F401
from .model import MVSGaussianModel  # noqa: F401
from .train import MVSConfig, train_mvs  # noqa: F401
