"""mvs_gaussian_splatting_tpu_torch — the PyTorch + CUDA port of
``mvs_gaussian_splatting_tpu``, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; each ported function is
held against it by the tests under ``tests/test_torch_*.py``. This package
imports neither JAX nor the JAX package.

Ported so far: the serving path (``cli/render.py`` → ``ops/render.py`` →
``ops/preprocess.py`` → ``ops/rasterize.py`` stream path →
``ops/binning.py`` → ``ops/stream.py``), whose compositing kernel is the
hand-written CUDA source ``csrc/stream_fwd.cu``; single-device training
(``cli/train.py`` → ``train/loop.py`` → ``train/step.py``) in the default
fast-math mode (``csrc/stream_fwd.cu``'s fast instantiation and
``csrc/stream_bwd_fast.cu``) or in exact mode (``--no-fast_math``:
``csrc/stream_bwd.cu``); and the padded-table backend (``--backend
pallas``: ``csrc/padded_fwd.cu``, ``csrc/padded_bwd.cu``). Every TPU kernel
of the JAX package has its CUDA counterpart in ``csrc/``, built at first
use by ``kernels.py`` (into the checkout's ``build/torch_kernels``, or a
per-user cache directory when the package is installed).

Geometry and compositing run in float32 throughout, so TF32 is switched off
for matrix products and cuDNN convolutions as soon as the package is
imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
