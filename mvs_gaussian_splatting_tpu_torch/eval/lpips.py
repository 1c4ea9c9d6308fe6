"""LPIPS perceptual metric (VGG16 backbone).

Port of the JAX package's ``eval/lpips.py`` (the reference's
lpipsPyTorch/, modules/lpips.py:8-36, networks.py:12-96): normalised
feature-space squared distances at the five VGG16 taps, averaged over
pixels and weighted by the learned linear heads. The weights are read from
the ``.npz`` named by ``$LPIPS_WEIGHTS_NPZ`` (or ``weights_path``): the
torchvision ``features.<i>.weight`` / ``.bias`` of each convolution and the
heads ``lin<k>``, as ``convert_lpips_weights.py`` writes them. Without it
:class:`LPIPS` raises ``FileNotFoundError`` and the metrics report LPIPS as
``null``. The convolutions are library calls (the JAX package computes them
with ``lax.conv_general_dilated``, outside any kernel); the package turns
TF32 off, so they run in full f32 on a card.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 conv structure: (out_channels, layers-per-block); LPIPS taps the
# activations after each block's last ReLU (before pooling).
_VGG16_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    def __init__(self, weights_path: str | None = None, device="cuda"):
        super().__init__()
        weights_path = weights_path or os.environ.get("LPIPS_WEIGHTS_NPZ", "")
        if not weights_path or not os.path.exists(weights_path):
            raise FileNotFoundError(
                "LPIPS weights unavailable (set LPIPS_WEIGHTS_NPZ to a "
                "converted torchvision VGG16 + linear-head .npz)")
        data = np.load(weights_path)

        def param(key):
            return nn.Parameter(torch.tensor(np.asarray(data[key], np.float32)),
                                requires_grad=False)

        self.convs = nn.ModuleList()     # one list of convolutions a block
        idx = 0
        for out_c, n_layers in _VGG16_CFG:
            block = nn.ParameterList()
            for _ in range(n_layers):
                block.append(param(f"features.{idx}.weight"))  # [O, I, 3, 3]
                block.append(param(f"features.{idx}.bias"))
                idx += 2      # conv + relu
            idx += 1          # pool
            self.convs.append(block)
        self.lins = nn.ParameterList(
            nn.Parameter(torch.tensor(np.asarray(data[f"lin{i}"], np.float32)
                                      .reshape(-1)), requires_grad=False)
            for i in range(len(_VGG16_CFG)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(3, 1, 1))
        self.to(device)

    def features(self, x: torch.Tensor):
        """x [3, H, W] in [0, 1] → the five taps, each [1, C, h, w]."""
        h = ((x * 2.0 - 1.0 - self.shift) / self.scale)[None]
        feats = []
        for bi, block in enumerate(self.convs):
            for w, b in zip(block[0::2], block[1::2]):
                h = F.relu(F.conv2d(h, w, b, padding=1))
            feats.append(h)
            if bi < len(self.convs) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        dev = self.shift.device
        f1 = self.features(torch.as_tensor(img1, device=dev))
        f2 = self.features(torch.as_tensor(img2, device=dev))
        total = torch.zeros((), device=dev)
        for a, b, lin in zip(f1, f2, self.lins):
            a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            d = (a - b) ** 2                        # [1, C, H, W]
            total = total + (d.mean(dim=(2, 3))[0] * lin).sum()
        return total
