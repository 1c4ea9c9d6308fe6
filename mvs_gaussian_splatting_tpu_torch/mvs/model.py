"""Generalizable Gaussian prediction from an MVS cost volume.

Port of the JAX package's ``mvs/model.py`` (flax) as ``nn.Module``\\ s: a 2D
feature CNN on each input view → plane-sweep variance cost volume in the
reference frustum → 3D CNN regularization → per-pixel depth distribution →
pixel-aligned Gaussian prediction heads (position from depth along the
ray; rotation, scale, opacity and colour from features). The predicted set
renders through the port's preprocess + rasterize, trained end to end with
the photometric loss (``mvs/train.py``).

What carries over from flax to PyTorch, layer by layer:

- ``"SAME"`` padding is asymmetric where the stride does not divide the
  kernel's reach: a 5×5 stride-2 convolution of an even side pads 1 low and
  2 high (:func:`_same_pad`), symmetric padding would shift the features;
- a flax ``ConvTranspose`` (3×3×3, strides 2, ``"SAME"``) is
  ``conv_transpose3d`` with the kernel flipped in space and no padding,
  of whose 2n + 1 outputs per axis it keeps the first 2n;
- ``jax.image.resize(..., "bilinear")`` antialiases when it shrinks, as
  ``F.interpolate(..., antialias=True)`` does.

:func:`params_from_flax` carries a flax variable tree across; the port's own
initialisation draws flax's (LeCun-normal kernels, zero biases) from a
``torch.Generator``, not flax's bits.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .homography import _ref_rays, build_cost_volume


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """x [N, C, *spatial] padded as flax/XLA ``"SAME"`` pads for a cubic
    ``kernel`` at ``stride``: ceil(n / stride) outputs per axis, the odd
    padding element on the high side."""
    pads = []
    for n in reversed(x.shape[2:]):
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _SameConv(nn.Module):
    """A flax ``Conv`` with ``"SAME"`` padding, 2D or 3D."""

    def __init__(self, dims: int, cin: int, cout: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        self.conv = conv(cin, cout, kernel, stride=stride)
        self.kernel, self.stride = kernel, stride

    def forward(self, x):
        return self.conv(_same_pad(x, self.kernel, self.stride))


class _SameConvTranspose3d(nn.Module):
    """A flax ``ConvTranspose`` (stride 2, ``"SAME"``): 2n outputs an axis."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, kernel, stride=2)

    def forward(self, x):
        d, h, w = x.shape[2:]
        return self.conv(x)[:, :, :2 * d, :2 * h, :2 * w]


class FeatureNet(nn.Module):
    """Small 2D CNN: images [N, 3, H, W] → features [N, C, H/4, W/4]."""

    def __init__(self, dims: Sequence[int] = (16, 32, 32)):
        super().__init__()
        self.conv0 = _SameConv(2, 3, dims[0], 5, 2)
        self.conv1 = _SameConv(2, dims[0], dims[1], 3)
        self.conv2 = _SameConv(2, dims[1], dims[1], 3, 2)
        self.conv3 = _SameConv(2, dims[1], dims[2], 3)

    def forward(self, x):
        h = F.relu(self.conv0(x))
        h = F.relu(self.conv1(h))
        h = F.relu(self.conv2(h))
        return self.conv3(h)


class CostRegNet(nn.Module):
    """3D encoder-decoder over the cost volume [D, C, H, W] → [D, G, H, W]."""

    def __init__(self, in_channels: int, base: int = 8,
                 out_channels: int = 8):
        super().__init__()
        self.conv0 = _SameConv(3, in_channels, base, 3)
        self.conv1 = _SameConv(3, base, base * 2, 3, 2)
        self.conv2 = _SameConv(3, base * 2, base * 4, 3, 2)
        self.up1 = _SameConvTranspose3d(base * 4, base * 2)
        self.up0 = _SameConvTranspose3d(base * 2, base)
        self.out = _SameConv(3, base, out_channels, 3)

    def forward(self, vol):
        h = vol.permute(1, 0, 2, 3)[None]              # [1, C, D, H, W]
        c0 = F.relu(self.conv0(h))
        c1 = F.relu(self.conv1(c0))
        c2 = F.relu(self.conv2(c1))
        u1 = F.relu(self.up1(c2))
        u1 = u1[:, :, :c1.shape[2], :c1.shape[3], :c1.shape[4]] + c1
        u0 = F.relu(self.up0(u1))
        u0 = u0[:, :, :c0.shape[2], :c0.shape[3], :c0.shape[4]] + c0
        return self.out(u0)[0].permute(1, 0, 2, 3)     # [D, G, H, W]


class GaussianHead(nn.Module):
    """Per-pixel Gaussian attributes from aggregated volume features.

    12 channels: depth offset (1), rotation (4), log-scale (3), opacity
    logit (1), RGB logits (3)."""

    def __init__(self, in_features: int, width: int = 64):
        super().__init__()
        self.fc0 = nn.Linear(in_features, width)
        self.fc1 = nn.Linear(width, width)
        self.fc2 = nn.Linear(width, 12)

    def forward(self, feat):
        h = feat.permute(1, 2, 0)                      # [H, W, F]
        h = F.relu(self.fc0(h))
        h = F.relu(self.fc1(h))
        return self.fc2(h)                             # [H, W, 12]


def _fan_in(w: torch.Tensor, transposed: bool) -> int:
    """flax's fan-in of a kernel: input features times the receptive field
    (a ConvTranspose kernel's input features are its first axis here)."""
    receptive = int(np.prod(w.shape[2:])) if w.dim() > 2 else 1
    return (w.shape[0] if transposed else w.shape[1]) * receptive


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int):
    """``jnp.linspace(start, stop, num)`` of 0-d float32 tensors, in its
    arithmetic: start (1 − s) + stop s at s = i / (num − 1), stop last."""
    if num == 1:
        return start.reshape(1)
    step = torch.arange(num - 1, dtype=torch.float32,
                        device=start.device) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


class MVSGaussianModel(nn.Module):
    """3-view generalizable splatting: views + poses → Gaussian cloud."""

    def __init__(self, num_depths: int = 32,
                 feat_dims: Sequence[int] = (16, 32, 32), seed: int = 0):
        super().__init__()
        self.num_depths = num_depths
        self.feat_dims = tuple(feat_dims)
        self.fnet = FeatureNet(feat_dims)
        self.reg = CostRegNet(feat_dims[2])
        self.head = GaussianHead(8 + feat_dims[2] + 3)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """flax's default initialisation: LeCun-normal kernels (a normal of
        variance 1 / fan-in truncated at two standard deviations, widened
        to keep that variance) and zero biases, drawn from ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                              nn.Linear)):
                fan = _fan_in(m.weight, isinstance(m, nn.ConvTranspose3d))
                std = math.sqrt(1.0 / fan) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()

    def forward(self, ref_image, src_images, k_ref, k_srcs, rel_rs, rel_ts,
                near, far):
        """ref_image [3, H, W]; src_images [V, 3, H, W]; k_ref at FEATURE
        resolution (H/4); near, far 0-d float32 tensors. Returns a dict of
        Gaussian tensors (one per feature pixel) ready for rasterize, plus
        the depth map."""
        feats = self.fnet(torch.cat([ref_image[None], src_images], 0))
        ref_feat, src_feats = feats[0], feats[1:]      # [C, h, w], [V, ...]
        _, h, w = ref_feat.shape

        depths = _linspace(near, far, self.num_depths)
        k_ref_inv = torch.linalg.inv(k_ref)
        vol = build_cost_volume(ref_feat, src_feats, k_ref_inv, k_srcs,
                                rel_rs, rel_ts, depths, h, w)
        reg = self.reg(vol)                            # [D, G, h, w]

        # depth distribution from the first regularized channel
        prob = torch.softmax(reg[:, 0], dim=0)         # [D, h, w]
        depth = (prob * depths[:, None, None]).sum(0)  # [h, w]

        # features at the expected depth + reference features + the
        # (downsampled) reference colours that anchor the RGB prediction
        ref_small = F.interpolate(ref_image[None], size=(h, w),
                                  mode="bilinear", align_corners=False,
                                  antialias=True)[0]
        agg = (prob[:, None] * reg).sum(0)             # [G, h, w]
        attrs = self.head(torch.cat([agg, ref_feat, ref_small], 0))

        # pixel-aligned Gaussians: position = ray · (depth + learned offset)
        rays = _ref_rays(k_ref_inv, h, w)
        depth_off = 0.1 * torch.tanh(attrs[..., 0])
        z = torch.minimum(torch.maximum(depth + depth_off, near), far)
        xyz_cam = rays * z[None]                       # [3, h, w] (ref cam)

        n = h * w
        xyz = xyz_cam.reshape(3, n).T
        rot = attrs[..., 1:5].reshape(n, 4) + torch.tensor(
            [1.0, 0.0, 0.0, 0.0], device=attrs.device)
        base_scale = (far - near) / self.num_depths
        log_scale = attrs[..., 5:8].reshape(n, 3) + torch.log(base_scale)
        opacity = attrs[..., 8:9].reshape(n, 1)
        # direct per-Gaussian RGB, biased toward the observed reference
        # colour (a logit-space residual that starts near 0)
        base_rgb = ref_small.reshape(3, n).T.clamp(1e-3, 1 - 1e-3)
        base_logit = torch.log(base_rgb / (1 - base_rgb))
        colors = torch.sigmoid(attrs[..., 9:12].reshape(n, 3) + base_logit)
        return {"xyz_cam": xyz, "rotation": rot, "log_scaling": log_scale,
                "opacity_logit": opacity, "colors": colors, "depth": depth}


# flax submodule → the port's, in MVSGaussianModel's tree
_FLAX_NAMES = {
    "FeatureNet_0": ("fnet", {f"Conv_{i}": f"conv{i}.conv" for i in range(4)}),
    "CostRegNet_0": ("reg", {"Conv_0": "conv0.conv", "Conv_1": "conv1.conv",
                             "Conv_2": "conv2.conv", "Conv_3": "out.conv",
                             "ConvTranspose_0": "up1.conv",
                             "ConvTranspose_1": "up0.conv"}),
    "GaussianHead_0": ("head", {f"Dense_{i}": f"fc{i}" for i in range(3)}),
}


def params_from_flax(tree) -> dict:
    """A flax variable tree of ``MVSGaussianModel`` (numpy leaves, with or
    without its ``"params"`` level) → the port's ``state_dict``: a Dense
    kernel [in, out] becomes its transpose, a Conv kernel HWIO / DHWIO
    becomes OIHW / OIDHW, a ConvTranspose kernel (kD, kH, kW, in, out)
    becomes [in, out, kD, kH, kW] flipped in space."""
    tree = tree.get("params", tree)
    state = {}
    for flax_mod, (prefix, layers) in _FLAX_NAMES.items():
        for flax_layer, name in layers.items():
            leaf = tree[flax_mod][flax_layer]
            k = np.asarray(leaf["kernel"], np.float32)
            if flax_layer.startswith("Dense"):
                w = k.T
            elif flax_layer.startswith("ConvTranspose"):
                w = k.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]
            else:
                w = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
            state[f"{prefix}.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(w))
            state[f"{prefix}.{name}.bias"] = torch.from_numpy(
                np.asarray(leaf["bias"], np.float32).copy())
    return state
