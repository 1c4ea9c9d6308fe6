"""Convert torchvision VGG16 + LPIPS linear heads to the npz format that
eval/lpips.py consumes (the port's copy of the JAX package's converter;
both packages read the same file).

Run in an environment with network access and torchvision:

    python -m mvs_gaussian_splatting_tpu_torch.eval.convert_lpips_weights out.npz

then point $LPIPS_WEIGHTS_NPZ at the result. (The reference downloads the
same weights at first use, lpipsPyTorch/modules/utils.py:11-30.)
"""

from __future__ import annotations

import sys

import numpy as np


def main(out_path: str) -> None:
    try:
        import torch
        import torchvision
    except ImportError as e:
        raise SystemExit(f"torchvision required for conversion: {e}")

    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1")
    arrays = {}
    for name, param in vgg.features.state_dict().items():
        arrays[f"features.{name}"] = param.detach().numpy()

    # LPIPS linear heads (one 1x1 conv weight per tap). The official weights
    # ship with the richzhang/PerceptualSimilarity release; fall back to
    # uniform averaging heads when unavailable.
    url = ("https://raw.githubusercontent.com/richzhang/PerceptualSimilarity/"
           "master/lpips/weights/v0.1/vgg.pth")
    try:
        state = torch.hub.load_state_dict_from_url(url, map_location="cpu",
                                                   progress=False)
        for i in range(5):
            arrays[f"lin{i}"] = state[f"lin{i}.model.1.weight"].numpy().reshape(-1)
    except Exception as e:
        print(f"warning: linear heads unavailable ({e}); using uniform heads")
        dims = [64, 128, 256, 512, 512]
        for i, d in enumerate(dims):
            arrays[f"lin{i}"] = np.full(d, 1.0 / d, np.float32)

    np.savez(out_path, **arrays)
    print(f"wrote {out_path} ({len(arrays)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "lpips_vgg16.npz")
