"""Codebook compression of a trained Gaussian model.

Port of the JAX package's ``cli/compress.py``; same flags plus ``--device``
(default ``cuda``), and the same file layout, so each package decompresses
the other's file:

    python -m mvs_gaussian_splatting_tpu_torch.cli.compress -m <model> \\
        [--iteration N] [--num_codes 256] [--attributes f_rest scaling rotation]

writes ``point_cloud/iteration_N/point_cloud_compressed.npz`` — per-attribute
k-means codebooks (``codebooks/<attr>``, f32), codes (``codes/<attr>``,
uint16 up to 65,536 codes, else int32), the attribute's shape
(``shape/<attr>``, int64) and every untouched attribute in f32
(``raw/<attr>``) — and prints the size ratio. ``--decompress`` writes the
standard ``point_cloud_dequant.ply`` that the render CLI and any 3DGS viewer
read.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..models.ply import load_gaussian_ply, save_gaussian_ply
from ..models.quantize import compress_gaussians
from ..utils.system import search_max_iteration


def compress(model_path: str, iteration: int, num_codes: int,
             attributes, sh_degree: int, seed: int = 0,
             device="cuda") -> str:
    """Fits the codebooks on ``device`` with draws from a generator seeded
    with ``seed``; returns the ``.npz`` path."""
    ply = os.path.join(model_path, "point_cloud", f"iteration_{iteration}",
                       "point_cloud.ply")
    gaussians = load_gaussian_ply(ply, max_sh_degree=sh_degree)
    out = compress_gaussians(gaussians, num_codes=num_codes,
                             attributes=tuple(attributes),
                             generator=torch.Generator().manual_seed(seed),
                             device=device)
    arrays = {}
    for attr in out["codes"]:
        err = float(np.mean(np.abs(out["dequantized"][attr].cpu().numpy()
                                   - np.asarray(gaussians[attr]))))
        print(f"  {attr}: mean |dequant - raw| = {err:.5f}")
    for attr, codes in out["codes"].items():
        dtype = np.uint16 if num_codes <= 65536 else np.int32
        arrays[f"codes/{attr}"] = codes.cpu().numpy().astype(dtype)
        arrays[f"codebooks/{attr}"] = np.asarray(
            out["codebooks"][attr].cpu().numpy(), np.float32)
        arrays[f"shape/{attr}"] = np.asarray(gaussians[attr].shape, np.int64)
    for k, v in gaussians.items():
        if k not in out["codes"]:
            arrays[f"raw/{k}"] = np.asarray(v, np.float32)
    dst = ply.replace("point_cloud.ply", "point_cloud_compressed.npz")
    np.savez_compressed(dst, **arrays)
    src_sz = os.path.getsize(ply)
    dst_sz = os.path.getsize(dst)
    print(f"{ply} ({src_sz/1e6:.2f} MB) -> {dst} ({dst_sz/1e6:.2f} MB), "
          f"ratio {src_sz/max(dst_sz,1):.2f}x")
    return dst


def decompress(npz_path: str) -> str:
    """Writes the dequantized PLY beside ``npz_path``; returns its path."""
    data = np.load(npz_path)
    gaussians = {}
    for key in data.files:
        kind, _, attr = key.partition("/")
        if kind == "raw":
            gaussians[attr] = data[key]
        elif kind == "codes":
            codebook = data[f"codebooks/{attr}"]
            shape = tuple(data[f"shape/{attr}"])
            gaussians[attr] = codebook[data[key].astype(np.int64)].reshape(
                shape).astype(np.float32)
    dst = npz_path.replace("point_cloud_compressed.npz",
                           "point_cloud_dequant.ply")
    save_gaussian_ply(dst, gaussians)
    print(f"wrote {dst} ({len(gaussians['xyz'])} gaussians)")
    return dst


def main(argv=None):
    """Returns the path written: the ``.npz``, or with ``--decompress`` the
    dequantized PLY."""
    parser = argparse.ArgumentParser(description="Codebook compression")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--num_codes", type=int, default=256)
    parser.add_argument("--attributes", nargs="+",
                        default=["f_rest", "scaling", "rotation"])
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--decompress", action="store_true",
                        help="reconstruct point_cloud_dequant.ply from an "
                             "existing point_cloud_compressed.npz")
    parser.add_argument("--device", default="cuda",
                        help="torch device to fit the codebooks on "
                             "(default cuda)")
    args = parser.parse_args(argv)

    iteration = args.iteration
    if iteration == -1:
        iteration = search_max_iteration(
            os.path.join(args.model_path, "point_cloud"))
    if args.decompress:
        npz = os.path.join(args.model_path, "point_cloud",
                           f"iteration_{iteration}",
                           "point_cloud_compressed.npz")
        return decompress(npz)
    return compress(args.model_path, iteration, args.num_codes,
                    args.attributes, args.sh_degree, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
