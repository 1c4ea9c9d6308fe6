"""k-NN mean squared distance for scale initialization.

Port of the JAX package's ``ops/knn.py`` (the simple-knn ``distCUDA2`` of
the reference, used once at model init): mean squared distance from each
point to its 3 nearest others, by chunked brute force. Init-time only.
"""

from __future__ import annotations

import torch


def mean_sq_dist_to_knn(points: torch.Tensor, k: int = 3,
                        chunk: int = 4096) -> torch.Tensor:
    """points [N, 3] → [N] mean of squared distances to the k nearest others."""
    sq = (points * points).sum(-1)
    out = []
    for qc in points.split(chunk):
        # the expanded form, as the JAX package writes it; TF32 is off, so
        # the product is full f32 on a card too
        d2 = ((qc * qc).sum(-1)[:, None] - 2.0 * (qc @ points.T)
              + sq[None, :])
        # the k+1 smallest include the point itself (distance ~0)
        d2k = torch.topk(d2, k + 1, dim=1, largest=False).values[:, 1:]
        out.append(torch.clamp(d2k, min=0.0).mean(-1))
    return torch.cat(out)
