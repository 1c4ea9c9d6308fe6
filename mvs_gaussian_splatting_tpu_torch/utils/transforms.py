"""Quaternion / covariance / activation math on torch tensors.

Port of the JAX package's ``utils/transforms.py``. Same formulas and evaluation order; geometry stays in float32
as explicit broadcast-multiply-sums (no matrix product, so no TF32 path).
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize quaternions [..., 4] (w, x, y, z) → rotation matrices [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [..., 3] scales + [..., 4] quats → [..., 3, 3]."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(scaling, rotation, scaling_modifier=1.0):
    """Full 3D covariance Σ = L Lᵀ, L = R·diag(mod·s). Returns [..., 3, 3]."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation)
    return (L[..., :, None, :] * L[..., None, :, :]).sum(-1)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric → upper-triangle 6-vector (xx, xy, xz, yy, yz, zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def unstrip_symmetric(c6: torch.Tensor) -> torch.Tensor:
    """Inverse of strip_symmetric: 6-vector → full symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (c6[..., i] for i in range(6))
    return torch.stack([
        torch.stack([xx, xy, xz], -1),
        torch.stack([xy, yy, yz], -1),
        torch.stack([xz, yz, zz], -1),
    ], dim=-2)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize along ``dim`` with torch.nn.functional.normalize's eps clamp."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [3, 3] → unit quaternion [4] (w, x, y, z).

    Branch-free Shepperd-style construction: the largest of the four
    candidate squared components picks the row (the first on a tie)."""
    t = R[0, 0] + R[1, 1] + R[2, 2]
    zero = torch.zeros((), dtype=R.dtype, device=R.device)
    qw2 = torch.maximum(zero, 1 + t)
    qx2 = torch.maximum(zero, 1 + R[0, 0] - R[1, 1] - R[2, 2])
    qy2 = torch.maximum(zero, 1 - R[0, 0] + R[1, 1] - R[2, 2])
    qz2 = torch.maximum(zero, 1 - R[0, 0] - R[1, 1] + R[2, 2])
    cands = torch.stack([
        torch.stack([qw2, R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]),
        torch.stack([R[2, 1] - R[1, 2], qx2, R[0, 1] + R[1, 0],
                     R[2, 0] + R[0, 2]]),
        torch.stack([R[0, 2] - R[2, 0], R[0, 1] + R[1, 0], qy2,
                     R[1, 2] + R[2, 1]]),
        torch.stack([R[1, 0] - R[0, 1], R[2, 0] + R[0, 2], R[1, 2] + R[2, 1],
                     qz2]),
    ])                                                   # [4 cand, 4 comp]
    mags = torch.stack([qw2, qx2, qy2, qz2])
    i = torch.argmax(mags)
    return cands[i] / (2.0 * torch.sqrt(torch.clamp(mags[i], min=1e-12)))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product [..., 4] ⊗ [..., 4] (w, x, y, z), broadcasting."""
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)
