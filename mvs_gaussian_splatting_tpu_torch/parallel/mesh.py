"""The rank mesh of the multi-device modes: a 1-D (data) or 2-D (data,
tile) grid over the first ``n`` ranks of the process group.

Counterpart of the JAX package's ``parallel/mesh.py``. A :class:`Mesh`
holds the axis sizes, this rank's coordinates, and one process group per
line of the grid along each axis (a row shares a data index, a column a
tile index), plus one over the whole mesh. Every rank of the world creates
every group, in one order (``torch.distributed.new_group`` must be called
by all); a rank outside the first ``n`` is not :attr:`Mesh.member` and
takes no part in the mesh's steps. At world size 1 no process group is
needed: every axis has size 1 and every collective here is the identity.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import rank as _rank
from .multihost import world_size


class Mesh:
    """Axis names and sizes, this rank's coordinates, and its groups."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.size = int(np.prod(shape))
        self.ranks = np.arange(self.size).reshape(shape)
        self.rank = _rank()
        self.member = self.rank < self.size
        self.coords: Dict[str, int] = {}
        if self.member:
            idx = np.unravel_index(self.rank, shape)
            self.coords = {a: int(i) for a, i in zip(axes, idx)}
        self.groups: Dict[str, Optional[object]] = {a: None for a in axes}
        self.group: Optional[object] = None
        # collectives this rank issued over the mesh's groups: operation →
        # [calls, bytes this rank sent]
        self.collectives: Dict[str, list] = {}
        if dist.is_initialized() and world_size() > 1:
            self._make_groups(shape)

    def _make_groups(self, shape) -> None:
        # one order on every rank: each axis in turn, its lines in rank order
        for ax_i, ax in enumerate(self.axes):
            if shape[ax_i] == 1:
                continue
            lines = np.moveaxis(self.ranks, ax_i, -1).reshape(-1, shape[ax_i])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[ax] = g
        if self.size > 1:
            g = (dist.group.WORLD if self.size == world_size()
                 else dist.new_group(list(range(self.size))))
            if self.member:
                self.group = g

    def note(self, op: str, t: torch.Tensor) -> None:
        """Count one collective ``op`` that sends ``t`` from this rank."""
        c = self.collectives.setdefault(op, [0, 0])
        c[0] += 1
        c[1] += t.numel() * t.element_size()

    def axis_size(self, axis: Optional[str] = None) -> int:
        return self.size if axis is None else self.shape[axis]

    def axis_group(self, axis: Optional[str] = None):
        """The group of this rank's line along ``axis`` (None: the whole
        mesh); None where that line has one rank."""
        return self.group if axis is None else self.groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, coords {self.coords})"


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",)) -> Mesh:
    """1-D (data) or 2-D (data, tile) mesh over the first ``n_devices``
    ranks (default: the whole world). A 2-D mesh favours the data axis:
    the tile axis takes the largest divisor of n not above √n. Raises when
    the mesh asks for more ranks than the world has."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n > world:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} "
                         f"processes, the world has {world}")
    if len(axes) == 1:
        return Mesh((n,), tuple(axes))
    if len(axes) == 2:
        for d in range(int(np.sqrt(n)), 0, -1):
            if n % d == 0:
                break
        return Mesh((n // d, d), tuple(axes))
    raise ValueError(f"unsupported axes {axes}")


def grid_mesh(n_data: int, n_tile: int,
              axes: Sequence[str] = ("data", "tile")) -> Mesh:
    """A (data, tile) mesh of exactly ``n_data`` × ``n_tile`` ranks."""
    n = n_data * n_tile
    if n > world_size():
        raise ValueError(f"a {n_data}×{n_tile} grid needs {n} processes, "
                         f"the world has {world_size()}")
    return Mesh((n_data, n_tile), tuple(axes))


def batch_sharded(mesh: Mesh, x, axis: str = "data"):
    """This rank's contiguous block of ``x``'s leading (batch) dim along
    ``axis`` (``P(axis)``): a tensor, or a list of per-item objects."""
    n = mesh.shape[axis]
    b = len(x) if isinstance(x, (list, tuple)) else x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not divide over {n} ranks")
    i = mesh.coords[axis]
    return x[i * (b // n):(i + 1) * (b // n)]


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None,
               op=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``axis`` (None: the whole mesh),
    SUM by default; the identity on a line of one rank."""
    g = mesh.axis_group(axis)
    if g is not None:
        mesh.note("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=g)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh,
               axis: Optional[str] = None) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t`` along ``axis`` in rank order, no
    autograd."""
    g = mesh.axis_group(axis)
    if g is None:
        return t[None]
    n = mesh.axis_size(axis)
    mesh.note("all_gather", t)
    out = t.new_empty(n * t.numel())
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, t.contiguous().reshape(-1), group=g)
    return out.view((n,) + tuple(t.shape))


class _GatherShards(torch.autograd.Function):
    """[n·m, ...] = every rank's [m, ...] block along an axis, rank-major.
    The backward hands this rank only its own block's cotangent: every rank
    goes on to the same loss on the gathered whole, so an autograd
    all-gather (whose transpose sums the n identical cotangents) would make
    each gradient n times too large."""

    @staticmethod
    def forward(ctx, local, mesh, axis):
        ctx.block = mesh.coords[axis] if axis else mesh.rank
        ctx.m = local.shape[0]
        full = all_gather(local, mesh, axis)
        return full.reshape((-1,) + tuple(local.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        i, m = ctx.block, ctx.m
        return g[i * m:(i + 1) * m], None, None


def gather_shards(local: torch.Tensor, mesh: Mesh,
                  axis: Optional[str] = None) -> torch.Tensor:
    """Differentiable all-gather whose backward slices (see
    :class:`_GatherShards`)."""
    return _GatherShards.apply(local, mesh, axis)


class _SumGrad(torch.autograd.Function):
    """The identity whose backward SUM-reduces the cotangent over an axis:
    where each rank's backward holds the gradient of its own shard's part
    of a replicated input, the sum is the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


def sum_grad(x: torch.Tensor, mesh: Mesh,
             axis: Optional[str] = None) -> torch.Tensor:
    """``x``, with its gradient SUM-reduced over ``axis`` in the backward."""
    if mesh.axis_group(axis) is None:
        return x
    return _SumGrad.apply(x, mesh, axis)
