"""Padded-table composite: the per-tile front-to-back alpha composite over
fixed-capacity ``[T, K]`` per-tile tables (counterpart of the JAX package's
``ops/pallas/composite.py`` and of ``composite_tiles_jnp`` in its
``ops/rasterize.py``).

:func:`composite_padded` launches the hand-written CUDA kernel
``csrc/padded_fwd.cu`` (B4, B1's kernel body on the padded layout) for
CUDA tensors and runs its plain version
:func:`composite_padded_plain` (built on :func:`composite_tiles_jnp`) for
CPU tensors. It is differentiable in the six attribute planes, ``rgb`` and
``bg``: its backward launches ``csrc/padded_bwd.cu`` (B5) for CUDA tensors
and runs :func:`composite_padded_bwd_plain` for CPU tensors. Both are
exact mode, as in the JAX package (its fast-math flag reaches the stream
backend only).

:func:`composite_tiles_jnp` is also the JAX package's own non-Pallas
backend (``backend="jnp"``): ``ops/rasterize.py`` runs it, differentiated by
autograd, on whatever device it is given. There it is an operator of its
own, not a stand-in for a kernel.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .stream import (ROWS, _pixel_grid, check_order,
                     composite_stream_bwd_plain, heaviest_first, tile_limit)

# Kernel launches: B4 by composite_padded, B5 by its backward (the CPU path
# counts neither).
launches = 0
bwd_launches = 0


def composite_tiles_jnp(xy, conic, rgb, opacity, valid, tile_ids,
                        tiles_x: int, tile_w: int, tile_h: int, bg):
    """Composite one batch of tiles (the JAX package's
    ``ops/rasterize.py:composite_tiles_jnp``).

    xy [B, K, 2], conic [B, K, 3], rgb [B, K, 3], opacity [B, K],
    valid [B, K] bool, tile_ids [B] → (out [B, 3, P], final_T [B, P]) with
    P = tile_h·tile_w. Materialises [B, K, P]: callers batch the tiles."""
    px, py = _pixel_grid(tile_ids, tiles_x, tile_w, tile_h)       # [B, P]
    dx = xy[:, :, 0, None] - px[:, None, :]                       # [B, K, P]
    dy = xy[:, :, 1, None] - py[:, None, :]
    power = (-0.5 * (conic[:, :, 0, None] * dx * dx
                     + conic[:, :, 2, None] * dy * dy)
             - conic[:, :, 1, None] * dx * dy)
    alpha = torch.clamp(opacity[:, :, None] * torch.exp(power), max=0.99)
    contributes = valid[:, :, None] & (power <= 0.0) & (alpha >= 1.0 / 255.0)
    alpha = torch.where(contributes, alpha, 0.0)

    one_minus = 1.0 - alpha
    ones = torch.ones_like(one_minus[:, :1])
    t_excl = torch.cumprod(torch.cat([ones, one_minus[:, :-1]], dim=1), dim=1)
    fail = contributes & (t_excl * one_minus < 1e-4)
    fail_i = fail.to(torch.int32)
    done_before = torch.cumsum(fail_i, dim=1) - fail_i
    include = contributes & (done_before == 0) & ~fail

    w = torch.where(include, alpha * t_excl, 0.0)                 # [B, K, P]
    out = torch.einsum("bkp,bkc->bcp", w, rgb)
    final_t = torch.prod(torch.where(include, one_minus, 1.0), dim=1)
    out = out + final_t[:, None, :] * bg[None, :, None]
    return out, final_t


def composite_tiles_jnp_batched(xy, conic, rgb, opacity, valid,
                                tiles_x: int, tile_w: int, tile_h: int, bg,
                                tile_batch: int, tile_ids=None):
    """:func:`composite_tiles_jnp` over all T tiles, ``tile_batch`` at a
    time; where autograd records, each batch is recomputed in the backward
    instead of kept (the JAX package's checkpointed scan) → (out [T, 3, P],
    final_T [T, P]). ``tile_ids`` [T]: the global tile of each row (a
    shard's tiles); default 0..T-1."""
    t = opacity.shape[0]
    if tile_ids is None:
        tile_ids = torch.arange(t, device=opacity.device)
    outs, tfins = [], []
    for b0 in range(0, t, tile_batch):
        sl = slice(b0, min(b0 + tile_batch, t))
        ids = tile_ids[sl]
        args = (xy[sl], conic[sl], rgb[sl], opacity[sl], valid[sl], ids,
                tiles_x, tile_w, tile_h, bg)
        out, tfin = (checkpoint(composite_tiles_jnp, *args,
                                use_reentrant=False)
                     if torch.is_grad_enabled() else
                     composite_tiles_jnp(*args))
        outs.append(out)
        tfins.append(tfin)
    if not outs:
        p = tile_w * tile_h
        return opacity.new_zeros((0, 3, p)), opacity.new_zeros((0, p))
    return torch.cat(outs), torch.cat(tfins)


def _check(planes, rgb, valid, counts, bg, tile_w: int, tile_h: int):
    if planes.dim() != 3 or planes.shape[0] != 6:
        raise ValueError(f"planes must be [6, T, K], got {tuple(planes.shape)}")
    _, t, k = planes.shape
    for name, a, shape in (("rgb", rgb, (t, k, 3)), ("valid", valid, (t, k)),
                           ("bg", bg, (3,))):
        if a.dtype != torch.float32 or a.shape != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if planes.dtype != torch.float32:
        raise TypeError("planes must be float32")
    if counts.dtype != torch.int32 or counts.shape != (t,):
        raise ValueError(f"counts must be int32 [{t}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    for a in (planes, rgb, valid, counts, bg):
        if a.device != planes.device:
            raise ValueError("all inputs must be on one device")
        if not a.is_contiguous():
            raise ValueError("inputs must be contiguous")
    why = tile_limit(tile_w, tile_h)
    if why:
        raise ValueError(why)


def _stream_view(planes, rgb, valid, counts):
    """The tables laid out as a packed stream ([16, T·K] attribute rows,
    tile t's segment at t·K, counts clipped to K, an invalid slot with
    opacity 0 so that it never contributes): B2's replay then walks the
    entries B5 walks, in the same order."""
    _, t, k = planes.shape
    attrs = planes.new_zeros((ROWS, t * k))
    attrs[:5] = planes[:5].reshape(5, -1)
    attrs[5] = torch.where(valid > 0, planes[5], 0.0).reshape(-1)
    attrs[6:9] = rgb.reshape(-1, 3).T
    seg_start = torch.arange(t, dtype=torch.int32, device=planes.device) * k
    return attrs, seg_start, torch.clamp(counts, 0, k).to(torch.int32)


def composite_padded_plain(planes, rgb, valid, counts, bg, tiles_x: int,
                           tile_w: int, tile_h: int):
    """Plain PyTorch version of B4, :func:`composite_tiles_jnp` over
    batches of 64 tiles: slot k of tile t composites iff
    k < min(counts[t], K) and valid > 0 → (out [T, P, 3], final_T [T, P])."""
    k = planes.shape[2]
    live = ((valid > 0) & (torch.arange(k, device=planes.device)[None, :]
                           < counts.long()[:, None]))
    out, final_t = composite_tiles_jnp_batched(
        planes[:2].permute(1, 2, 0), planes[2:5].permute(1, 2, 0), rgb,
        planes[5], live, tiles_x, tile_w, tile_h, bg, 64)
    return out.transpose(1, 2).contiguous(), final_t


def composite_padded_bwd_plain(planes, rgb, valid, counts, bg, tiles_x: int,
                               tile_w: int, tile_h: int, out, final_t, g_out,
                               g_tfin, *, count_visits: bool = False):
    """Plain PyTorch version of B5, same signature as
    :func:`composite_padded_bwd`: the forward replay of the JAX package's
    ``composite.py:_bwd_kernel``, as :func:`composite_stream_bwd_plain`
    replays B2, over the tables laid out as a stream (one segment of K slots
    per tile) → (gplanes [6, T, K], grgb [T, K, 3], g_bg [3]).
    ``count_visits=True`` also returns the (entry, pixel) pairs visited."""
    _, t, k = planes.shape
    attrs, seg_start, cnt = _stream_view(planes, rgb, valid, counts)
    ids = torch.arange(t, dtype=torch.int32, device=planes.device)
    res = composite_stream_bwd_plain(attrs, seg_start, cnt, bg, ids, tiles_x,
                                     tile_w, tile_h, out, final_t, g_out,
                                     g_tfin, count_visits=count_visits)
    gattrs, g_bg = res[0], res[1]
    gplanes = gattrs[:6].reshape(6, t, k)
    grgb = gattrs[6:9].T.reshape(t, k, 3)
    return (gplanes, grgb, g_bg) + tuple(res[2:])


def _padded_fwd(planes, rgb, valid, counts, bg, tiles_x: int, tile_w: int,
                tile_h: int, order=None):
    """B4 on CUDA tensors, its plain version on CPU tensors → (out, final_T).
    ``order``: the tile order B4 walks, :func:`heaviest_first` of
    ``counts`` (taken here when not given)."""
    global launches
    _check(planes, rgb, valid, counts, bg, tile_w, tile_h)
    if planes.device.type == "cpu":
        return composite_padded_plain(planes, rgb, valid, counts, bg, tiles_x,
                                      tile_w, tile_h)
    if planes.device.type != "cuda":
        raise ValueError(f"no padded kernel for device {planes.device}")
    from .. import kernels

    _, t, k = planes.shape
    p = tile_w * tile_h
    out = torch.empty((t, p, 3), dtype=torch.float32, device=planes.device)
    final_t = torch.empty((t, p), dtype=torch.float32, device=planes.device)
    if t == 0:
        return out, final_t
    if order is None:
        order = heaviest_first(counts)
    check_order(order, counts)
    with torch.cuda.device(planes.device):
        err = kernels.library().gs_padded_fwd(
            planes.data_ptr(), rgb.data_ptr(), valid.data_ptr(),
            counts.data_ptr(), order.data_ptr(), bg.data_ptr(),
            out.data_ptr(), final_t.data_ptr(), t, k, tiles_x, tile_w,
            tile_h, torch.cuda.current_stream(planes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gs_padded_fwd launch failed: CUDA error {err}")
    launches += 1
    return out, final_t


def composite_padded_bwd(planes, rgb, valid, counts, bg, tiles_x: int,
                         tile_w: int, tile_h: int, out, final_t, g_out,
                         g_tfin, order=None):
    """Gradient of :func:`composite_padded`: the forward's inputs, its saved
    outputs and their cotangents → (gplanes [6, T, K], grgb [T, K, 3],
    g_bg [3]). Zero at and beyond counts and in every invalid slot; g_bg =
    Σ g_out·final_T outside the kernel, as in the JAX package. ``order``:
    the tile order B5 walks, :func:`heaviest_first` of ``counts`` (taken
    here when not given)."""
    global bwd_launches
    _check(planes, rgb, valid, counts, bg, tile_w, tile_h)
    _, t, k = planes.shape
    p = tile_w * tile_h
    for name, a, shape in (("out", out, (t, p, 3)), ("final_t", final_t, (t, p)),
                           ("g_out", g_out, (t, p, 3)),
                           ("g_tfin", g_tfin, (t, p))):
        if (a.shape != shape or a.dtype != torch.float32
                or a.device != planes.device or not a.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{list(shape)} on {planes.device}")
    if planes.device.type == "cpu":
        return composite_padded_bwd_plain(planes, rgb, valid, counts, bg,
                                          tiles_x, tile_w, tile_h, out,
                                          final_t, g_out, g_tfin)
    if planes.device.type != "cuda":
        raise ValueError(f"no padded kernel for device {planes.device}")
    from .. import kernels

    # B5 writes every slot of every tile, zeros where nothing is summed
    gplanes = torch.empty_like(planes)
    grgb = torch.empty_like(rgb)
    g_bg = torch.einsum("tpc,tp->c", g_out, final_t)
    if t == 0:
        return gplanes, grgb, g_bg
    if order is None:
        order = heaviest_first(counts)
    check_order(order, counts)
    with torch.cuda.device(planes.device):
        err = kernels.library().gs_padded_bwd(
            planes.data_ptr(), rgb.data_ptr(), valid.data_ptr(),
            counts.data_ptr(), order.data_ptr(), bg.data_ptr(),
            final_t.data_ptr(), g_out.data_ptr(), g_tfin.data_ptr(),
            gplanes.data_ptr(), grgb.data_ptr(), t, k, tiles_x, tile_w,
            tile_h, torch.cuda.current_stream(planes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gs_padded_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return gplanes, grgb, g_bg


class _PaddedComposite(torch.autograd.Function):
    """B4 forward, B5 backward; gradients flow to the planes, rgb and bg.
    The tile order is taken once, for both kernels."""

    @staticmethod
    def forward(ctx, planes, rgb, valid, counts, bg, tiles_x, tile_w, tile_h):
        order = heaviest_first(counts) if counts.is_cuda else None
        out, final_t = _padded_fwd(planes, rgb, valid, counts, bg, tiles_x,
                                   tile_w, tile_h, order)
        ctx.geometry = (tiles_x, tile_w, tile_h)
        ctx.order = order
        ctx.save_for_backward(planes, rgb, valid, counts, bg, out, final_t)
        return out, final_t

    @staticmethod
    def backward(ctx, g_out, g_tfin):
        planes, rgb, valid, counts, bg, out, final_t = ctx.saved_tensors
        gplanes, grgb, g_bg = composite_padded_bwd(
            planes, rgb, valid, counts, bg, *ctx.geometry, out, final_t,
            g_out.contiguous(), g_tfin.contiguous(), order=ctx.order)
        return gplanes, grgb, None, None, g_bg, None, None, None


def composite_padded(planes, rgb, valid, counts, bg, tiles_x: int,
                     tile_w: int, tile_h: int):
    """planes [6, T, K] f32 (x, y, conic a, b, c, opacity); rgb [T, K, 3]
    f32; valid [T, K] f32; counts [T] i32; bg [3] f32, all contiguous →
    (out [T, P, 3], final_T [T, P]); tile t is the image's tile t and
    composites its slots k < min(counts[t], K) with valid > 0 (the JAX
    package's ``composite_pallas``). Differentiable in planes, rgb and
    bg."""
    return _PaddedComposite.apply(planes, rgb, valid, counts, bg, tiles_x,
                                  tile_w, tile_h)


def random_tables(seed: int, tiles_x: int = 8, tiles_y: int = 6,
                  tile_w: int = 16, tile_h: int = 16, k: int = 384):
    """Random padded tables as numpy arrays, for checking B4/B5 against
    their plain versions: :func:`ops.stream.random_stream`'s segments cut
    to K slots (its longest tiles overflow K), every seventh slot invalid.

    Returns dict(planes [6, T, K], rgb [T, K, 3], valid [T, K] f32,
    counts [T] i32 (before the cut), bg) plus the geometry."""
    import numpy as np

    from .stream import random_stream
    s = random_stream(seed, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
                      tile_h=tile_h, long_len=k + 100)
    t = tiles_x * tiles_y
    slot = np.arange(k)[None, :]
    live = slot < np.minimum(s["counts"], k)[:, None]             # [T, K]
    cols = np.where(live, s["seg_start"][:, None] + slot, 0)
    attrs = np.where(live[None], s["attrs"][:9, cols], 0.0)      # [9, T, K]
    valid = live & (slot % 7 != 3)
    assert s["tile_ids"].tolist() == list(range(t))
    return dict(planes=np.ascontiguousarray(attrs[:6], np.float32),
                rgb=np.ascontiguousarray(attrs[6:9].transpose(1, 2, 0),
                                         np.float32),
                valid=valid.astype(np.float32), counts=s["counts"],
                bg=s["bg"], tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h)
