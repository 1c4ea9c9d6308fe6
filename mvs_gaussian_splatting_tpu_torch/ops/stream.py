"""Instance-stream composite: the per-tile front-to-back alpha composite of
the packed instance stream (counterpart of the JAX package's
``ops/pallas/stream.py``).

Binning lays all tile instances out in one packed attribute array
``attrs [16, CAP + 128]`` (attribute rows × tile-sorted instances; tile
``t`` owns the columns ``[seg_start[t], seg_start[t] + counts[t])``). Rows:
0 x, 1 y, 2 conic_a, 3 conic_b, 4 conic_c, 5 opacity, 6 r, 7 g, 8 b; rows
9..15 are padding kept for the JAX package's layout.

:func:`composite_stream` launches the hand-written CUDA kernel
``csrc/stream_fwd.cu`` for CUDA tensors and runs
:func:`composite_stream_plain` for CPU tensors. It is differentiable in
``attrs`` and ``bg``: its backward is :func:`composite_stream_bwd`, which
launches ``csrc/stream_bwd.cu`` for CUDA tensors and runs
:func:`composite_stream_bwd_plain` for CPU tensors. Both composite in exact
mode only; the fast-math mode (B3 in ``ROADMAP.md``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS = 16
CHUNK = 128   # slack columns at the tail of the stream (JAX layout)

# Kernel launches: the forward by composite_stream, the backward by
# composite_stream_bwd (the CPU path counts neither).
launches = 0
bwd_launches = 0


def _check(attrs, seg_start, counts, bg, tile_ids, tile_w, tile_h):
    dev = attrs.device
    if attrs.dim() != 2 or attrs.shape[0] != ROWS:
        raise ValueError(f"attrs must be [{ROWS}, CAP], got {tuple(attrs.shape)}")
    if attrs.dtype != torch.float32 or bg.dtype != torch.float32:
        raise TypeError("attrs and bg must be float32")
    if bg.shape != (3,):
        raise ValueError(f"bg must be [3], got {tuple(bg.shape)}")
    t = seg_start.shape[0]
    for name, a in (("seg_start", seg_start), ("counts", counts),
                    ("tile_ids", tile_ids)):
        if a.dtype != torch.int32 or a.shape != (t,):
            raise ValueError(f"{name} must be int32 [{t}], got "
                             f"{a.dtype} {tuple(a.shape)}")
    for a in (attrs, seg_start, counts, bg, tile_ids):
        if a.device != dev:
            raise ValueError("all inputs must be on one device")
        if not a.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if not 0 < tile_w * tile_h <= 1024:
        raise ValueError(f"tile_w*tile_h = {tile_w * tile_h}: the kernel runs "
                         "one thread per pixel, at most 1024 per tile")


def _composite_fwd(attrs, seg_start, counts, bg, tile_ids, tiles_x: int,
                   tile_w: int, tile_h: int):
    global launches
    _check(attrs, seg_start, counts, bg, tile_ids, tile_w, tile_h)
    if attrs.device.type == "cpu":
        return composite_stream_plain(attrs, seg_start, counts, bg, tile_ids,
                                      tiles_x, tile_w, tile_h)
    if attrs.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {attrs.device}")
    from .. import kernels

    t, p = seg_start.shape[0], tile_w * tile_h
    out = torch.empty((t, p, 3), dtype=torch.float32, device=attrs.device)
    final_t = torch.empty((t, p), dtype=torch.float32, device=attrs.device)
    if t == 0:
        return out, final_t
    with torch.cuda.device(attrs.device):
        err = kernels.library().gs_stream_fwd(
            attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
            counts.data_ptr(), tile_ids.data_ptr(), bg.data_ptr(),
            out.data_ptr(), final_t.data_ptr(), t, tiles_x, tile_w, tile_h,
            torch.cuda.current_stream(attrs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gs_stream_fwd launch failed: CUDA error {err}")
    launches += 1
    return out, final_t


class _StreamComposite(torch.autograd.Function):
    """B1 forward, B2 backward; gradients flow to ``attrs`` and ``bg``."""

    @staticmethod
    def forward(ctx, attrs, seg_start, counts, bg, tile_ids, tiles_x, tile_w,
                tile_h):
        out, final_t = _composite_fwd(attrs, seg_start, counts, bg, tile_ids,
                                      tiles_x, tile_w, tile_h)
        ctx.geometry = (tiles_x, tile_w, tile_h)
        ctx.save_for_backward(attrs, seg_start, counts, bg, tile_ids, out,
                              final_t)
        return out, final_t

    @staticmethod
    def backward(ctx, g_out, g_tfin):
        attrs, seg_start, counts, bg, tile_ids, out, final_t = \
            ctx.saved_tensors
        gattrs, g_bg = composite_stream_bwd(
            attrs, seg_start, counts, bg, tile_ids, *ctx.geometry, out,
            final_t, g_out.contiguous(), g_tfin.contiguous())
        return gattrs, None, None, g_bg, None, None, None, None


def composite_stream(attrs, seg_start, counts, bg, tile_ids, tiles_x: int,
                     tile_w: int, tile_h: int):
    """attrs [16, CAP+128] f32; seg_start/counts/tile_ids [T] i32 (tile_ids
    is the GLOBAL tile id of each local tile: it places the pixel grid);
    bg [3] f32 → (out [T, P, 3], final_T [T, P]), P = tile_w·tile_h.
    Differentiable in ``attrs`` and ``bg`` (see :func:`composite_stream_bwd`)."""
    return _StreamComposite.apply(attrs, seg_start, counts, bg, tile_ids,
                                  tiles_x, tile_w, tile_h)


def _check_bwd(t, p, out, final_t, g_out, g_tfin):
    dev = out.device
    for name, a, shape in (("out", out, (t, p, 3)), ("final_t", final_t, (t, p)),
                           ("g_out", g_out, (t, p, 3)),
                           ("g_tfin", g_tfin, (t, p))):
        if a.shape != shape or a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")


def composite_stream_bwd(attrs, seg_start, counts, bg, tile_ids,
                         tiles_x: int, tile_w: int, tile_h: int, out, final_t,
                         g_out, g_tfin):
    """Gradient of :func:`composite_stream`: the forward's inputs, its saved
    outputs (out [T, P, 3], final_T [T, P]) and their cotangents →
    (gattrs [16, CAP+128], g_bg [3]).

    gattrs is zero outside this call's segments, in the entries a tile never
    reaches before its early exit, and in rows 9..15. g_bg = Σ g_out·final_T
    is one reduction outside the kernel, as in the JAX package."""
    global bwd_launches
    _check(attrs, seg_start, counts, bg, tile_ids, tile_w, tile_h)
    t, p = seg_start.shape[0], tile_w * tile_h
    _check_bwd(t, p, out, final_t, g_out, g_tfin)
    if attrs.device.type == "cpu":
        return composite_stream_bwd_plain(attrs, seg_start, counts, bg,
                                          tile_ids, tiles_x, tile_w, tile_h,
                                          out, final_t, g_out, g_tfin)
    if attrs.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {attrs.device}")
    if p % 32:
        raise ValueError(f"tile_w*tile_h = {p}: the backward kernel reduces "
                         "over whole warps, so it must be a multiple of 32")
    from .. import kernels

    gattrs = torch.zeros_like(attrs)
    g_bg = torch.einsum("tpc,tp->c", g_out, final_t)
    if t == 0:
        return gattrs, g_bg
    with torch.cuda.device(attrs.device):
        err = kernels.library().gs_stream_bwd(
            attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
            counts.data_ptr(), tile_ids.data_ptr(), out.data_ptr(),
            final_t.data_ptr(), g_out.data_ptr(), g_tfin.data_ptr(),
            gattrs.data_ptr(), t, tiles_x, tile_w, tile_h,
            torch.cuda.current_stream(attrs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gs_stream_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return gattrs, g_bg


def _pixel_grid(tile_ids, tiles_x: int, tile_w: int, tile_h: int):
    """[T, P] float32 pixel coordinates of each tile's pixels."""
    flat = torch.arange(tile_w * tile_h, device=tile_ids.device)
    tid = tile_ids.long()
    px = ((tid % tiles_x) * tile_w)[:, None] + (flat % tile_w)[None, :]
    py = ((tid // tiles_x) * tile_h)[:, None] + (flat // tile_w)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def composite_stream_plain(attrs, seg_start, counts, bg, tile_ids,
                           tiles_x: int, tile_w: int, tile_h: int, *,
                           count_visits: bool = False):
    """Plain PyTorch version of :func:`composite_stream`, same signature.

    Walks every tile's segment in order, one entry per step, vectorised
    over tiles and pixels, with the kernel's arithmetic in the kernel's
    order. ``count_visits=True`` also returns the number of (entry, pixel)
    pairs the tiles visit before their early exit: for each tile, P times
    the entries its slowest pixel consumes (the terminating entry included).
    """
    dev = attrs.device
    t, p = seg_start.shape[0], tile_w * tile_h
    f32 = torch.float32
    px, py = _pixel_grid(tile_ids, tiles_x, tile_w, tile_h)
    max_alpha = torch.tensor(0.99, dtype=f32, device=dev)
    min_alpha = torch.tensor(1.0 / 255.0, dtype=f32, device=dev)
    min_trans = torch.tensor(1e-4, dtype=f32, device=dev)

    width = attrs.shape[1]
    start = seg_start.long()
    cnt = torch.minimum(counts.long(), (width - start).clamp(min=0))
    trans = torch.ones((t, p), dtype=f32, device=dev)
    acc = torch.zeros((t, p, 3), dtype=f32, device=dev)
    done = torch.zeros((t, p), dtype=torch.bool, device=dev)
    visits = torch.zeros((t, p), dtype=torch.int64, device=dev)
    steps = int(cnt.max()) if t else 0
    for k in range(steps):
        live = (k < cnt)[:, None] & ~done
        if k % 32 == 0 and not bool(live.any()):
            break
        a = attrs[:9, (start + k).clamp(max=width - 1)]        # [9, T]
        x, y, ca, cb, cc, op = (a[i][:, None] for i in range(6))
        rgb = a[6:9].T[:, None, :]                             # [T, 1, 3]
        dx = x - px
        dy = y - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.minimum(op * torch.exp(power), max_alpha)
        contrib = live & (power <= 0.0) & (alpha >= min_alpha)
        nxt = trans * (1.0 - alpha)
        fail = contrib & (nxt < min_trans)
        include = contrib & ~fail
        w = torch.where(include, alpha * trans, 0.0)
        acc = acc + w[:, :, None] * rgb
        trans = torch.where(include, nxt, trans)
        done = done | fail
        visits += live
    out = acc + trans[:, :, None] * bg
    if count_visits:
        return out, trans, int(visits.amax(dim=1).sum()) * p if t else 0
    return out, trans


def composite_stream_bwd_plain(attrs, seg_start, counts, bg, tile_ids,
                               tiles_x: int, tile_w: int, tile_h: int, out,
                               final_t, g_out, g_tfin, *,
                               count_visits: bool = False):
    """Plain PyTorch version of :func:`composite_stream_bwd`, same signature.

    Replays the forward entry by entry, vectorised over tiles and pixels,
    with the kernel's arithmetic in the kernel's order; only the sum over a
    tile's pixels is taken in another order. ``count_visits=True`` also
    returns the (entry, pixel) pairs visited, as
    :func:`composite_stream_plain` counts them."""
    dev = attrs.device
    t = seg_start.shape[0]
    f32 = torch.float32
    px, py = _pixel_grid(tile_ids, tiles_x, tile_w, tile_h)
    max_alpha = torch.tensor(0.99, dtype=f32, device=dev)
    gr, gg, gb = g_out[..., 0], g_out[..., 1], g_out[..., 2]
    g_dot_out = (gr * out[..., 0] + gg * out[..., 1]) + gb * out[..., 2]
    tfin_term = g_tfin * final_t

    width = attrs.shape[1]
    start = seg_start.long()
    cnt = torch.minimum(counts.long(), (width - start).clamp(min=0))
    gattrs = torch.zeros_like(attrs)
    trans = torch.ones_like(final_t)
    prefix = torch.zeros_like(final_t)
    done = torch.zeros(final_t.shape, dtype=torch.bool, device=dev)
    visits = torch.zeros(final_t.shape, dtype=torch.int64, device=dev)
    steps = int(cnt.max()) if t else 0
    for k in range(steps):
        in_seg = k < cnt                                        # [T]
        live = in_seg[:, None] & ~done
        if k % 32 == 0 and not bool(live.any()):
            break
        col = (start + k).clamp(max=width - 1)
        a = attrs[:9, col]                                      # [9, T]
        x, y, ca, cb, cc, op, r, gc, b = (a[i][:, None] for i in range(9))
        dx = x - px
        dy = y - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        g = torch.exp(power)
        raw = op * g
        alpha = torch.minimum(raw, max_alpha)
        contrib = live & (power <= 0.0) & (alpha >= 1.0 / 255.0)
        one_minus = 1.0 - alpha
        nxt = trans * one_minus
        fail = contrib & (nxt < 1e-4)
        include = contrib & ~fail
        w = alpha * trans
        g_dot_rgb = (gr * r + gg * gc) + gb * b
        prefix = torch.where(include, prefix + w * g_dot_rgb, prefix)
        dalpha = ((g_dot_rgb * trans - (g_dot_out - prefix) / one_minus)
                  - tfin_term / one_minus)
        slope = include & (raw < 0.99)
        dpower = torch.where(slope, dalpha * op * g, 0.0)
        rows = torch.stack([
            dpower * -(ca * dx + cb * dy),
            dpower * -(cc * dy + cb * dx),
            dpower * (-0.5 * dx * dx),
            dpower * (-dx * dy),
            dpower * (-0.5 * dy * dy),
            torch.where(slope, dalpha * g, 0.0),
            torch.where(include, gr * w, 0.0),
            torch.where(include, gg * w, 0.0),
            torch.where(include, gb * w, 0.0),
        ])                                                      # [9, T, P]
        sums = rows.sum(-1)                                     # [9, T]
        # a segment's columns are written while any of its pixels is live,
        # as the kernel writes every entry of a batch it runs
        seg_live = in_seg & live.any(1)
        gattrs[:9, col[seg_live]] = sums[:, seg_live]
        trans = torch.where(include, nxt, trans)
        done = done | fail
        visits += live
    g_bg = torch.einsum("tpc,tp->c", g_out, final_t)
    if count_visits:
        p = tile_w * tile_h
        return gattrs, g_bg, int(visits.amax(dim=1).sum()) * p if t else 0
    return gattrs, g_bg


def random_stream(seed: int, tiles_x: int = 12, tiles_y: int = 8,
                  tile_w: int = 16, tile_h: int = 16, long_len: int = 2700):
    """A random packed stream as numpy arrays, for checking the kernel
    against its plain version: empty, 1-entry, short and long (> 10 batches
    of 256) segments; every third tile translucent, the rest saturating.

    Returns dict(attrs, seg_start, counts, tile_ids, bg) plus the geometry
    (tiles_x, tile_w, tile_h)."""
    rng = np.random.RandomState(seed)
    t = tiles_x * tiles_y
    counts = rng.randint(2, 300, t)
    counts[0], counts[1], counts[2] = 0, 1, long_len
    counts[3] = long_len + 333
    counts[rng.choice(np.arange(4, t), min(3, t - 4), replace=False)] = 0
    seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    total = int(counts.sum())
    cap = total + (-total) % CHUNK
    attrs = np.zeros((ROWS, cap + CHUNK), np.float32)
    tid = np.repeat(np.arange(t), counts)
    cx = (tid % tiles_x) * tile_w + tile_w / 2
    cy = (tid // tiles_x) * tile_h + tile_h / 2
    attrs[0, :total] = cx + rng.uniform(-20, 20, total)
    attrs[1, :total] = cy + rng.uniform(-20, 20, total)
    sx, sy = rng.uniform(1, 12, total), rng.uniform(1, 12, total)
    rho = rng.uniform(-0.8, 0.8, total)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    attrs[2, :total] = sy ** 2 / det                   # conic of the
    attrs[3, :total] = -rho * sx * sy / det            # covariance
    attrs[4, :total] = sx ** 2 / det                   # [[sx², ρsxsy], …]
    dim = (tid % 3) == 0
    attrs[5, :total] = np.where(dim, rng.uniform(0.002, 0.05, total),
                                rng.uniform(0.05, 1.0, total))
    attrs[6:9, :total] = rng.uniform(0, 1, (3, total))
    return dict(attrs=attrs, seg_start=seg_start.astype(np.int32),
                counts=counts.astype(np.int32),
                tile_ids=np.arange(t, dtype=np.int32),
                bg=np.array([0.2, 0.5, 0.9], np.float32), tiles_x=tiles_x,
                tile_w=tile_w, tile_h=tile_h)
