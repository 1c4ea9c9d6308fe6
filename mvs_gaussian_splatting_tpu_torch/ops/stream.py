"""Instance-stream composite: the per-tile front-to-back alpha composite of
the packed instance stream (counterpart of the JAX package's
``ops/pallas/stream.py``).

Binning lays all tile instances out in one packed attribute array
``attrs [16, CAP + 128]`` (attribute rows × tile-sorted instances; tile
``t`` owns the columns ``[seg_start[t], seg_start[t] + counts[t])``). Rows:
0 x, 1 y, 2 conic_a, 3 conic_b, 4 conic_c, 5 opacity, 6 r, 7 g, 8 b; rows
9..15 are padding kept for the JAX package's layout.

:func:`composite_stream` launches the hand-written CUDA kernel
``csrc/stream_fwd.cu`` for CUDA tensors and runs its plain version for CPU
tensors. The kernels walk warps of compact 8×4 pixel blocks and skip an
entry for a warp its cull box misses (:func:`cull_box`), which changes no
output; they take any tile shape, walking a tile that one CTA cannot cover
as parts (:func:`tile_parts`). It is differentiable in ``attrs`` and ``bg``: its backward is
:func:`composite_stream_bwd`, which launches ``csrc/stream_bwd.cu`` or
``csrc/stream_bwd_fast.cu`` for CUDA tensors and runs its plain version for
CPU tensors. Two modes, as in the JAX package:

- exact (``fast=False``, B1 / B2): plain versions
  :func:`composite_stream_plain` / :func:`composite_stream_bwd_plain`;
- fast math (``fast=True``, B3, ``RasterConfig.fast_math``): plain
  versions :func:`composite_stream_fast_plain` /
  :func:`composite_stream_bwd_fast_plain`, which follow the JAX package's
  fast formulas (log-space transmittance, the moment-form pixel sums) in
  f32. The fast kernels are held to them within the JAX package's
  fast-mode contract (``tests/test_fast_math.py``), not to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS = 16
CHUNK = 128   # slack columns at the tail of the stream (JAX layout)

CTA_PIXELS = 1024    # a kernel's CTA runs one thread per pixel, this many
PART_SIDE = 32       # the side of a part, where a tile needs several
FAST_BWD_SIDE = 64   # B3b's one-part sides: its moments exact in TF32

# Kernel launches, per kernel: B1 and B3f by composite_stream, B2 and B3b
# by composite_stream_bwd (the CPU path counts none).
launches = 0
bwd_launches = 0
fast_launches = 0
fast_bwd_launches = 0


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
    why = tile_limit(tile_w, tile_h)
    if why:
        raise ValueError(why)


def tile_limit(tile_w: int, tile_h: int):
    """Why the composite kernels cannot take ``tile_w`` × ``tile_h`` tiles,
    or None: only an empty tile is refused (on every device, so that the
    CPU path refuses what the card would). Any other shape runs, as in the
    JAX package: a tile that one CTA cannot cover is walked as parts
    (:func:`tile_parts`)."""
    if tile_w > 0 and tile_h > 0:
        return None
    return f"tile {tile_w}x{tile_h} is empty: a tile needs a pixel"


def tile_parts(tile_w: int, tile_h: int, max_side: int = CTA_PIXELS):
    """(part_w, part_h, parts_x, parts_y): the grid of pixel parts a
    kernel's CTA walks one after another on a ``tile_w`` × ``tile_h`` tile,
    the mirror of ``csrc/stream_common.cuh:tile_parts``. One part, the tile
    itself, where it has at most CTA_PIXELS pixels and sides of at most
    ``max_side`` (FAST_BWD_SIDE for B3b, no limit for the others); else
    parts of min(side, PART_SIDE) pixels a side, the right and bottom ones
    cut to the tile."""
    if tile_w * tile_h <= CTA_PIXELS and max(tile_w, tile_h) <= max_side:
        return tile_w, tile_h, 1, 1
    w, h = min(tile_w, PART_SIDE), min(tile_h, PART_SIDE)
    return w, h, -(-tile_w // w), -(-tile_h // h)


def check_order(order, counts):
    """Refuse a tile order the kernels cannot walk safely: they read it as
    ``counts.numel()`` int64 tile indices on ``counts``' device (a
    permutation, as :func:`heaviest_first` gives; not checked, that would
    take a sort)."""
    if (order.dtype != torch.int64 or order.device != counts.device
            or order.shape != (counts.numel(),)):
        raise ValueError(f"order: want {counts.numel()} int64 tile indices "
                         f"on {counts.device}, got {order.dtype} "
                         f"{tuple(order.shape)} on {order.device}")


def heaviest_first(counts):
    """The order in which the six kernels walk the tiles: by count,
    descending (int64 tile indices), so that the last wave of CTAs holds
    the light tiles."""
    return torch.argsort(counts, descending=True)


def _composite_fwd(attrs, seg_start, counts, bg, tile_ids, tiles_x: int,
                   tile_w: int, tile_h: int, fast: bool, order):
    global launches, fast_launches
    _check(attrs, seg_start, counts, bg, tile_ids, tile_w, tile_h)
    if attrs.device.type == "cpu":
        plain = composite_stream_fast_plain if fast else composite_stream_plain
        return plain(attrs, seg_start, counts, bg, tile_ids, tiles_x, tile_w,
                     tile_h)
    if attrs.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {attrs.device}")
    from .. import kernels

    t, p = seg_start.shape[0], tile_w * tile_h
    out = torch.empty((t, p, 3), dtype=torch.float32, device=attrs.device)
    final_t = torch.empty((t, p), dtype=torch.float32, device=attrs.device)
    if t == 0:
        return out, final_t
    lib = kernels.library()
    name = "gs_stream_fwd_fast" if fast else "gs_stream_fwd"
    with torch.cuda.device(attrs.device):
        err = getattr(lib, name)(
            attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
            counts.data_ptr(), tile_ids.data_ptr(), order.data_ptr(),
            bg.data_ptr(), out.data_ptr(), final_t.data_ptr(), t, tiles_x,
            tile_w, tile_h,
            torch.cuda.current_stream(attrs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if fast:
        fast_launches += 1
    else:
        launches += 1
    return out, final_t


class _StreamComposite(torch.autograd.Function):
    """B1 / B3f forward, B2 / B3b backward; gradients flow to ``attrs`` and
    ``bg``. The tile order is taken once, for both kernels."""

    @staticmethod
    def forward(ctx, attrs, seg_start, counts, bg, tile_ids, tiles_x, tile_w,
                tile_h, fast):
        order = heaviest_first(counts) if counts.is_cuda else None
        out, final_t = _composite_fwd(attrs, seg_start, counts, bg, tile_ids,
                                      tiles_x, tile_w, tile_h, fast, order)
        ctx.geometry = (tiles_x, tile_w, tile_h)
        ctx.fast = fast
        ctx.order = order
        ctx.save_for_backward(attrs, seg_start, counts, bg, tile_ids, out,
                              final_t)
        return out, final_t

    @staticmethod
    def backward(ctx, g_out, g_tfin):
        attrs, seg_start, counts, bg, tile_ids, out, final_t = \
            ctx.saved_tensors
        gattrs, g_bg = composite_stream_bwd(
            attrs, seg_start, counts, bg, tile_ids, *ctx.geometry, out,
            final_t, g_out.contiguous(), g_tfin.contiguous(), fast=ctx.fast,
            order=ctx.order)
        return gattrs, None, None, g_bg, None, None, None, None, None


def composite_stream(attrs, seg_start, counts, bg, tile_ids, tiles_x: int,
                     tile_w: int, tile_h: int, fast: bool = False):
    """attrs [16, CAP+128] f32; seg_start/counts/tile_ids [T] i32 (tile_ids
    is the GLOBAL tile id of each local tile: it places the pixel grid);
    bg [3] f32 → (out [T, P, 3], final_T [T, P]), P = tile_w·tile_h.
    Differentiable in ``attrs`` and ``bg`` (see :func:`composite_stream_bwd`).
    ``fast``: the fast-math mode (B3), as ``RasterConfig.fast_math``."""
    return _StreamComposite.apply(attrs, seg_start, counts, bg, tile_ids,
                                  tiles_x, tile_w, tile_h, fast)


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
                         g_out, g_tfin, fast: bool = False, order=None):
    """Gradient of :func:`composite_stream`: the forward's inputs, its saved
    outputs (out [T, P, 3], final_T [T, P]) and their cotangents →
    (gattrs [16, CAP+128], g_bg [3]). ``order``: the forward's
    :func:`heaviest_first` of ``counts``, which B2 and B3b walk too (taken
    here when not given).

    gattrs is zero outside this call's segments, in the entries a tile never
    reaches before its early exit, and in rows 9..15. g_bg = Σ g_out·final_T
    is one reduction outside the kernel, as in the JAX package."""
    global bwd_launches, fast_bwd_launches
    _check(attrs, seg_start, counts, bg, tile_ids, tile_w, tile_h)
    t, p = seg_start.shape[0], tile_w * tile_h
    _check_bwd(t, p, out, final_t, g_out, g_tfin)
    if attrs.device.type == "cpu":
        plain = (composite_stream_bwd_fast_plain if fast
                 else composite_stream_bwd_plain)
        return plain(attrs, seg_start, counts, bg, tile_ids, tiles_x, tile_w,
                     tile_h, out, final_t, g_out, g_tfin)
    if attrs.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {attrs.device}")
    from .. import kernels

    # B2 visits only this call's segments: zeros elsewhere (subset calls,
    # tile-parallel shards)
    gattrs = torch.zeros_like(attrs)
    g_bg = torch.einsum("tpc,tp->c", g_out, final_t)
    if t == 0:
        return gattrs, g_bg
    if order is None:
        order = heaviest_first(counts)
    check_order(order, counts)
    name = "gs_stream_bwd_fast" if fast else "gs_stream_bwd"
    with torch.cuda.device(attrs.device):
        err = getattr(kernels.library(), name)(
            attrs.data_ptr(), attrs.shape[1], seg_start.data_ptr(),
            counts.data_ptr(), tile_ids.data_ptr(), order.data_ptr(),
            out.data_ptr(), final_t.data_ptr(), g_out.data_ptr(),
            g_tfin.data_ptr(), gattrs.data_ptr(), t, tiles_x, tile_w, tile_h,
            torch.cuda.current_stream(attrs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if fast:
        fast_bwd_launches += 1
    else:
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


def _tile_origin(tile_ids, tiles_x: int, tile_w: int, tile_h: int):
    """[T, 1] float32 tile centres (ox, oy) of the fast backward's moment
    form: the tile's first pixel plus half its size (integer division)."""
    tid = tile_ids.long()
    ox = (tid % tiles_x) * tile_w + tile_w // 2
    oy = (tid // tiles_x) * tile_h + tile_h // 2
    return (ox.to(torch.float32)[:, None], oy.to(torch.float32)[:, None])


def _fast_replay(attrs, seg_start, counts, tile_ids, tiles_x: int,
                 tile_w: int, tile_h: int):
    """Yields, entry by entry, the fast mode's per-(tile, pixel) terms of
    the JAX package's fast forward (``_chunk_include_lanes(fast=True)``):
    the transmittance as exp of the running sum of log(1 − α) over the
    contributing entries, ``include = contrib ∧ T_incl ≥ 1e-4`` (T_incl never
    rises, so no done flag), ``T_excl = T_incl / (1 − α)``. Each item is
    (k, col, in_seg, a [9, T, 1], dx, dy, g, alpha, include, t_incl, t_excl,
    live) with ``live`` the pixels still above 1e-4 before entry k."""
    dev = attrs.device
    f32 = torch.float32
    px, py = _pixel_grid(tile_ids, tiles_x, tile_w, tile_h)
    max_alpha = torch.tensor(0.99, dtype=f32, device=dev)
    width = attrs.shape[1]
    start = seg_start.long()
    cnt = torch.minimum(counts.long(), (width - start).clamp(min=0))
    log_t = torch.zeros(px.shape, dtype=f32, device=dev)
    log_min = float(np.log(np.float32(1e-4)))
    steps = int(cnt.max()) if cnt.numel() else 0
    for k in range(steps):
        in_seg = k < cnt                                        # [T]
        live = in_seg[:, None] & (log_t >= log_min)
        if k % 32 == 0 and not bool(live.any()):
            break
        col = (start + k).clamp(max=width - 1)
        a = attrs[:9, col][:, :, None]                          # [9, T, 1]
        dx = a[0] - px
        dy = a[1] - py
        power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
        g = torch.exp(power)
        alpha = torch.minimum(a[5] * g, max_alpha)
        contrib = (in_seg[:, None] & (power <= 0.0)
                   & (alpha >= 1.0 / 255.0))
        one_minus = torch.where(contrib, 1.0 - alpha, 1.0)
        log_t = log_t + torch.log(one_minus)
        t_incl = torch.exp(log_t)
        include = contrib & (t_incl >= 1e-4)
        yield (k, col, in_seg, a, dx, dy, g, alpha, include, t_incl,
               t_incl / one_minus, live)


def composite_stream_fast_plain(attrs, seg_start, counts, bg, tile_ids,
                                tiles_x: int, tile_w: int, tile_h: int, *,
                                count_visits: bool = False):
    """Plain PyTorch version of :func:`composite_stream` with ``fast=True``
    (B3f), same signature: the JAX package's fast forward in f32, entry by
    entry, vectorised over tiles and pixels. ``final_T`` is min(1, the
    smallest included T_incl), as the TPU kernel reduces it.
    ``count_visits=True`` also returns the (entry, pixel) pairs visited, as
    :func:`composite_stream_plain` counts them."""
    t, p = seg_start.shape[0], tile_w * tile_h
    acc = torch.zeros((t, p, 3), dtype=torch.float32, device=attrs.device)
    tmin = torch.full((t, p), torch.inf, device=attrs.device)
    visits = torch.zeros((t, p), dtype=torch.int64, device=attrs.device)
    for (_, _, _, a, _, _, _, alpha, include, t_incl, t_excl,
         live) in _fast_replay(attrs, seg_start, counts, tile_ids, tiles_x,
                               tile_w, tile_h):
        w = torch.where(include, alpha * t_excl, 0.0)
        acc = acc + w[:, :, None] * a[6:9, :, 0].T[:, None, :]
        tmin = torch.minimum(tmin, torch.where(include, t_incl, torch.inf))
        visits += live
    final_t = torch.clamp(tmin, max=1.0)
    out = acc + final_t[:, :, None] * bg
    if count_visits:
        return out, final_t, int(visits.amax(dim=1).sum()) * p if t else 0
    return out, final_t


def composite_stream_bwd_fast_plain(attrs, seg_start, counts, bg, tile_ids,
                                    tiles_x: int, tile_w: int, tile_h: int,
                                    out, final_t, g_out, g_tfin, *,
                                    count_visits: bool = False):
    """Plain PyTorch version of :func:`composite_stream_bwd` with
    ``fast=True`` (B3b), same signature: the JAX package's fast backward in
    f32. It replays :func:`composite_stream_fast_plain`, forms each entry's
    ``dpower`` and ``w`` per pixel, and reduces them over the tile's pixels
    as the moment form does (``stream.py:362-401``): six moments
    Σ dpower·{1, pxl, pyl, pxl², pxl·pyl, pyl²} around the tile centre and
    Σ g_out·w, then the closed-form per-entry gradients."""
    t = seg_start.shape[0]
    px, py = _pixel_grid(tile_ids, tiles_x, tile_w, tile_h)
    ox, oy = _tile_origin(tile_ids, tiles_x, tile_w, tile_h)
    pxl, pyl = px - ox, py - oy                                  # [T, P]
    phi = torch.stack([torch.ones_like(pxl), pxl, pyl, pxl * pxl,
                       pxl * pyl, pyl * pyl])                    # [6, T, P]
    g_dot_out = (g_out * out).sum(-1)
    tfin_term = g_tfin * final_t
    gattrs = torch.zeros_like(attrs)
    prefix = torch.zeros_like(final_t)
    visits = torch.zeros(final_t.shape, dtype=torch.int64, device=attrs.device)
    for (_, col, in_seg, a, _, _, g, alpha, include, _, t_excl,
         live) in _fast_replay(attrs, seg_start, counts, tile_ids, tiles_x,
                               tile_w, tile_h):
        w = torch.where(include, alpha * t_excl, 0.0)
        g_dot_rgb = sum(g_out[..., c] * a[6 + c] for c in range(3))
        prefix = prefix + w * g_dot_rgb
        one_minus = torch.where(include, 1.0 - alpha, 1.0)
        dalpha = torch.where(
            include, g_dot_rgb * t_excl - (g_dot_out - prefix) / one_minus
            - tfin_term / one_minus, 0.0)
        op = a[5]
        dpower = torch.where(include & (op * g < 0.99), dalpha * op * g, 0.0)
        s0, s1x, s1y, s2xx, s2xy, s2yy = (phi * dpower).sum(-1)  # [T] each
        xl, yl = a[0, :, 0] - ox[:, 0], a[1, :, 0] - oy[:, 0]
        ca, cb, cc, op = a[2, :, 0], a[3, :, 0], a[4, :, 0], op[:, 0]
        mx = xl * s0 - s1x
        my = yl * s0 - s1y
        rows = torch.stack([
            -(ca * mx + cb * my),
            -(cc * my + cb * mx),
            -0.5 * (xl * mx - xl * s1x + s2xx),
            -(xl * my - yl * s1x + s2xy),
            -0.5 * (yl * my - yl * s1y + s2yy),
            torch.where(op > 0.0, s0 / torch.where(op > 0.0, op, 1.0), 0.0),
            *(torch.sum(g_out[..., c] * w, -1) for c in range(3))])  # [9, T]
        gattrs[:9, col[in_seg]] = rows[:, in_seg]
        visits += live
    g_bg = torch.einsum("tpc,tp->c", g_out, final_t)
    if count_visits:
        p = tile_w * tile_h
        return gattrs, g_bg, int(visits.amax(dim=1).sum()) * p if t else 0
    return gattrs, g_bg


def cull_box(ca, cb, cc, op):
    """(hx, hy) float32 half-widths of each entry's cull box: the mirror in
    PyTorch of ``csrc/stream_common.cuh:cull_box`` (the same formula,
    margins and order of operations), for the CPU test of its
    conservativeness (``tests/test_torch_cull.py``). The kernels skip an
    entry for a warp whose pixel centres all lie outside [x − hx, x + hx] ×
    [y − hy, y + hy]; −inf: no box (op < 1/255), +inf: never culled."""
    f32 = torch.float32
    ca, cb, cc, op = (torch.as_tensor(a, dtype=f32) for a in (ca, cb, cc, op))
    ac = ca * cc
    det = ac - cb * cb
    big_l = (torch.fmax(torch.log(255.0 * op), torch.zeros_like(op))
             + 1e-3) * 1.002
    hx = torch.sqrt(2.0 * big_l * cc / det) * 1.001 + 1.0
    hy = torch.sqrt(2.0 * big_l * ca / det) * 1.001 + 1.0
    inf = torch.tensor(float("inf"), dtype=f32)
    whole = ~((ca > 0) & (cc > 0) & (det > 2.5e-3 * ac) & (hx < inf)
              & (hy < inf))
    hx, hy = torch.where(whole, inf, hx), torch.where(whole, inf, hy)
    none = ~(op >= torch.tensor(1.0 / 255.0, dtype=f32))
    return torch.where(none, -inf, hx), torch.where(none, -inf, hy)


def random_stream(seed: int, tiles_x: int = 12, tiles_y: int = 8,
                  tile_w: int = 16, tile_h: int = 16, long_len: int = 2700,
                  far: float = 0.0):
    """A random packed stream as numpy arrays, for checking the kernel
    against its plain version: empty, 1-entry, short and long (> 10 batches
    of 256) segments; every third tile translucent, the rest saturating.
    ``far``: the share of entries made far-centred wide splats (centres 150
    to 400 pixels from their tile, standard deviations 100 to 250 pixels),
    where the fast backward's moment form cancels most.

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
    if far:
        pick = np.flatnonzero(rng.rand(total) < far)
        ang = rng.uniform(0, 2 * np.pi, len(pick))
        dist = rng.uniform(150, 400, len(pick))
        attrs[0, pick] = cx[pick] + dist * np.cos(ang)
        attrs[1, pick] = cy[pick] + dist * np.sin(ang)
        sx, sy = rng.uniform(100, 250, (2, len(pick)))
        rho = rng.uniform(-0.5, 0.5, len(pick))
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        attrs[2, pick] = sy ** 2 / det
        attrs[3, pick] = -rho * sx * sy / det
        attrs[4, pick] = sx ** 2 / det
        attrs[5, pick] = rng.uniform(0.3, 0.9, len(pick))
    return dict(attrs=attrs, seg_start=seg_start.astype(np.int32),
                counts=counts.astype(np.int32),
                tile_ids=np.arange(t, dtype=np.int32),
                bg=np.array([0.2, 0.5, 0.9], np.float32), tiles_x=tiles_x,
                tile_w=tile_w, tile_h=tile_h)
