"""Plain PyTorch reference of one 3DGS render and one training step.

Written from the published operator (Kerbl et al. 2023, the CUDA
rasterizer's forward) and independent of the program under test: it imports
nothing of it. The semantics are the ones the program states:

- frustum cull at camera-space z <= 0.2, perspective divide with +1e-7;
- Σ2D = J W Σ3D Wᵀ Jᵀ + 0.3·I, J at the view ray clamped to 1.3·tan(fov/2);
- radius ceil(3·sqrt(λmax)), the sqrt argument floored at 0.1;
- tile rects: the alpha >= 1/255 level set's per-axis extents (+0.5 px,
  at least 1 px) intersected with the 3σ square, at tile granularity; a
  Gaussian reaches only the pixels of tiles inside its rect;
- global front-to-back order by camera depth (stable);
- power = −½(a·dx² + c·dy²) − b·dx·dy, skipped where > 0;
  alpha = min(0.99, opacity·exp(power)), skipped where < 1/255;
  a pixel ends, without the entry, where T·(1 − alpha) < 1e-4;
- SH degree 3 colour + 0.5, clamped at 0;
- loss (1 − λ)·L1 + λ·(1 − SSIM), SSIM with an 11×11 Gaussian window, σ 1.5;
- Adam with one global step count, bias correction and eps 1e-15 after
  the square root; the xyz learning rate on the log-linear schedule.

The composite runs over blocks of tiles, each padded to its longest list,
so that it fits beside 6.1 M Gaussians: a forward pass without gradients
gives the image, the loss gives its gradient, and a second pass per block
gives the gradients of the per-Gaussian screen-space rows by autograd,
which autograd then carries through the projection to the parameters.

Every function takes a ``dtype``: float32 is the reference; a lower one is
the control that the correctness limits must refuse.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class View(NamedTuple):
    """A camera as both sides get it: [4, 4] world→camera and clip←world
    matrices (column vectors), the centre [3], tan of the half fields of
    view, and the image size."""
    viewmatrix: torch.Tensor
    projmatrix: torch.Tensor
    campos: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    width: int
    height: int


class Screen(NamedTuple):
    table: torch.Tensor     # [N, 9]: x, y, conic a, b, c, opacity, r, g, b
    depth: torch.Tensor     # [N]
    rect_min: torch.Tensor  # [N, 2] int64 tile coords, inclusive
    rect_max: torch.Tensor  # [N, 2] exclusive
    mask: torch.Tensor      # [N] bool
    radius: Optional[torch.Tensor] = None  # [N] pixels, ceil(3·sqrt(λmax))


def sh_rgb(shs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Degree-3 SH colour [N, 3] of coefficients [N, 16, 3] at unit
    directions [N, 3], +0.5 and clamped at 0."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    basis = torch.stack([
        SH_C0 * torch.ones_like(x), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
        SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy)], dim=-1)
    rgb = (basis[:, :, None] * shs).sum(1) + 0.5
    return torch.clamp(rgb, min=0.0)


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], dim=-2)


def activate(raw: dict):
    """(scales, unit quaternions, opacities) of raw parameters."""
    q = raw["rotation"]
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return (torch.exp(raw["scaling"]), q / torch.clamp(n, min=1e-12),
            torch.sigmoid(raw["opacity"][:, 0]))


def project(xyz, opacity, scales, rotations, shs, view: View, tile_w: int,
            tile_h: int, ndc_offset=None, alive=None) -> Screen:
    """Screen-space rows of every Gaussian for one view (differentiable in
    every float input). Products are written as broadcast-multiply-sums in
    the order the rasterizer's description gives, so that no matrix
    product (and no TF32) is involved."""
    dt = xyz.dtype
    vm = view.viewmatrix.to(dt)
    pm = view.projmatrix.to(dt)
    W, H = view.width, view.height
    R_wc = vm[:3, :3]
    p_view = (xyz[:, None, :] * R_wc[None, :, :]).sum(-1) + vm[:3, 3]
    depth = p_view[:, 2]
    in_frustum = depth > 0.2
    p_hom = (xyz[:, None, :] * pm[None, :3, :3]).sum(-1) + pm[:3, 3]
    w_hom = (xyz * pm[3, :3]).sum(-1) + pm[3, 3]
    w_safe = torch.where(in_frustum, w_hom + 1e-7, 1.0)
    p_ndc = p_hom[:, :2] / w_safe[:, None]
    if ndc_offset is not None:
        p_ndc = p_ndc + ndc_offset.to(dt)
    xy = torch.stack([((p_ndc[:, 0] + 1.0) * W - 1.0) * 0.5,
                      ((p_ndc[:, 1] + 1.0) * H - 1.0) * 0.5], -1)

    L = quat_rotmat(rotations) * scales[:, None, :]
    cov3d = (L[:, :, None, :] * L[:, None, :, :]).sum(-1)
    tanx, tany = view.tanfovx.to(dt), view.tanfovy.to(dt)
    fx, fy = W / (2.0 * tanx), H / (2.0 * tany)
    z = torch.where(in_frustum, depth, 1.0)
    tx = torch.minimum(torch.maximum(p_view[:, 0] / z, -1.3 * tanx),
                       1.3 * tanx) * z
    ty = torch.minimum(torch.maximum(p_view[:, 1] / z, -1.3 * tany),
                       1.3 * tany) * z
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * tx / (z * z)], -1),
                     torch.stack([zero, fy / z, -fy * ty / (z * z)], -1)],
                    dim=-2)
    JW = (J[:, :, :, None] * R_wc[None, None, :, :]).sum(2)
    JWC = (JW[:, :, :, None] * cov3d[:, None, :, :]).sum(2)
    cov2d = (JWC[:, :, None, :] * JW[:, None, :, :]).sum(-1)
    cxx = cov2d[:, 0, 0] + 0.3
    cyy = cov2d[:, 1, 1] + 0.3
    cxy = cov2d[:, 0, 1]
    det = cxx * cyy - cxy * cxy
    ok = det != 0.0
    det_inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)
    mid = 0.5 * (cxx + cyy)
    sq = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1 = mid + sq
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lam1, mid - sq)))

    c0 = 2.0 * torch.log(torch.clamp(255.0 * opacity.detach(), min=1.0))
    rd = radius.detach()
    ext_x = torch.minimum(torch.clamp(torch.sqrt(c0 * cxx.detach()) + 0.5,
                                      min=1.0), rd)
    ext_y = torch.minimum(torch.clamp(torch.sqrt(c0 * cyy.detach()) + 0.5,
                                      min=1.0), rd)
    tiles_x, tiles_y = -(-W // tile_w), -(-H // tile_h)
    xyd = xy.detach()

    def edge(v, size, hi):
        return torch.clamp(torch.floor(v / size), 0, hi).long()

    rect_min = torch.stack([edge(xyd[:, 0] - ext_x, tile_w, tiles_x),
                            edge(xyd[:, 1] - ext_y, tile_h, tiles_y)], -1)
    rect_max = torch.stack([edge(xyd[:, 0] + ext_x + tile_w - 1, tile_w,
                                 tiles_x),
                            edge(xyd[:, 1] + ext_y + tile_h - 1, tile_h,
                                 tiles_y)], -1)
    span = torch.clamp(rect_max - rect_min, min=0)
    mask = (in_frustum & ok & (radius > 0) & (span[:, 0] * span[:, 1] > 0))
    if alive is not None:
        mask = mask & alive

    dirs = xyz - view.campos.to(dt)
    n2 = (dirs * dirs).sum(-1, keepdim=True)
    dirs = dirs / torch.sqrt(torch.clamp(n2, min=1e-16))
    rgb = sh_rgb(shs, dirs)
    table = torch.cat([xy, conic, opacity[:, None], rgb], 1)
    return Screen(table, depth, rect_min, rect_max, mask, rd)


class Lists(NamedTuple):
    """Per-tile lists in global depth order: ``gid`` [M] Gaussian rows,
    grouped by tile, ``start`` / ``count`` [T] into it."""
    gid: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor


def tile_lists(screen: Screen, width: int, height: int, tile_w: int,
               tile_h: int) -> Lists:
    """Every (tile, Gaussian) pair inside the Gaussian's rect, sorted by
    tile and then by the Gaussian's depth rank."""
    n = screen.depth.shape[0]
    dev = screen.depth.device
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    key = torch.where(screen.mask, screen.depth.detach().float(),
                      torch.full_like(screen.depth, math.inf,
                                      dtype=torch.float32))
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    span = torch.clamp(screen.rect_max - screen.rect_min, min=0)
    area = torch.where(screen.mask, span[:, 0] * span[:, 1], 0)
    gid = torch.repeat_interleave(torch.arange(n, device=dev), area)
    first = torch.cumsum(area, 0) - area
    local = torch.arange(gid.shape[0], device=dev) - first[gid]
    sx = span[gid, 0]
    tile = ((screen.rect_min[gid, 1] + local // sx) * tiles_x
            + screen.rect_min[gid, 0] + local % sx)
    order_key = torch.sort(tile * n + rank[gid])
    gid = gid[order_key.indices]
    count = torch.bincount(order_key.values // n,
                           minlength=tiles_x * tiles_y)
    return Lists(gid, torch.cumsum(count, 0) - count, count)


def _batches(lists: Lists, pixels: int, block_elems: int):
    """Tile blocks, heaviest first, of at most ``block_elems`` (pixel,
    slot) pairs each: (tile ids, their longest list)."""
    counts = lists.count.cpu()
    tiles = torch.argsort(counts, descending=True, stable=True)
    pos = 0
    while pos < tiles.shape[0]:
        k = max(int(counts[tiles[pos]]), 1)
        b = max(1, block_elems // (pixels * k))
        yield tiles[pos:pos + b].to(lists.gid.device), k
        pos += b


def _composite_block(rows, valid, tiles, tiles_x: int, tile_w: int,
                     tile_h: int, bg):
    """rows [B, K, 9], valid [B, K] → (colour [B, P, 3], included [B, P, K]
    bool, final T [B, P]) of the tiles ``tiles`` [B]."""
    dt = rows.dtype
    p = torch.arange(tile_w * tile_h, device=rows.device)
    px = ((tiles % tiles_x)[:, None] * tile_w + p % tile_w).to(dt)
    py = ((tiles // tiles_x)[:, None] * tile_h + p // tile_w).to(dt)
    dx = rows[:, None, :, 0] - px[:, :, None]
    dy = rows[:, None, :, 1] - py[:, :, None]
    a, b, c = rows[:, None, :, 2], rows[:, None, :, 3], rows[:, None, :, 4]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(rows[:, None, :, 5] * torch.exp(power),
                        max=ALPHA_MAX)
    contributes = valid[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(contributes, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    t_excl = torch.cumprod(torch.cat([torch.ones_like(one_minus[..., :1]),
                                      one_minus[..., :-1]], -1), -1)
    fail = contributes & (t_excl * one_minus < T_MIN)
    failed = fail.to(torch.int32)
    done_before = torch.cumsum(failed, -1) - failed
    include = contributes & (done_before == 0) & ~fail
    w = torch.where(include, alpha * t_excl, torch.zeros_like(alpha))
    colour = torch.bmm(w, rows[:, :, 6:9])
    t_final = torch.prod(torch.where(include, one_minus,
                                     torch.ones_like(one_minus)), -1)
    return colour + t_final[..., None] * bg.to(dt), include, t_final


def _block_rows(table, lists: Lists, tiles, k: int):
    """(rows [B, K, 9], valid [B, K], row index [B, K]) of a tile block;
    padded slots index the zero row ``table.shape[0]``."""
    n = table.shape[0]
    slot = torch.arange(k, device=table.device)
    valid = slot[None, :] < lists.count[tiles][:, None]
    pos = torch.clamp(lists.start[tiles][:, None] + slot,
                      max=max(lists.gid.shape[0] - 1, 0))
    idx = (torch.where(valid, lists.gid[pos], n) if lists.gid.shape[0]
           else torch.full_like(pos, n))
    padded = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    return padded[idx], valid, idx


def _place(img, block, tiles, tiles_x: int, tile_w: int, tile_h: int):
    """Write [B, P, C] tile pixels into img [C, H, W], dropping pixels
    past the image's edge."""
    H, W = img.shape[1:]
    p = torch.arange(tile_w * tile_h, device=img.device)
    px = (tiles % tiles_x)[:, None] * tile_w + p % tile_w
    py = (tiles // tiles_x)[:, None] * tile_h + p // tile_w
    inside = (px < W) & (py < H)
    flat = (py * W + px)[inside]
    img.view(img.shape[0], -1)[:, flat] = block[inside].T.to(img.dtype)


def _pick(grad, tiles, tiles_x: int, tile_w: int, tile_h: int):
    """[C, H, W] → [B, P, C] over a tile block, zero past the edge."""
    C, H, W = grad.shape
    p = torch.arange(tile_w * tile_h, device=grad.device)
    px = (tiles % tiles_x)[:, None] * tile_w + p % tile_w
    py = (tiles // tiles_x)[:, None] * tile_h + p // tile_w
    inside = (px < W) & (py < H)
    flat = torch.where(inside, py * W + px, 0)
    out = grad.reshape(C, -1)[:, flat].permute(1, 2, 0)
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def render(screen: Screen, lists: Lists, width: int, height: int,
           tile_w: int, tile_h: int, bg, block_elems: int):
    """(image [3, H, W], contributing pairs, Gaussians that contribute to
    some pixel) without gradients."""
    tiles_x = -(-width // tile_w)
    table = screen.table.detach()
    img = table.new_zeros((3, height, width))
    pairs = torch.zeros((), dtype=torch.int64, device=table.device)
    touched = torch.zeros(table.shape[0] + 1, dtype=torch.bool,
                          device=table.device)
    with torch.no_grad():
        for tiles, k in _batches(lists, tile_w * tile_h, block_elems):
            rows, valid, idx = _block_rows(table, lists, tiles, k)
            colour, include, _ = _composite_block(rows, valid, tiles,
                                                  tiles_x, tile_w, tile_h,
                                                  bg)
            _place(img, colour, tiles, tiles_x, tile_w, tile_h)
            inc = include.any(1)
            pairs += _inside_pairs(include, tiles, tiles_x, tile_w, tile_h,
                                   width, height)
            touched[idx[inc]] = True
    return img, int(pairs), int(touched[:-1].sum())


def _inside_pairs(include, tiles, tiles_x, tile_w, tile_h, width, height):
    p = torch.arange(tile_w * tile_h, device=include.device)
    px = (tiles % tiles_x)[:, None] * tile_w + p % tile_w
    py = (tiles // tiles_x)[:, None] * tile_h + p // tile_w
    inside = (px < width) & (py < height)
    return (include.sum(-1) * inside).sum()


def render_vjp(screen: Screen, lists: Lists, width: int, height: int,
               tile_w: int, tile_h: int, bg, g_img, block_elems: int):
    """Gradient [N, 9] of <g_img, image> with respect to the screen-space
    table, block by block."""
    tiles_x = -(-width // tile_w)
    table = screen.table.detach()
    g_table = table.new_zeros((table.shape[0] + 1, table.shape[1]))
    for tiles, k in _batches(lists, tile_w * tile_h, block_elems):
        rows, valid, idx = _block_rows(table, lists, tiles, k)
        rows.requires_grad_(True)
        with torch.enable_grad():
            colour, _, _ = _composite_block(rows, valid, tiles, tiles_x,
                                            tile_w, tile_h, bg)
            (g_rows,) = torch.autograd.grad(
                colour, rows, _pick(g_img, tiles, tiles_x, tile_w, tile_h))
        g_table.index_add_(0, idx.reshape(-1), g_rows.reshape(-1, 9))
    return g_table[:-1]


def _gauss_taps(dtype, device):
    g = torch.tensor([math.exp(-((x - 5) ** 2) / (2 * 1.5 ** 2))
                      for x in range(11)], dtype=torch.float64)
    return (g / g.sum()).to(dtype=dtype, device=device)


def ssim(img1, img2):
    """Mean SSIM of [C, H, W] images: 11×11 Gaussian window (σ 1.5), zero
    padding, C1 = 0.01², C2 = 0.03²."""
    taps = _gauss_taps(img1.dtype, img1.device)
    w2d = (taps[:, None] * taps[None, :])[None, None]

    def blur(x):
        return F.conv2d(x[:, None], w2d, padding=5)[:, 0]
    mu1, mu2 = blur(img1), blur(img2)
    s11 = blur(img1 * img1) - mu1 * mu1
    s22 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))
    return m.mean()


def loss_fn(img, gt, lambda_dssim: float, rows: Optional[int] = None):
    """(1 − λ)·L1 + λ·(1 − SSIM); ``rows`` keeps only the image's first
    rows (a fault the correctness check must refuse)."""
    if rows is not None:
        img, gt = img[:, :rows], gt[:, :rows]
    l1 = (img - gt).abs().mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(img, gt))


def xyz_lr(step: int, opt: dict, spatial_lr_scale: float) -> float:
    """The xyz learning rate on its log-linear schedule (no delay)."""
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    lo = math.log(opt["position_lr_init"] * spatial_lr_scale)
    hi = math.log(opt["position_lr_final"] * spatial_lr_scale)
    return math.exp(lo * (1 - t) + hi * t)


def group_lr(key: str, step: int, opt: dict, spatial_lr_scale: float):
    return {"xyz": xyz_lr(step, opt, spatial_lr_scale),
            "f_dc": opt["feature_lr"], "f_rest": opt["feature_lr"] / 20.0,
            "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"],
            "opacity": opt["opacity_lr"],
            "dirs_prob": opt["growdirs_lr"]}[key]


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int,
         step: int, opt: dict, spatial_lr_scale: float):
    """One Adam step over every leaf; returns (params, mu, nu)."""
    b1, b2, eps = 0.9, 0.999, 1e-15
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = b1 * mu[k] + (1 - b1) * g
        v = b2 * nu[k] + (1 - b2) * (g * g)
        lr = group_lr(k, step, opt, spatial_lr_scale)
        new_p[k] = p - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        new_m[k], new_v[k] = m, v
    return new_p, new_m, new_v


def scrub(grads: dict) -> dict:
    """Rows carrying any non-finite gradient get a zero gradient."""
    finite = None
    for g in grads.values():
        f = torch.isfinite(g).reshape(g.shape[0], -1).all(-1)
        finite = f if finite is None else finite & f
    return {k: torch.where(finite.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                           torch.zeros_like(g)) for k, g in grads.items()}
