// Per-entry arithmetic shared by the composite kernels: fwd_body.cuh (B1
// and B3f in stream_fwd.cu, B4 in padded_fwd.cu), stream_bwd_fast.cu (B3b)
// and exact_bwd.cuh (B2 in stream_bwd.cu, B5 in padded_bwd.cu); and the
// tile geometry, pixel parts, entry-major staging and per-warp cull that
// all six share (the end of the file).
//
// A backward kernel replays its forward and takes the forward's include and
// terminate decisions from this replay. If one decision or one w differed
// from the forward's by a rounding, g.out - S_k would stop matching the
// saved out and the gradient would go wrong without any NaN. So a forward
// and its backward call the same inline functions below, and every
// operation in them is pinned with an explicit intrinsic, so that nvcc has
// no contraction choice to make differently in two kernels:
//   alpha (both modes): __fmul_rn / __fadd_rn / __fsub_rn, never contracted
//     into FMAs, and the full-precision expf: the rounding of the JAX
//     expression as written (build without --use_fast_math). Its 1/255
//     threshold decides which entries count, and an entry that flips moves
//     its pixel by up to 1/255 of a colour: with __expf in the fast mode, a
//     real view's fast image on an H100 moved 2.1e-3 from its plain
//     version, above the fast mode's 2e-3 contract, so alpha is exact in
//     both modes;
//   transmittance and colour sums: exact mode as written; fast mode T -
//     alpha T and the sums as one __fmaf_rn each. The 1e-4 threshold on T
//     ends a pixel, and the entry left out there weighs up to
//     alpha 1e-4 / (1 - alpha), 1e-2 at alpha = 0.99: a flip of it is far
//     outside the contract, so the fast plain version
//     (ops/stream.py:_fast_replay) takes T with this rounding too, and the
//     two end every pixel on the same entry.
//
// Semantics (both modes): power = -0.5 (a dx^2 + c dy^2) - b dx dy,
// alpha = min(0.99, op exp(power)); the entry contributes iff power <= 0
// and alpha >= 1/255, and is included iff T (1 - alpha) >= 1e-4. The first
// contributing entry that fails that test is left out and ends the pixel.

#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace gs {

constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinTransmittance = 1e-4f;

// One entry seen from one pixel.
struct Entry {
  float dx, dy;  // entry centre minus pixel centre
  float g;       // exp(power)
  float raw;     // op * g, before the 0.99 clamp
  float alpha;   // min(0.99, raw)
};

// Fills e and returns whether the entry contributes at (px, py). The exp
// is taken whatever the sign of power (e is read only when this returns
// true), so that a warp issues one compare and one branch per pair: for a
// live pair power > 0 almost never holds, the conic being positive
// definite.
__device__ __forceinline__ bool entry_alpha(float x, float y, float ca,
                                            float cb, float cc, float op,
                                            float px, float py, Entry& e) {
  e.dx = __fsub_rn(x, px);
  e.dy = __fsub_rn(y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, e.dx), e.dx),
                               __fmul_rn(__fmul_rn(cc, e.dy), e.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, e.dx), e.dy));
  e.g = expf(power);
  e.raw = __fmul_rn(op, e.g);
  // min(0.99, raw) that keeps a NaN, as jnp.minimum / torch.minimum do
  e.alpha = e.raw > kMaxAlpha ? kMaxAlpha : e.raw;
  return (power <= 0.0f) & (e.alpha >= kMinAlpha);
}

// Transmittance after an entry: T (1 - alpha); in fast mode T - alpha T
// with one rounding.
template <bool kFast>
__device__ __forceinline__ float transmit(float trans, float alpha) {
  return kFast ? __fmaf_rn(-alpha, trans, trans)
               : __fmul_rn(trans, __fsub_rn(1.0f, alpha));
}

// acc + w c
template <bool kFast>
__device__ __forceinline__ float accumulate(float acc, float w, float c) {
  return kFast ? __fmaf_rn(w, c, acc) : __fadd_rn(acc, __fmul_rn(w, c));
}

// --- Tile geometry and the per-warp cull ---
//
// Warps as compact pixel blocks: warp w of a tile covers the kBlockW x
// kBlockH block (w % nbx, w / nbx), nbx = ceil(tile_w / kBlockW), so that
// fewer of its lanes sit outside a splat than in a 32-pixel row. A block
// that overhangs the tile masks its lanes outside it (done from the start,
// writing nothing). Where the blocks would need more than 1024 threads (a
// tile only 1-3 pixels tall or narrow, say 512 x 2), warp w takes the
// pixels 32 w .. 32 w + 31 in row-major order instead. Output indexing is by
// pixel p = y tile_w + x either way.
//
// A CTA runs one thread per pixel, at most kCtaPixels. A tile that one CTA
// cannot cover (more pixels, or for B3b a side over 64) is walked by its CTA
// as a grid of parts, one after another (tile_parts): each part is laid out
// in warps as a tile of its own shape would be, walks the tile's whole
// segment (re-staged) and writes its pixels at their places in the tile; a
// backward's first part writes each entry's sums and later parts add
// theirs, in part order, so two launches give the same bits and no
// instance slot is written by two CTAs. A tile within the limits is one
// part and runs the kernels' one-part instantiation (kParts = false), the
// code of a kernel without parts.
constexpr int kBlockW = 8;
constexpr int kBlockH = 4;
constexpr int kCtaPixels = 1024;
constexpr int kPartSide = 32;

// A tile's part grid: the nominal part shape (w x h), parts across (nx)
// and in all (n).
struct Parts {
  int w, h, nx, n;
};

// The part grid of a tile_w x tile_h tile for a kernel whose one part may
// have sides of at most max_side: the tile itself where it has at most
// kCtaPixels pixels and such sides, else parts of min(side, kPartSide)
// pixels a side (smaller at the right and bottom edges).
__host__ __device__ __forceinline__ Parts tile_parts(int tile_w, int tile_h,
                                                     int max_side) {
  if (tile_w * tile_h <= kCtaPixels && tile_w <= max_side &&
      tile_h <= max_side)
    return {tile_w, tile_h, 1, 1};
  const int w = tile_w < kPartSide ? tile_w : kPartSide;
  const int h = tile_h < kPartSide ? tile_h : kPartSide;
  const int nx = (tile_w + w - 1) / w;
  return {w, h, nx, nx * ((tile_h + h - 1) / h)};
}

// One part: its origin (x0, y0) in the tile and its shape (w x h).
struct Part {
  int x0, y0, w, h;
};

// Part i of the grid g of a tile_w x tile_h tile.
__device__ __forceinline__ Part part_at(const Parts& g, int i, int tile_w,
                                        int tile_h) {
  const int x0 = (i % g.nx) * g.w;
  const int y0 = (i / g.nx) * g.h;
  return {x0, y0, min(g.w, tile_w - x0), min(g.h, tile_h - y0)};
}

__host__ __device__ __forceinline__ bool compact_blocks(int tile_w,
                                                        int tile_h) {
  return ((tile_w + kBlockW - 1) / kBlockW) *
             ((tile_h + kBlockH - 1) / kBlockH) * 32 <= 1024;
}

// Threads (whole warps) of a tile's CTA.
__host__ __device__ __forceinline__ int tile_threads(int tile_w, int tile_h) {
  return compact_blocks(tile_w, tile_h)
             ? ((tile_w + kBlockW - 1) / kBlockW) *
                   ((tile_h + kBlockH - 1) / kBlockH) * 32
             : (tile_w * tile_h + 31) / 32 * 32;
}

// Pixel (x, y) in the tile of thread `tid`, and whether it is one.
__device__ __forceinline__ bool thread_pixel(int tid, int tile_w, int tile_h,
                                             bool compact, int& x, int& y) {
  if (compact) {
    const int warp = tid >> 5, lane = tid & 31;
    const int nbx = (tile_w + kBlockW - 1) / kBlockW;
    x = (warp % nbx) * kBlockW + (lane % kBlockW);
    y = (warp / nbx) * kBlockH + (lane / kBlockW);
    return x < tile_w && y < tile_h;
  }
  x = tid % tile_w;
  y = tid / tile_w;
  return tid < tile_w * tile_h;
}

// The pixel centres a warp covers, as a rectangle: centre (cx, cy) and
// half extents (ex, ey), all exact (halves of integers). A warp of a whole
// tile holds a pixel (its lane 0); a warp past the blocks of an edge part
// holds none, and its rectangle (taken in floats, so that no int sum
// overflows) is never consulted: its lanes are done from the start.
struct Rect {
  float cx, cy, ex, ey;
};

__device__ __forceinline__ Rect warp_rect(bool valid, int px, int py) {
  const unsigned all = 0xffffffffu;
  const float x0 = static_cast<float>(
      __reduce_min_sync(all, valid ? px : INT_MAX));
  const float x1 = static_cast<float>(
      __reduce_max_sync(all, valid ? px : INT_MIN));
  const float y0 = static_cast<float>(
      __reduce_min_sync(all, valid ? py : INT_MAX));
  const float y1 = static_cast<float>(
      __reduce_max_sync(all, valid ? py : INT_MIN));
  return {0.5f * (x0 + x1), 0.5f * (y0 + y1), 0.5f * (x1 - x0),
          0.5f * (y1 - y0)};
}

// Staged entries are entry-major, 12 floats (three float4) each:
//   {x, y, hx, hy}, {conic a, b, c, opacity}, {r, g, b, unused},
// with (hx, hy) the half-widths of the entry's cull box (cull_box).
constexpr int kSlot = 12;

// Starts copying one float from device memory at `src` to shared memory at
// `dst` with cp.async; it lands by the calling thread's cp.async.wait_all.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src));
}

// Starts copying attribute rows 0-8 of the entry at `src` (rows `stride`
// floats apart) into `slot`; stage_box reads them after the calling
// thread's cp.async.wait_all.
__device__ __forceinline__ void stage_async(float* slot, const float* src,
                                            long long stride) {
#pragma unroll
  for (int r = 0; r < 9; ++r)  // rows 0-1 to floats 0-1, 2-8 to 4-10
    copy_async(slot + (r < 2 ? r : r + 2), src + r * stride);
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The half-widths (hx, hy) of an axis-aligned box around the entry's
// centre outside which it contributes to no pixel: alpha >= 1/255 needs
// op e^power >= 1/255 (the 0.99 clamp only lowers alpha), that is, with
// power = -Q / 2, Q = a dx^2 + 2 b dx dy + c dy^2 <= 2 L, L = ln(255 op),
// an ellipse whose extents are sqrt(2 L c / det) and sqrt(2 L a / det),
// det = a c - b^2. The box is widened so that rounding never culls a pair
// the pinned arithmetic above includes:
//   - the computed power may differ from -Q / 2 by about 7 u Q / (1 - rho)
//     (u = 2^-24, rho = |b| / sqrt(a c): the terms of Q cancel as rho -> 1),
//     which is at most 8.4e-4 of Q where rho <= 0.999, so L is raised by
//     1e-3 (exp and the op product) and scaled by 1.002;
//   - the half-widths get 1e-3 of relative slack (det's rounding, at most
//     ~1e-4 of it for rho <= 0.999) and 1 px (rounding of the centre and
//     of the box test).
// No box, (hx, hy) = (-inf, -inf), where op < 1/255 (as a float compare,
// NaN included: such an entry never contributes). The whole plane, (+inf,
// +inf), where a <= 0, c <= 0, rho > 0.999 (det <= 2.5e-3 a c) or anything
// is not finite. ops/stream.py:cull_box is this function in PyTorch, and
// tests/test_torch_cull.py holds it against the pinned arithmetic.
__device__ __forceinline__ void cull_box(float ca, float cb, float cc,
                                         float op, float& hx, float& hy) {
  if (!(op >= kMinAlpha)) {
    hx = hy = -INFINITY;
    return;
  }
  const float ac = ca * cc;
  const float det = ac - cb * cb;
  const float big_l = (fmaxf(logf(255.0f * op), 0.0f) + 1e-3f) * 1.002f;
  hx = sqrtf(2.0f * big_l * cc / det) * 1.001f + 1.0f;
  hy = sqrtf(2.0f * big_l * ca / det) * 1.001f + 1.0f;
  if (!(ca > 0.0f && cc > 0.0f && det > 2.5e-3f * ac && hx < INFINITY &&
        hy < INFINITY))
    hx = hy = INFINITY;
}

// Fills the cull box of the staged entry in `slot`.
__device__ __forceinline__ void stage_box(float* slot) {
  cull_box(slot[4], slot[5], slot[6], slot[7], slot[2], slot[3]);
}

// Whether the entry {x, y, hx, hy} may reach the rectangle r, as
// |x - cx| - hx <= ex and |y - cy| - hy <= ey (three instructions an axis):
// false means no pixel of r can include it (false too for a NaN or
// infinite centre, which no pixel includes).
__device__ __forceinline__ bool box_hits(const Rect& r, float4 geo) {
  return (fabsf(geo.x - r.cx) - geo.z <= r.ex) &
         (fabsf(geo.y - r.cy) - geo.w <= r.ey);
}

}  // namespace gs
