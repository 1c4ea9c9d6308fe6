// The exact-mode backward kernel body shared by B2 (stream_bwd.cu, the
// packed instance stream) and B5 (padded_bwd.cu, fixed-capacity per-tile
// tables): the gradient of B1 / B4 with respect to each entry's attributes,
// by replaying the forward, summed over the tile's pixels. The two differ
// only in where entry k of tile t is read and where its 9 sums are
// written: the template parameter `Slots`, a small layout policy (the read
// half in slots.cuh, shared with the forwards; the write half, store and
// clear, in stream_bwd.cu and padded_bwd.cu), maps the pair (t, k) to one
// column e = base(t) + k and reads and writes that column.
//
// Per pixel, with T_k the transmittance before entry k, w_k = alpha_k T_k,
// g.v = sum_c g_out_c v_c and the inclusive prefix
// S_k = sum_{j<=k} w_j g.rgb_j,
//   dalpha_k = g.rgb_k T_k - (g.out - S_k + g_tfin T_fin) / (1 - alpha_k)
// for an included entry, 0 otherwise (one correctly rounded division; the
// plain versions, as the JAX expression, divide the two terms apart).
// Through alpha = min(0.99, op e^power): dop = dalpha e^power and
// dpower = dalpha op e^power where op e^power < 0.99, both 0 on the clamp;
// with (dx, dy) the entry's centre minus the pixel's,
//   d(x, y) = -dpower (a dx + b dy, c dy + b dx),
//   d(conic a, b, c) = -dpower (dx^2 / 2, dx dy, dy^2 / 2),
//   drgb_c = g_out_c w.
// The replay takes the forward's include and terminate decisions from the
// same inline functions (stream_common.cuh: entry_alpha, transmit<false>):
// if one differed, g.out - S_k would stop matching the saved out and the
// gradient would go wrong without any NaN. Only the gradient's arithmetic
// is free, within the exact mode's 1e-5 of row scale.
//
// What bounds it on an H100: issued instructions. Each live (entry, warp)
// step costs the replay (~35 instructions with the exact expf), the
// gradient (~30, a division among them) and the sum over the warp's 32
// pixels, while each entry is read once and written once for the whole
// tile. What the design does about it:
//   - B1's compact 8 x 4 warp blocks and per-warp cull (stream_common.cuh:
//     thread_pixel, warp_rect, cull_box, box_hits), row-order warps where
//     the blocks would need more than 1,024 threads, masked lanes where a
//     block overhangs the tile (or the part, below). A
//     culled (warp, entry) pair skips the replay and the sum and contributes
//     exact zeros: the cull is exact for B1, so no pixel of the warp would
//     have included the entry, and it moves neither T nor S;
//   - per pixel, the 9 values summed are the moments dpower dx, dpower dy,
//     dpower dx^2, dpower dx dy, dpower dy^2, dop and g_out_c w; the conic
//     and the constants are applied once per entry after the sum, so a pair
//     costs 8 multiplies of gradient instead of 19;
//   - the warp's sum is a butterfly reduce-scatter: at each level a lane
//     keeps half of the values it holds and sends the other half to its
//     partner, so 9 values take 12 shuffles (9 separate warp sums: 45),
//     after which 9 lanes hold one row's warp total each and store it. It is
//     skipped where no lane of the warp includes the entry;
//   - the segment is staged entry-major with its cull boxes in batches of
//     kBatch = 64 entries by cp.async into two buffers, the next batch's
//     copy running during this one; per batch two barriers: one opens the
//     batch (and ends the tile once every pixel is done), one closes the
//     warps' partials, which every thread then adds in warp order (fixed:
//     two launches give the same bits) and writes, one (row, entry) each.
//     Every column belongs to one tile, so no atomics;
//   - T is kept 0 once a pixel is done (a masked lane is done from the
//     start), so a done pixel fails every T test and needs no flag; a warp
//     asks whether any of its pixels is live every 8 entries;
//   - CTAs take the tiles heaviest first (`order`), so that the last wave
//     holds the light tiles;
//   - at most 40 registers a thread (__maxnreg__), for 48 resident warps
//     per SM at 32 x 16 tiles.
// A tile of more than 1,024 pixels is walked as parts (stream_common.cuh:
// tile_parts), in the kParts instantiation: each part replays the whole
// segment for its own pixels, its first part stores each entry's sums and
// the later ones add theirs (store with `add`) after a barrier, in part
// order; the slots past the first part's early exit are cleared before a
// later part adds to them.

#pragma once

#include "sections.cuh"
#include "slots.cuh"

namespace {

constexpr int kRows = 9;    // gradient rows per entry
constexpr int kBatch = 64;  // entries staged per batch
constexpr unsigned kAll = 0xffffffffu;

// One level of the reduce-scatter: a lane holding N values a[0, N) keeps
// the first (N + 1) / 2 if `upper` is false, else the rest (padded with a
// zero), each added to its partner's (lane ^ off) copy, into a[0, (N+1)/2).
template <int N>
__device__ __forceinline__ void halve(float (&a)[kRows], int off,
                                      bool upper) {
  constexpr int kKeep = (N + 1) / 2;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const float lo = a[j];
    const float hi = kKeep + j < N ? a[kKeep + j] : 0.0f;
    a[j] = __fadd_rn(upper ? hi : lo,
                     __shfl_xor_sync(kAll, upper ? lo : hi, off));
  }
}

// The warp's sums of the 9 values of a[]: lane l gets the sum of row
// summed_row(l) (or a zero where that is -1). Whole warp, converged.
__device__ __forceinline__ float reduce9(float (&a)[kRows], int lane) {
  halve<9>(a, 16, lane & 16);
  halve<5>(a, 8, lane & 8);
  halve<3>(a, 4, lane & 4);
  halve<2>(a, 2, lane & 2);
  return __fadd_rn(a[0], __shfl_xor_sync(kAll, a[0], 1));
}

// The row whose warp sum lane `lane` holds after reduce9, or -1 (lanes in
// pairs hold the same sum: the even one stores it). Back from the last
// level: the lane's value sits at position `pos` of each level's input,
// moved up by the kept count where the lane took the upper part; a
// position past the level's N is a padding zero.
__device__ __forceinline__ int summed_row(int lane) {
  int pos = 0;
  bool real = true;
  for (int off = 2, n = 2; off <= 16; off <<= 1, n = 2 * n - 1) {
    if (lane & off) pos += (n + 1) / 2;
    real = real && pos < n;
  }
  return real && !(lane & 1) ? pos : -1;
}

// Threads and dynamic shared memory of a tile's CTA: the two stage buffers
// and the warps' partials [warps][kBatch][kRows].
__host__ __device__ __forceinline__ size_t smem_bytes(int threads) {
  return sizeof(float) *
         (2 * kBatch * gs::kSlot + (threads / 32) * kBatch * kRows);
}

template <class Slots, bool kParts>
__global__ void __maxnreg__(40) exact_bwd_kernel(
    const Slots slots, const long long* __restrict__ order,
    const float* __restrict__ out, const float* __restrict__ final_t,
    const float* __restrict__ g_out, const float* __restrict__ g_tfin,
    int tiles_x, int tile_w, int tile_h) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // [2][kBatch][kSlot]
  float* partial = stage + 2 * kBatch * gs::kSlot;  // [warps][kBatch][kRows]
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int n_warps = threads >> 5;
  const int lane = tid & 31;
  const int t = static_cast<int>(order[blockIdx.x]);
  GS_SEC_TILE_BEGIN();
  GS_SEC_INIT();

  const long long base = slots.base(t);
  const int count = slots.count(t);
  const gs::Parts parts =
      kParts ? gs::tile_parts(tile_w, tile_h, gs::kCtaPixels)
             : gs::Parts{tile_w, tile_h, 1, 1};
  for (int part = 0; part < parts.n; ++part) {
    const gs::Part pix = kParts ? gs::part_at(parts, part, tile_w, tile_h)
                                : gs::Part{0, 0, tile_w, tile_h};
    // the previous part's readers of the stage and writers of the sums (and
    // the first part's clear) ahead of this part's copies and sums
    if (kParts && part > 0) __syncthreads();
    const bool add = kParts && part > 0;
    // entries are staged, boxed and written by threads tid, tid + threads,
    // ...: a CTA may have fewer threads than kBatch (an 8 x 4 tile has 32)
    for (int i = tid; i < min(kBatch, count); i += threads)
      slots.stage(stage + i * gs::kSlot, base + i);
    gs::stage_commit();

    int lx, ly;
    const bool valid = gs::thread_pixel(
        tid, pix.w, pix.h, gs::compact_blocks(pix.w, pix.h), lx, ly);
    lx += pix.x0;
    ly += pix.y0;
    const int tile = slots.tile(t);
    const int gx = (tile % tiles_x) * tile_w + lx;
    const int gy = (tile / tiles_x) * tile_h + ly;
    const float px = static_cast<float>(gx);
    const float py = static_cast<float>(gy);
    const gs::Rect rect = gs::warp_rect(valid, gx, gy);
    const int row = summed_row(lane);  // -1: this lane stores nothing
    float* my_sums = partial + (tid >> 5) * kBatch * kRows + max(row, 0);

    // g.out, g_tfin T_fin and the prefix S rounded as the plain versions
    // round them: S runs over thousands of entries, and its rounding is
    // what a pixel's dalpha is most sensitive to
    float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_dot_out = 0.0f;
    float tfin_term = 0.0f, prefix = 0.0f;
    if (valid) {
      const long long o =
          static_cast<long long>(t) * tile_w * tile_h + ly * tile_w + lx;
      g_r = g_out[3 * o];
      g_g = g_out[3 * o + 1];
      g_b = g_out[3 * o + 2];
      g_dot_out = __fadd_rn(__fadd_rn(__fmul_rn(g_r, out[3 * o]),
                                      __fmul_rn(g_g, out[3 * o + 1])),
                            __fmul_rn(g_b, out[3 * o + 2]));
      tfin_term = __fmul_rn(g_tfin[o], final_t[o]);
    }
    // T of the pixel, 0 once it is done (a masked lane is done from the
    // start): a done pixel then fails every T test and includes nothing
    float trans = valid ? 1.0f : 0.0f;

    int written = count;  // columns [0, written) of the tile get their sums
    for (int b0 = 0, buf = 0; b0 < count; b0 += kBatch, buf ^= 1) {
      const int n = min(kBatch, count - b0);
      float* batch = stage + buf * kBatch * gs::kSlot;
      gs::stage_wait();
      for (int i = tid; i < n; i += threads) {
        slots.fix(batch + i * gs::kSlot);
        gs::stage_box(batch + i * gs::kSlot);
      }
      GS_SEC_MARK(0);
      // Uniform barrier: the batch staged; ends the tile once every pixel is
      // done; and keeps the last batch's readers of the other stage buffer
      // and of the partials ahead of their writers below.
      if (__syncthreads_count(trans > 0.0f) == 0) {
        written = b0;
        break;
      }
      GS_SEC_MARK(4);
      for (int i = tid; i < kBatch && b0 + kBatch + i < count; i += threads)
        slots.stage(stage + ((buf ^ 1) * kBatch + i) * gs::kSlot,
                    base + b0 + kBatch + i);
      gs::stage_commit();
      GS_SEC_MARK(0);

      const float4* e4 = reinterpret_cast<const float4*>(batch);
      bool live = false;
      for (int k = 0; k < n; ++k, e4 += 3) {
        // a warp whose pixels are all done replays nothing more: asked every
        // 8 entries (a vote each entry cost B2 7 % of its time on an NVIDIA
        // H100 80GB HBM3 at 700 W)
        if ((k & 7) == 0) live = __any_sync(kAll, trans > 0.0f);
        float sum = 0.0f;
        const float4 geo = e4[0];  // x, y, hx, hy
        if (live) {
          GS_SEC_COUNT(0);
          if (trans > 0.0f) GS_SEC_COUNT_LANE(2);
          if (!gs::box_hits(rect, geo)) GS_SEC_COUNT(3);
        }
        if (live && gs::box_hits(rect, geo)) {  // warp-uniform
          const float4 con = e4[1];  // conic a, b, c, opacity
          gs::Entry e;
          const bool contrib = gs::entry_alpha(geo.x, geo.y, con.x, con.y,
                                               con.z, con.w, px, py, e);
          const float next = gs::transmit<false>(trans, e.alpha);
          // the first contributing entry that fails the T test ends the pixel
          const bool include = contrib && next >= gs::kMinTransmittance;
          if (contrib && trans > 0.0f) GS_SEC_COUNT_LANE(4);
          if (contrib && !include) trans = 0.0f;
          GS_SEC_MARK(1);
          // the whole warp takes the same branch: shuffles need every lane.
          // A lane that does not include the entry adds zeros: its w and
          // dpower are selected to 0, whatever its alpha (the entry's centre
          // is finite, or the cull would have skipped it)
          if (__any_sync(kAll, include)) {
            GS_SEC_COUNT(1);
            const float4 rgb = e4[2];
            const float w = include ? __fmul_rn(e.alpha, trans) : 0.0f;
            const float g_dot_rgb = __fadd_rn(
                __fadd_rn(__fmul_rn(g_r, rgb.x), __fmul_rn(g_g, rgb.y)),
                __fmul_rn(g_b, rgb.z));
            if (include) prefix = __fadd_rn(prefix, __fmul_rn(w, g_dot_rgb));
            const float dalpha = __fsub_rn(
                __fmul_rn(g_dot_rgb, trans),
                __fdiv_rn(__fadd_rn(__fsub_rn(g_dot_out, prefix), tfin_term),
                          __fsub_rn(1.0f, e.alpha)));
            const bool slope = include && e.raw < gs::kMaxAlpha;
            const float dpower = slope ? __fmul_rn(dalpha, e.raw) : 0.0f;
            const float dpx = __fmul_rn(dpower, e.dx);
            const float dpy = __fmul_rn(dpower, e.dy);
            float m[kRows] = {dpx,
                              dpy,
                              __fmul_rn(dpx, e.dx),
                              __fmul_rn(dpx, e.dy),
                              __fmul_rn(dpy, e.dy),
                              slope ? __fmul_rn(dalpha, e.g) : 0.0f,
                              __fmul_rn(g_r, w),
                              __fmul_rn(g_g, w),
                              __fmul_rn(g_b, w)};
            if (include) trans = next;
            sum = reduce9(m, lane);
          }
        }
        if (row >= 0) my_sums[k * kRows] = sum;
        GS_SEC_MARK(2);
      }
      __syncthreads();
      GS_SEC_MARK(5);
      // each (row, entry) of the batch summed over the warps in warp order
      // and written: q = 0 the position rows 0 and 1 (from the moments
      // dpower dx and dpower dy and the conic), q = 1..7 rows 2..8
      for (int i = tid; i < 8 * n; i += threads) {
        const int q = i / n, k = i - q * n;
        const float* src = partial + k * kRows + (q ? q + 1 : 0);
        float s = 0.0f, s1 = 0.0f;
        for (int w = 0; w < n_warps; ++w, src += kBatch * kRows) {
          s = __fadd_rn(s, src[0]);
          if (q == 0) s1 = __fadd_rn(s1, src[1]);
        }
        const long long e = base + b0 + k;
        if (q == 0) {
          // an entry no pixel includes has zero moments: its gradient is 0
          // whatever its conic (which may then be inf or NaN)
          const bool none = s == 0.0f && s1 == 0.0f;
          const float* slot = batch + k * gs::kSlot;
          const float ca = slot[4], cb = slot[5], cc = slot[6];
          slots.store(e, 0, none ? 0.0f : -(ca * s + cb * s1), add);
          slots.store(e, 1, none ? 0.0f : -(cc * s1 + cb * s), add);
        } else {
          slots.store(e, q + 1,
                      q == 1 || q == 3 ? -0.5f * s
                      : q == 2         ? -s
                                       : s,
                      add);
        }
      }
      GS_SEC_MARK(3);
    }
    gs::stage_wait();  // no copy outlives the part
    if (!add) slots.clear(t, base, written, tid, threads);
    GS_SEC_MARK(0);
  }
  GS_SEC_FLUSH();
  GS_SEC_TILE_END();
}

// An exact backward kernel's type, either instantiation.
template <class Slots>
using BwdKernel = void (*)(const Slots, const long long*, const float*,
                           const float*, const float*, const float*, int, int,
                           int);

// The instantiation a tile_w x tile_h tile runs (one part or parts), its
// threads and dynamic shared memory; raises the kernel's shared-memory
// limit where that is above the default 48 KB. An empty tile is refused.
template <class Slots>
cudaError_t configure(int tile_w, int tile_h, BwdKernel<Slots>& kernel,
                      int& threads, size_t& smem) {
  if (tile_w <= 0 || tile_h <= 0) return cudaErrorInvalidValue;
  const gs::Parts parts = gs::tile_parts(tile_w, tile_h, gs::kCtaPixels);
  kernel = parts.n > 1 ? exact_bwd_kernel<Slots, true>
                       : exact_bwd_kernel<Slots, false>;
  threads = gs::tile_threads(parts.w, parts.h);
  smem = smem_bytes(threads);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One CTA per tile on `stream`; returns cudaGetLastError(), or the refusal
// of configure.
template <class Slots>
int launch(const Slots& slots, const long long* order, const float* out,
           const float* final_t, const float* g_out, const float* g_tfin,
           int n_tiles, int tiles_x, int tile_w, int tile_h, void* stream) {
  BwdKernel<Slots> kernel;
  int threads;
  size_t smem;
  const cudaError_t err =
      configure<Slots>(tile_w, tile_h, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      slots, order, out, final_t, g_out, g_tfin, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM and registers per thread of the launch at tile_w x
// tile_h (the instantiation that shape runs), for chip_smoke.py's report.
template <class Slots>
int occupancy(int tile_w, int tile_h, int* ctas_per_sm, int* registers) {
  BwdKernel<Slots> kernel;
  int threads;
  size_t smem;
  cudaError_t err = configure<Slots>(tile_w, tile_h, kernel, threads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                        threads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) *registers = attr.numRegs;
  return static_cast<int>(err);
}

}  // namespace
