// The forward kernel body shared by B1 and B3f (stream_fwd.cu, the packed
// instance stream) and B4 (padded_fwd.cu, fixed-capacity per-tile tables):
// the per-tile front-to-back alpha composite. The three differ only in
// where entry k of tile t is read (the layout policy `Slots`, slots.cuh)
// and in the fast-math arithmetic (kFast, B3f only).
//
// Outputs
//   out     [T, P, 3] f32 = sum(rgb * alpha * T_excl) + T_fin * bg
//   final_T [T, P]    f32 = transmittance after the last included entry
// with P = tile_w * tile_h pixels per tile, pixel p of the kernel's tile t
// (image tile i = slots.tile(t)) at
//   px = (i % tiles_x) * tile_w + p % tile_w,
//   py = (i / tiles_x) * tile_h + p / tile_w.
//
// Per entry: power = -0.5 (a dx^2 + c dy^2) - b dx dy, alpha =
// min(0.99, op * exp(power)); the entry contributes iff power <= 0 and
// alpha >= 1/255, and is included iff T (1 - alpha) >= 1e-4. The first
// contributing entry that fails that test is left out and ends the pixel.
// The two thresholds decide which entries count; stream_common.cuh pins
// the rounding of every operation (exact mode: as the JAX expression is
// written, full-precision expf; build without --use_fast_math).
//
// What bounds it on an H100: issued instructions. Each (entry, pixel) pair
// a tile visits costs about 20 f32 operations plus an expf, while each entry
// is read from device memory once for the whole tile (36-40 bytes for 256 or
// 512 pairs), so the FP32 pipes bound it, not the 3.35 TB/s of HBM; and as
// alpha is pinned (no FMA contraction, full-precision expf), a warp-step (one
// entry against one warp) of a design with row warps and row-major staging
// issued 63-73 SASS instructions, ~9 of them shared-memory loads and
// address arithmetic.
// What the design does about it, besides one CTA per tile and one thread
// per pixel with T and the colour sum in registers:
//   - warps are compact 8 x 4 pixel blocks (stream_common.cuh:
//     thread_pixel), not 32-pixel rows, so fewer warps reach an entry;
//   - each entry is staged once per tile (per part) with its cull box
//     (cull_box: the box of its alpha >= 1/255 ellipse, widened past any
//     rounding), and a warp whose pixel rectangle misses the box skips the
//     entry as a warp-uniform branch after one 16-byte load: exact, since an
//     entry that contributes to no pixel changes neither T, the colour sum
//     nor done;
//   - entries are staged entry-major, 12 floats each, so a pair reads three
//     broadcast 16-byte loads with no address arithmetic;
//   - the segment is staged with cp.async into two buffers, one entry per
//     thread, the next batch's copy running while this batch composites:
//     one barrier per batch, which also ends the tile (the part) once every
//     pixel is done (__syncthreads_count), like the TPU kernel's early exit
//     per tile;
//   - the exp is taken without a branch around it (entry_alpha);
//   - at most 40 registers a thread (__maxnreg__), so three CTAs of 512
//     threads share an SM at 32 x 16 tiles (46 registers gave two; 32 spill);
//   - CTAs take the tiles heaviest first (`order`, the tiles sorted by
//     count, descending, by the wrapper), so that the last wave holds the
//     light tiles: a tile can carry 4x the mean load, and in stream order
//     one such tile starting late kept the card draining for 16 % of B1's
//     time.
// A tile of more than 1,024 pixels is walked as parts (stream_common.cuh:
// tile_parts), in the kParts instantiation: at the end of a part every
// thread has drained its copies and a barrier keeps the part's last readers
// of the stage ahead of the next part's first copies. Pixels are
// independent, so the outputs are those of one CTA covering the tile.

#pragma once

#include "sections.cuh"
#include "slots.cuh"

namespace {

template <class Slots, bool kFast, bool kParts>
__global__ void __maxnreg__(40) fwd_kernel(
    const Slots slots, const long long* __restrict__ order,
    const float* __restrict__ bg, float* __restrict__ out,
    float* __restrict__ final_t, int tiles_x, int tile_w, int tile_h) {
  extern __shared__ float4 stage4[];  // [2][batch][3] entries (kSlot floats)
  float* stage = reinterpret_cast<float*>(stage4);
  const int tid = threadIdx.x;
  const int batch = blockDim.x;  // entries per batch: one per thread
  const int t = static_cast<int>(order[blockIdx.x]);
  GS_SEC_TILE_BEGIN();
  GS_SEC_INIT();

  const int tile = slots.tile(t);
  const long long start = slots.base(t);
  const int count = slots.count(t);
  const gs::Parts parts =
      kParts ? gs::tile_parts(tile_w, tile_h, gs::kCtaPixels)
             : gs::Parts{tile_w, tile_h, 1, 1};
  for (int part = 0; part < parts.n; ++part) {
    const gs::Part pix = kParts ? gs::part_at(parts, part, tile_w, tile_h)
                                : gs::Part{0, 0, tile_w, tile_h};
    // the previous part's readers of the stage ahead of this part's copies
    if (kParts && part > 0) __syncthreads();
    int lx, ly;
    const bool valid = gs::thread_pixel(
        tid, pix.w, pix.h, gs::compact_blocks(pix.w, pix.h), lx, ly);
    lx += pix.x0;
    ly += pix.y0;
    const int gx = (tile % tiles_x) * tile_w + lx;
    const int gy = (tile / tiles_x) * tile_h + ly;
    const float px = static_cast<float>(gx);
    const float py = static_cast<float>(gy);
    const gs::Rect rect = gs::warp_rect(valid, gx, gy);

    float trans = 1.0f;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    bool done = !valid;

    if (tid < count) slots.stage(stage + tid * gs::kSlot, start + tid);
    gs::stage_commit();
    for (int base = 0, buf = 0; base < count; base += batch, buf ^= 1) {
      const int n = min(batch, count - base);
      // this thread's own entry has landed: its cull box
      gs::stage_wait();
      if (tid < n) {
        float* slot = stage + (buf * batch + tid) * gs::kSlot;
        slots.fix(slot);
        gs::stage_box(slot);
      }
      GS_SEC_MARK(0);
      // Uniform barrier: every entry of the batch staged; ends the part
      // once every pixel is done; and keeps the last batch's readers of the
      // other buffer ahead of the copy below.
      if (__syncthreads_count(!done) == 0) break;
      GS_SEC_MARK(3);
      if (base + batch + tid < count)
        slots.stage(stage + ((buf ^ 1) * batch + tid) * gs::kSlot,
                    start + base + batch + tid);
      gs::stage_commit();
      GS_SEC_MARK(0);
      if (!done) {
        const float4* e4 = stage4 + buf * batch * 3;
        for (int k = 0; k < n; ++k, e4 += 3) {
          const float4 geo = e4[0];  // x, y, hx, hy
          GS_SEC_COUNT(0);
          GS_SEC_COUNT_LANE(2);
          if (!gs::box_hits(rect, geo)) {  // warp-uniform
            GS_SEC_COUNT(3);
            continue;
          }
          const float4 con = e4[1];  // conic a, b, c, opacity
          gs::Entry e;
          if (!gs::entry_alpha(geo.x, geo.y, con.x, con.y, con.z, con.w, px,
                               py, e))
            continue;
          GS_SEC_COUNT(1);
          GS_SEC_COUNT_LANE(4);
          const float next = gs::transmit<kFast>(trans, e.alpha);
          if (next < gs::kMinTransmittance) {
            done = true;
            break;
          }
          const float4 rgb = e4[2];
          const float w = __fmul_rn(e.alpha, trans);
          acc[0] = gs::accumulate<kFast>(acc[0], w, rgb.x);
          acc[1] = gs::accumulate<kFast>(acc[1], w, rgb.y);
          acc[2] = gs::accumulate<kFast>(acc[2], w, rgb.z);
          trans = next;
        }
      }
      GS_SEC_MARK(1);
    }
    gs::stage_wait();  // no copy outlives the part
    GS_SEC_MARK(3);

    if (valid) {
      const long long o = static_cast<long long>(t) * tile_w * tile_h +
                          ly * tile_w + lx;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[3 * o + c] = __fadd_rn(acc[c], __fmul_rn(trans, bg[c]));
      final_t[o] = trans;  // <= 1 by construction: min(1, T) of the TPU
    }
    GS_SEC_MARK(2);
  }
  GS_SEC_FLUSH();
  GS_SEC_TILE_END();
}

// A forward kernel's type, either instantiation.
template <class Slots>
using FwdKernel = void (*)(const Slots, const long long*, const float*,
                           float*, float*, int, int, int);

// The instantiation a tile_w x tile_h tile runs (one part or parts), its
// threads and dynamic shared memory; raises the kernel's shared-memory
// limit where that is above the default 48 KB. An empty tile is refused.
template <class Slots, bool kFast>
cudaError_t fwd_configure(int tile_w, int tile_h, FwdKernel<Slots>& kernel,
                          int& threads, size_t& smem) {
  if (tile_w <= 0 || tile_h <= 0) return cudaErrorInvalidValue;
  const gs::Parts parts = gs::tile_parts(tile_w, tile_h, gs::kCtaPixels);
  kernel = parts.n > 1 ? fwd_kernel<Slots, kFast, true>
                       : fwd_kernel<Slots, kFast, false>;
  threads = gs::tile_threads(parts.w, parts.h);
  smem = sizeof(float) * 2 * gs::kSlot * threads;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One CTA per tile on `stream`; returns cudaGetLastError(), or the refusal
// of fwd_configure.
template <class Slots, bool kFast>
int fwd_launch(const Slots& slots, const long long* order, const float* bg,
               float* out, float* final_t, int n_tiles, int tiles_x,
               int tile_w, int tile_h, void* stream) {
  FwdKernel<Slots> kernel;
  int threads;
  size_t smem;
  const cudaError_t err =
      fwd_configure<Slots, kFast>(tile_w, tile_h, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      slots, order, bg, out, final_t, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM and registers per thread of the launch at tile_w x
// tile_h (the instantiation that shape runs), for chip_smoke.py's report.
template <class Slots, bool kFast>
int fwd_occupancy(int tile_w, int tile_h, int* ctas_per_sm, int* registers) {
  FwdKernel<Slots> kernel;
  int threads;
  size_t smem;
  cudaError_t err =
      fwd_configure<Slots, kFast>(tile_w, tile_h, kernel, threads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                        threads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) *registers = attr.numRegs;
  return static_cast<int>(err);
}

}  // namespace
