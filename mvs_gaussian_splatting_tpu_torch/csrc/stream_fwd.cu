// Stream composite, forward: the per-tile front-to-back alpha composite of
// the packed instance stream, in exact mode (gs_stream_fwd, B1) and in fast
// mode (gs_stream_fwd_fast, B3f).
//
// Replaces the TPU kernel ops/pallas/stream.py:_stream_fwd_kernel of the JAX
// package (mvs_gaussian_splatting_tpu), both of its instantiations
// (fast=False and fast=True). Only the math and the I/O contract carry
// over; the TPU layout (128-lane chunks, 128-aligned DMA windows with
// lead-in masks, TILE_BATCH grid steps, lane prefix scans) does not.
//
// Fast mode: the TPU kernel's fast variant computes each 128-lane chunk's
// transmittances as exp of a prefix sum of log(1 - alpha), one triangular
// MXU product (composite.py:_cumprod_lanes_fast), because Mosaic has no
// cumprod and its exact lane scan costs 7 shifted multiplies. Here a
// pixel's loop holds T in a register, so there is no scan to approximate:
// the fast forward is the exact loop with the relaxed arithmetic of
// stream_common.cuh (T - alpha T and the colour sums as FMAs; alpha stays
// exact, as its 1/255 threshold demands). It lands within the JAX
// package's fast-mode contract (2e-3 max abs of the exact image);
// stream_bwd_fast.cu replays it with the same functions.
//
// Inputs
//   attrs     [16, stride] f32, attribute-major; a tile's entries are the
//             columns [seg_start[t], seg_start[t] + counts[t]). Rows used:
//             0 x, 1 y, 2-4 conic a/b/c, 5 opacity, 6-8 rgb.
//   seg_start, counts, tile_ids  [T] i32; bg [3] f32 (device memory).
// Outputs
//   out     [T, P, 3] f32 = sum(rgb * alpha * T_excl) + T_fin * bg
//   final_T [T, P]    f32 = transmittance after the last included entry
// with P = tile_w * tile_h pixels per tile, pixel p at
//   px = (tile_id % tiles_x) * tile_w + p % tile_w,
//   py = (tile_id / tiles_x) * tile_h + p / tile_w.
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
// is read from device memory once for the whole tile (36 bytes for 256 or
// 512 pairs), so the FP32 pipes bound it, not the 3.35 TB/s of HBM; and as
// alpha is pinned (no FMA contraction, full-precision expf), a warp-step (one
// entry against one warp) of a design with row warps and row-major staging
// issued 69-73 SASS instructions, ~9 of them shared-memory loads and
// address arithmetic.
// What the design does about it, besides one CTA per tile and one thread
// per pixel with T and the colour sum in registers:
//   - warps are compact 8 x 4 pixel blocks (stream_common.cuh:
//     thread_pixel), not 32-pixel rows, so fewer warps reach an entry;
//   - each entry is staged once per tile with its cull box (cull_box: the
//     box of its alpha >= 1/255 ellipse, widened past any rounding), and a
//     warp whose pixel rectangle misses the box skips the entry as a
//     warp-uniform branch after one 16-byte load: exact, since an entry that
//     contributes to no pixel changes neither T, the colour sum nor done;
//   - entries are staged entry-major, 12 floats each, so a pair reads three
//     broadcast 16-byte loads with no address arithmetic;
//   - the segment is staged with cp.async into two buffers, one entry per
//     thread, the next batch's copy running while this batch composites:
//     one barrier per batch, which also ends the tile once every pixel is
//     done (__syncthreads_count), like the TPU kernel's early exit per tile;
//   - the exp is taken without a branch around it (entry_alpha);
//   - at most 40 registers a thread (__maxnreg__), so three CTAs of 512
//     threads share an SM at 32 x 16 tiles (46 registers gave two; 32 spill);
//   - CTAs take the tiles heaviest first (`order`, the tiles sorted by
//     count, descending, by the wrapper), so that the last wave holds the
//     light tiles: a tile can carry 4x the mean load, and in stream order
//     one such tile starting late kept the card draining for 16 % of B1's
//     time.
// The per-pair arithmetic is stream_common.cuh's, unchanged, so the outputs
// are those of the row-warp design to the bit.

#include "sections.cuh"
#include "stream_common.cuh"

namespace {

template <bool kFast>
__global__ void __maxnreg__(40) stream_fwd_kernel(
    const float* __restrict__ attrs, long long stride,
    const int* __restrict__ seg_start, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, const long long* __restrict__ order,
    const float* __restrict__ bg, float* __restrict__ out,
    float* __restrict__ final_t, int tiles_x, int tile_w, int tile_h) {
  extern __shared__ float4 stage4[];  // [2][batch][3] entries (kSlot floats)
  float* stage = reinterpret_cast<float*>(stage4);
  const int tid = threadIdx.x;
  const int batch = blockDim.x;  // entries per batch: one per thread
  const int t = static_cast<int>(order[blockIdx.x]);
  GS_SEC_TILE_BEGIN();
  GS_SEC_INIT();

  int lx, ly;
  const bool valid = gs::thread_pixel(
      tid, tile_w, tile_h, gs::compact_blocks(tile_w, tile_h), lx, ly);
  const int tile = tile_ids[t];
  const int gx = (tile % tiles_x) * tile_w + lx;
  const int gy = (tile / tiles_x) * tile_h + ly;
  const float px = static_cast<float>(gx);
  const float py = static_cast<float>(gy);
  const gs::Rect rect = gs::warp_rect(valid, gx, gy);

  const long long start = seg_start[t];
  // Never read past the stream, whatever the caller passed.
  const long long room = stride - start;
  const int count = static_cast<int>(
      max(0LL, min(static_cast<long long>(counts[t]), room)));

  float trans = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  bool done = !valid;

  if (tid < count) gs::stage_async(stage + tid * gs::kSlot,
                                   attrs + start + tid, stride);
  gs::stage_commit();
  for (int base = 0, buf = 0; base < count; base += batch, buf ^= 1) {
    const int n = min(batch, count - base);
    // this thread's own entry has landed: its cull box
    gs::stage_wait();
    if (tid < n) gs::stage_box(stage + (buf * batch + tid) * gs::kSlot);
    GS_SEC_MARK(0);
    // Uniform barrier: every entry of the batch staged; ends the tile once
    // every pixel is done; and keeps the last batch's readers of the other
    // buffer ahead of the copy below.
    if (__syncthreads_count(!done) == 0) break;
    GS_SEC_MARK(3);
    if (base + batch + tid < count)
      gs::stage_async(stage + ((buf ^ 1) * batch + tid) * gs::kSlot,
                      attrs + start + base + batch + tid, stride);
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
        if (!gs::entry_alpha(geo.x, geo.y, con.x, con.y, con.z, con.w,
                                  px, py, e))
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
  gs::stage_wait();  // no copy outlives the CTA
  GS_SEC_MARK(3);

  if (valid) {
    const long long o = static_cast<long long>(t) * tile_w * tile_h +
                        ly * tile_w + lx;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * o + c] = __fadd_rn(acc[c], __fmul_rn(trans, bg[c]));
    final_t[o] = trans;  // <= 1 by construction: min(1, T) of the TPU kernel
  }
  GS_SEC_MARK(2);
  GS_SEC_FLUSH();
  GS_SEC_TILE_END();
}

// Threads and dynamic shared memory of a tile's CTA; raises the kernel's
// shared-memory limit where that is above the default 48 KB.
template <bool kFast>
cudaError_t configure(int tile_w, int tile_h, int& threads, size_t& smem) {
  threads = gs::tile_threads(tile_w, tile_h);
  smem = sizeof(float) * 2 * gs::kSlot * threads;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(stream_fwd_kernel<kFast>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kFast>
int launch(const float* attrs, long long stride, const int* seg_start,
           const int* counts, const int* tile_ids, const long long* order,
           const float* bg, float* out, float* final_t, int n_tiles,
           int tiles_x, int tile_w, int tile_h, void* stream) {
  int threads;
  size_t smem;
  const cudaError_t err = configure<kFast>(tile_w, tile_h, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_fwd_kernel<kFast><<<n_tiles, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      attrs, stride, seg_start, counts, tile_ids, order, bg, out, final_t,
      tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFast>
int occupancy(int tile_w, int tile_h, int* ctas_per_sm, int* registers) {
  int threads;
  size_t smem;
  cudaError_t err = configure<kFast>(tile_w, tile_h, threads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, stream_fwd_kernel<kFast>, threads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, stream_fwd_kernel<kFast>);
  if (err == cudaSuccess) *registers = attr.numRegs;
  return static_cast<int>(err);
}

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, allocated the outputs,
// and passes n_tiles > 0, 0 < tile_w * tile_h <= 1024 and `order`, a
// permutation of [0, n_tiles) (int64): CTA b composites the tile
// order[b], and writes its row order[b] of the outputs.
extern "C" int gs_stream_fwd(const float* attrs, long long stride,
                             const int* seg_start, const int* counts,
                             const int* tile_ids, const long long* order,
                             const float* bg, float* out, float* final_t,
                             int n_tiles, int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  return launch<false>(attrs, stride, seg_start, counts, tile_ids, order, bg,
                       out, final_t, n_tiles, tiles_x, tile_w, tile_h, stream);
}

extern "C" int gs_stream_fwd_fast(const float* attrs, long long stride,
                                  const int* seg_start, const int* counts,
                                  const int* tile_ids, const long long* order,
                                  const float* bg, float* out, float* final_t,
                                  int n_tiles, int tiles_x, int tile_w,
                                  int tile_h, void* stream) {
  return launch<true>(attrs, stride, seg_start, counts, tile_ids, order, bg,
                      out, final_t, n_tiles, tiles_x, tile_w, tile_h, stream);
}

// Resident CTAs per SM and registers per thread of the launch at tile_w x
// tile_h (fast != 0: B3f, else B1), for chip_smoke.py's report.
extern "C" int gs_stream_fwd_occupancy(int fast, int tile_w, int tile_h,
                                       int* ctas_per_sm, int* registers) {
  return fast ? occupancy<true>(tile_w, tile_h, ctas_per_sm, registers)
              : occupancy<false>(tile_w, tile_h, ctas_per_sm, registers);
}

GS_SECTIONS_SETTER(gs_stream_fwd_sections)
