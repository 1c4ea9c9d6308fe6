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
// What bounds it on an H100: operations. Each (entry, pixel) pair a tile
// visits costs about 20 f32 operations plus an expf, while each entry is
// read from device memory once for the whole tile (36 bytes for 256 pairs),
// so the FP32 pipes bound it, not the 3.35 TB/s of HBM.
// What the design does about it: one CTA per tile and one thread per pixel,
// with T and the colour sum in registers. The segment is staged through
// shared memory in batches of P entries, each thread loading one entry's 9
// attributes (coalesced along the instance axis); inside a batch every
// thread reads the same shared address, a broadcast with no bank conflicts.
// A pixel that is done skips the batch, a pair with power > 0 skips the
// exp, and the tile stops at the first batch boundary where every pixel is
// done (__syncthreads_count), like the TPU kernel's early exit per tile.
// Overlapping the next batch's load with this batch's compute (cp.async or
// TMA double buffering) and more pixels per thread are left for later.

#include "stream_common.cuh"

namespace {

constexpr int kUsedRows = 9;

template <bool kFast>
__global__ void stream_fwd_kernel(const float* __restrict__ attrs,
                                  long long stride,
                                  const int* __restrict__ seg_start,
                                  const int* __restrict__ counts,
                                  const int* __restrict__ tile_ids,
                                  const float* __restrict__ bg,
                                  float* __restrict__ out,
                                  float* __restrict__ final_t,
                                  int tiles_x, int tile_w, int tile_h) {
  extern __shared__ float stage[];  // [kUsedRows][P]
  const int n_pix = tile_w * tile_h;
  const int p = threadIdx.x;
  const int t = blockIdx.x;

  const int tile = tile_ids[t];
  const float px = static_cast<float>((tile % tiles_x) * tile_w + p % tile_w);
  const float py = static_cast<float>((tile / tiles_x) * tile_h + p / tile_w);

  const long long start = seg_start[t];
  // Never read past the stream, whatever the caller passed.
  const long long room = stride - start;
  const int count = static_cast<int>(
      max(0LL, min(static_cast<long long>(counts[t]), room)));

  float trans = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  bool done = false;

  for (int base = 0; base < count; base += n_pix) {
    // Uniform barrier: ends the tile once every pixel is done, and keeps the
    // previous batch's readers ahead of this batch's writers.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(n_pix, count - base);
    if (p < n) {
      const float* src = attrs + start + base + p;
#pragma unroll
      for (int r = 0; r < kUsedRows; ++r) stage[r * n_pix + p] = src[r * stride];
    }
    __syncthreads();
    if (done) continue;
    gs::composite_batch<kFast>(stage, n_pix, n, px, py, trans, acc, done);
  }

  const long long o = static_cast<long long>(t) * n_pix + p;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[3 * o + c] = __fadd_rn(acc[c], __fmul_rn(trans, bg[c]));
  final_t[o] = trans;  // <= 1 by construction: min(1, T) of the TPU kernel
}

template <bool kFast>
int launch(const float* attrs, long long stride, const int* seg_start,
           const int* counts, const int* tile_ids, const float* bg,
           float* out, float* final_t, int n_tiles, int tiles_x, int tile_w,
           int tile_h, void* stream) {
  const int n_pix = tile_w * tile_h;
  const size_t smem = sizeof(float) * kUsedRows * n_pix;
  stream_fwd_kernel<kFast><<<n_tiles, n_pix, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      attrs, stride, seg_start, counts, tile_ids, bg, out, final_t, tiles_x,
      tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, allocated the outputs,
// and passes n_tiles > 0.
extern "C" int gs_stream_fwd(const float* attrs, long long stride,
                             const int* seg_start, const int* counts,
                             const int* tile_ids, const float* bg, float* out,
                             float* final_t, int n_tiles, int tiles_x,
                             int tile_w, int tile_h, void* stream) {
  return launch<false>(attrs, stride, seg_start, counts, tile_ids, bg, out,
                       final_t, n_tiles, tiles_x, tile_w, tile_h, stream);
}

extern "C" int gs_stream_fwd_fast(const float* attrs, long long stride,
                                  const int* seg_start, const int* counts,
                                  const int* tile_ids, const float* bg,
                                  float* out, float* final_t, int n_tiles,
                                  int tiles_x, int tile_w, int tile_h,
                                  void* stream) {
  return launch<true>(attrs, stride, seg_start, counts, tile_ids, bg, out,
                      final_t, n_tiles, tiles_x, tile_w, tile_h, stream);
}
