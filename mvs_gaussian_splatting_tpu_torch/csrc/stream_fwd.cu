// Stream composite, forward: the per-tile front-to-back alpha composite of
// the packed instance stream, in exact mode.
//
// Replaces the TPU kernel ops/pallas/stream.py:_stream_fwd_kernel of the JAX
// package (mvs_gaussian_splatting_tpu). Only the math and the I/O contract
// carry over; the TPU layout (128-lane chunks, 128-aligned DMA windows with
// lead-in masks, TILE_BATCH grid steps, lane prefix scans) does not.
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
// The two thresholds decide which entries count, so every product and sum
// is rounded as the JAX expression is written (__fmul_rn / __fadd_rn are
// never contracted into FMAs) and exp is the full-precision expf: build
// without --use_fast_math.
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

#include <cuda_runtime.h>

namespace {

constexpr int kUsedRows = 9;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinTransmittance = 1e-4f;

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
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
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

    for (int k = 0; k < n; ++k) {
      const float dx = __fsub_rn(stage[k], px);
      const float dy = __fsub_rn(stage[n_pix + k], py);
      const float ca = stage[2 * n_pix + k];
      const float cb = stage[3 * n_pix + k];
      const float cc = stage[4 * n_pix + k];
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                   __fmul_rn(__fmul_rn(cc, dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                    __fmul_rn(__fmul_rn(cb, dx), dy));
      if (!(power <= 0.0f)) continue;
      const float raw = __fmul_rn(stage[5 * n_pix + k], expf(power));
      // min(0.99, raw) that keeps a NaN, as jnp.minimum / torch.minimum do
      const float alpha = raw > kMaxAlpha ? kMaxAlpha : raw;
      if (!(alpha >= kMinAlpha)) continue;
      const float next = __fmul_rn(trans, __fsub_rn(1.0f, alpha));
      if (next < kMinTransmittance) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, trans);
      acc_r = __fadd_rn(acc_r, __fmul_rn(w, stage[6 * n_pix + k]));
      acc_g = __fadd_rn(acc_g, __fmul_rn(w, stage[7 * n_pix + k]));
      acc_b = __fadd_rn(acc_b, __fmul_rn(w, stage[8 * n_pix + k]));
      trans = next;
    }
  }

  const long long o = static_cast<long long>(t) * n_pix + p;
  out[3 * o + 0] = __fadd_rn(acc_r, __fmul_rn(trans, bg[0]));
  out[3 * o + 1] = __fadd_rn(acc_g, __fmul_rn(trans, bg[1]));
  out[3 * o + 2] = __fadd_rn(acc_b, __fmul_rn(trans, bg[2]));
  final_t[o] = trans;  // <= 1 by construction: min(1, T) of the TPU kernel
}

}  // namespace

// Launches one CTA per tile on `stream` and returns cudaGetLastError().
// The caller has checked shapes, types and devices, allocated the outputs,
// and passes n_tiles > 0.
extern "C" int gs_stream_fwd(const float* attrs, long long stride,
                             const int* seg_start, const int* counts,
                             const int* tile_ids, const float* bg, float* out,
                             float* final_t, int n_tiles, int tiles_x,
                             int tile_w, int tile_h, void* stream) {
  const int n_pix = tile_w * tile_h;
  const size_t smem = sizeof(float) * kUsedRows * n_pix;
  stream_fwd_kernel<<<n_tiles, n_pix, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      attrs, stride, seg_start, counts, tile_ids, bg, out, final_t, tiles_x,
      tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
