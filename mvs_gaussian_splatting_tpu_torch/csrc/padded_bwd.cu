// Padded-table composite, backward (B5): the gradient of padded_fwd.cu
// (B4) with respect to its tables, in exact mode, by replaying B4.
//
// Replaces the TPU kernel ops/pallas/composite.py:_bwd_kernel of the JAX
// package (mvs_gaussian_splatting_tpu; entry _composite_vjp_bwd). Only the
// math and the I/O contract carry over.
//
// Inputs
//   planes, rgb, valid, counts, geometry  as in padded_fwd.cu;
//   out [T, P, 3], final_T [T, P]   saved by the forward;
//   g_out [T, P, 3], g_tfin [T, P]  the cotangents.
// Outputs, zeroed by the caller
//   gplanes [6, T, K]: d x, y, conic a, b, c, opacity;
//   grgb    [T, K, 3].
// Each slot a tile visits before its early exit is written once with its
// sums over the tile's pixels; every other slot stays zero. A padded or
// invalid slot is never included, so it is written as an exact zero: those
// slots index Gaussian 0 (ops/binning.py), and the gather's backward adds
// whatever they hold to Gaussian 0.
//
// The per-pixel gradient is stream_common.cuh's backward_entry_exact, the
// replay B2 (stream_bwd.cu) runs, built on the same inline functions as
// B4's forward; B5 differs from B2 only in where it reads and writes. So
// is its design: one CTA per tile, one thread per pixel, T and the prefix
// in registers, slots staged in batches of kBatch, per-entry warp-shuffle
// sums, per-warp partials in shared memory added in warp order and stored
// once, no atomics. What bounds it on an H100: operations, as for B2.

#include "stream_common.cuh"

namespace {

constexpr int kUsedRows = 9;
constexpr int kBatch = 32;  // slots staged per batch

__global__ void padded_bwd_kernel(const float* __restrict__ planes,
                                  const float* __restrict__ rgb,
                                  const float* __restrict__ valid,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ out,
                                  const float* __restrict__ final_t,
                                  const float* __restrict__ g_out,
                                  const float* __restrict__ g_tfin,
                                  float* __restrict__ gplanes,
                                  float* __restrict__ grgb, int n_tiles,
                                  int k_cap, int tiles_x, int tile_w,
                                  int tile_h) {
  extern __shared__ float smem[];
  float* stage = smem;                       // [kUsedRows][kBatch]
  float* part = smem + kUsedRows * kBatch;   // [warps][kUsedRows][kBatch]
  const int n_pix = tile_w * tile_h;
  const int n_warps = n_pix >> 5;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int t = blockIdx.x;
  const float px = static_cast<float>((t % tiles_x) * tile_w + p % tile_w);
  const float py = static_cast<float>((t / tiles_x) * tile_h + p / tile_w);
  const long long plane = static_cast<long long>(n_tiles) * k_cap;
  const long long row0 = static_cast<long long>(t) * k_cap;
  const int count = max(0, min(counts[t], k_cap));

  const long long o = static_cast<long long>(t) * n_pix + p;
  const float g_rgb[3] = {g_out[3 * o + 0], g_out[3 * o + 1],
                          g_out[3 * o + 2]};
  const float g_dot_out = __fadd_rn(
      __fadd_rn(__fmul_rn(g_rgb[0], out[3 * o + 0]),
                __fmul_rn(g_rgb[1], out[3 * o + 1])),
      __fmul_rn(g_rgb[2], out[3 * o + 2]));
  const float tfin_term = __fmul_rn(g_tfin[o], final_t[o]);

  float trans = 1.0f;
  float prefix = 0.0f;
  bool done = false;

  for (int base = 0; base < count; base += kBatch) {
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, count - base);
    for (int i = p; i < kUsedRows * n; i += n_pix) {
      const int r = i / n, k = i - r * n;
      const long long e = row0 + base + k;
      float v;
      if (r < 5) v = planes[r * plane + e];
      else if (r == 5) v = valid[e] > 0.0f ? planes[5 * plane + e] : 0.0f;
      else v = rgb[3 * e + r - 6];
      stage[r * kBatch + k] = v;
    }
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      float v[kUsedRows];
#pragma unroll
      for (int r = 0; r < kUsedRows; ++r) v[r] = 0.0f;
      const bool include =
          !done && gs::backward_entry_exact(stage, kBatch, k, px, py, g_rgb,
                                            g_dot_out, tfin_term, trans,
                                            prefix, done, v);
      if (__any_sync(0xffffffffu, include)) {
#pragma unroll
        for (int r = 0; r < kUsedRows; ++r) v[r] = gs::warp_sum(v[r]);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kUsedRows; ++r)
          part[(warp * kUsedRows + r) * kBatch + k] = v[r];
      }
    }
    __syncthreads();
    for (int i = p; i < kUsedRows * n; i += n_pix) {
      const int r = i / n, k = i - r * n;
      float s = 0.0f;
      for (int wp = 0; wp < n_warps; ++wp)
        s = __fadd_rn(s, part[(wp * kUsedRows + r) * kBatch + k]);
      const long long e = row0 + base + k;
      if (r < 6) gplanes[r * plane + e] = s;
      else grgb[3 * e + r - 6] = s;
    }
  }
}

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, zeroed gplanes and
// grgb, and passes n_tiles > 0 and tile_w * tile_h a multiple of 32, at
// most 1024.
extern "C" int gs_padded_bwd(const float* planes, const float* rgb,
                             const float* valid, const int* counts,
                             const float* out, const float* final_t,
                             const float* g_out, const float* g_tfin,
                             float* gplanes, float* grgb, int n_tiles,
                             int k_cap, int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  const int n_pix = tile_w * tile_h;
  const size_t smem =
      sizeof(float) * kUsedRows * kBatch * (1 + n_pix / 32);
  padded_bwd_kernel<<<n_tiles, n_pix, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      planes, rgb, valid, counts, out, final_t, g_out, g_tfin, gplanes, grgb,
      n_tiles, k_cap, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
