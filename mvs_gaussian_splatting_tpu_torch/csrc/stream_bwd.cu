// Stream composite, backward: the gradient of stream_fwd.cu with respect to
// the packed attribute stream, in exact mode, by replaying the forward.
//
// Replaces the TPU kernel ops/pallas/stream.py:_stream_bwd_kernel (with its
// per-tile body _bwd_tile, exact branch) of the JAX package
// (mvs_gaussian_splatting_tpu). Only the math and the I/O contract carry
// over; the TPU structure (128-lane chunks, aligned DMA windows, the
// boundary read-merge of the previous tile's gradients, lane prefix scans,
// the fast-math moment matrix product) does not.
//
// Inputs
//   attrs, seg_start, counts, tile_ids, geometry  as in stream_fwd.cu;
//   out [T, P, 3], final_T [T, P]   saved by the forward;
//   g_out [T, P, 3], g_tfin [T, P]  the cotangents.
// Output
//   gattrs [16, stride] f32, zeroed by the caller. For every entry a tile
//   visits before its early exit, the 9 used rows are written once:
//   0 dx, 1 dy, 2-4 d(conic a, b, c), 5 d(opacity), 6-8 d(rgb), each summed
//   over the tile's pixels. Every other column and rows 9-15 stay zero.
//
// Per pixel, with T_k the transmittance before entry k, w_k = alpha_k T_k,
// g.v = sum_c g_out_c v_c and the inclusive prefix S_k = sum_{j<=k} w_j g.rgb_j,
//   dalpha_k = g.rgb_k T_k - (g.out - S_k) / (1 - alpha_k)
//              - g_tfin T_fin / (1 - alpha_k)
// for an included entry, 0 otherwise. Through alpha = min(0.99, op e^power):
//   dop = dalpha e^power and dpower = dalpha op e^power where op e^power <
//   0.99, both 0 on the clamp; dx = -dpower (a dx + b dy), dy = -dpower
//   (c dy + b dx), da = -dpower dx^2 / 2, db = -dpower dx dy,
//   dc = -dpower dy^2 / 2, drgb_c = g_out_c w.
//
// The replay has to take the forward's include and terminate decisions
// exactly: if one differs, g.out - S_k no longer matches the saved out and
// the gradient goes wrong without any NaN. So the replay is
// stream_common.cuh's backward_entry_exact, built on the same inline
// functions as stream_fwd.cu's exact instantiation.
//
// What bounds it on an H100: operations. Each (entry, pixel) pair a tile
// visits costs about 20 f32 operations of replay, about 30 of gradient and a
// share of the pixel reduction, while each entry is read once and written
// once for the whole tile (72 bytes for 512 pairs at 32x16 tiles).
// What the design does about it: one CTA per tile, one thread per pixel,
// with T and the prefix S in registers. The segment is staged through shared
// memory in batches of kBatch entries. Per entry, each thread computes its
// pixel's 9 partials, each warp sums them with shuffles (skipped when no
// lane of the warp includes the entry), and after the batch the per-warp
// sums in shared memory are added in warp order and stored, one thread per
// (row, entry). Every instance slot belongs to one tile, so no atomics are
// needed. A pixel past its terminating entry contributes zeros, and the
// tile stops at the first batch where every pixel is done.
// Overlapping the next batch's load (cp.async / TMA) and a cheaper
// reduction are left for later.

#include "stream_common.cuh"

namespace {

constexpr int kUsedRows = 9;
constexpr int kBatch = 32;  // entries staged per batch

__global__ void stream_bwd_kernel(const float* __restrict__ attrs,
                                  long long stride,
                                  const int* __restrict__ seg_start,
                                  const int* __restrict__ counts,
                                  const int* __restrict__ tile_ids,
                                  const float* __restrict__ out,
                                  const float* __restrict__ final_t,
                                  const float* __restrict__ g_out,
                                  const float* __restrict__ g_tfin,
                                  float* __restrict__ gattrs,
                                  int tiles_x, int tile_w, int tile_h) {
  extern __shared__ float smem[];
  float* stage = smem;                       // [kUsedRows][kBatch]
  float* part = smem + kUsedRows * kBatch;   // [warps][kUsedRows][kBatch]
  const int n_pix = tile_w * tile_h;
  const int n_warps = n_pix >> 5;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int t = blockIdx.x;

  const int tile = tile_ids[t];
  const float px = static_cast<float>((tile % tiles_x) * tile_w + p % tile_w);
  const float py = static_cast<float>((tile / tiles_x) * tile_h + p / tile_w);

  const long long start = seg_start[t];
  const long long room = stride - start;
  const int count = static_cast<int>(
      max(0LL, min(static_cast<long long>(counts[t]), room)));

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
    // Uniform barrier: ends the tile once every pixel is done, and keeps the
    // previous batch's readers of stage/part ahead of this batch's writers.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, count - base);
    for (int i = p; i < kUsedRows * n; i += n_pix) {
      const int r = i / n, k = i - r * n;
      stage[r * kBatch + k] = attrs[r * stride + start + base + k];
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
      // the whole warp takes the same branch: shuffles need every lane
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
      gattrs[r * stride + start + base + k] = s;
    }
  }
}

}  // namespace

// Launches one CTA per tile on `stream` and returns cudaGetLastError().
// The caller has checked shapes, types and devices, zeroed gattrs, and
// passes n_tiles > 0 and tile_w * tile_h a multiple of 32, at most 1024.
extern "C" int gs_stream_bwd(const float* attrs, long long stride,
                             const int* seg_start, const int* counts,
                             const int* tile_ids, const float* out,
                             const float* final_t, const float* g_out,
                             const float* g_tfin, float* gattrs, int n_tiles,
                             int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  const int n_pix = tile_w * tile_h;
  const size_t smem =
      sizeof(float) * kUsedRows * kBatch * (1 + n_pix / 32);
  stream_bwd_kernel<<<n_tiles, n_pix, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      attrs, stride, seg_start, counts, tile_ids, out, final_t, g_out, g_tfin,
      gattrs, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
