// Padded-table composite, forward (B4): the per-tile front-to-back alpha
// composite over fixed-capacity per-tile tables, in exact mode.
//
// Replaces the TPU kernel ops/pallas/composite.py:_fwd_kernel of the JAX
// package (mvs_gaussian_splatting_tpu; entry composite_pallas /
// composite_tiles_pallas, backend "pallas"). Only the math and the I/O
// contract carry over; the TPU layout (128-lane chunks of the [T, 1, K]
// planes, the log-step lane scans of _chunk_include) does not.
//
// Inputs
//   planes  [6, T, K] f32: x, y, conic a, b, c, opacity of tile t's k-th
//           entry at planes[r][t][k];
//   rgb     [T, K, 3] f32; valid [T, K] f32 (> 0 where the slot holds an
//           entry); counts [T] i32; bg [3] f32 (device memory).
// Outputs
//   out [T, P, 3], final_T [T, P] f32, as stream_fwd.cu; tile t is the
//   image's tile t (pixel p at px = (t % tiles_x) * tile_w + p % tile_w,
//   py = (t / tiles_x) * tile_h + p / tile_w).
// Tile t composites its slots k < min(counts[t], K) whose valid is > 0, in
// order. (The TPU kernel walks whole 128-slot chunks and gates each slot by
// valid alone; the two agree when the valid slots are the first counts[t],
// as ops/binning.py:bin_gaussians lays them out.)
//
// The per-entry arithmetic is stream_common.cuh's exact mode, the same
// inline functions as B1 (stream_fwd.cu): B4 differs from B1 only in where
// an entry's attributes are read. An invalid slot is staged with opacity 0,
// so its alpha is 0 and it never contributes.
//
// What bounds it on an H100: operations, as for B1 (about 20 f32
// operations and an expf per visited pair; each slot is read once per
// tile). The design is B1's: one CTA per tile, one thread per pixel, T and
// the colour sum in registers, the table staged through shared memory in
// batches of P slots, the tile ending at the first batch boundary where
// every pixel is done. Built with -DGS_SECTION_CLOCKS (profile_kernels.py)
// it counts its warp-steps and splits its time as B1 does (sections.cuh).

#include "sections.cuh"
#include "stream_common.cuh"

namespace {

constexpr int kUsedRows = 9;

__global__ void padded_fwd_kernel(const float* __restrict__ planes,
                                  const float* __restrict__ rgb,
                                  const float* __restrict__ valid,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ bg,
                                  float* __restrict__ out,
                                  float* __restrict__ final_t, int n_tiles,
                                  int k_cap, int tiles_x, int tile_w,
                                  int tile_h) {
  extern __shared__ float stage[];  // [kUsedRows][P]
  const int n_pix = tile_w * tile_h;
  const int p = threadIdx.x;
  const int t = blockIdx.x;
  const float px = static_cast<float>((t % tiles_x) * tile_w + p % tile_w);
  const float py = static_cast<float>((t / tiles_x) * tile_h + p / tile_w);
  const long long plane = static_cast<long long>(n_tiles) * k_cap;
  const long long row0 = static_cast<long long>(t) * k_cap;
  const int count = max(0, min(counts[t], k_cap));
  GS_SEC_TILE_BEGIN();
  GS_SEC_INIT();

  float trans = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  bool done = false;

  for (int base = 0; base < count; base += n_pix) {
    GS_SEC_MARK(1);
    if (__syncthreads_count(!done) == 0) break;
    GS_SEC_MARK(3);
    const int n = min(n_pix, count - base);
    if (p < n) {
      const long long e = row0 + base + p;
#pragma unroll
      for (int r = 0; r < 5; ++r) stage[r * n_pix + p] = planes[r * plane + e];
      stage[5 * n_pix + p] = valid[e] > 0.0f ? planes[5 * plane + e] : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) stage[(6 + c) * n_pix + p] = rgb[3 * e + c];
    }
    __syncthreads();
    GS_SEC_MARK(0);
    if (done) continue;
    // the pixel's front-to-back walk over the batch, T, the colour sum and
    // the done flag in registers (row r of slot k at stage[r n_pix + k])
    for (int k = 0; k < n; ++k) {
      GS_SEC_COUNT(0);
      GS_SEC_COUNT_LANE(2);
      gs::Entry e;
      if (!gs::entry_alpha(stage[k], stage[n_pix + k], stage[2 * n_pix + k],
                           stage[3 * n_pix + k], stage[4 * n_pix + k],
                           stage[5 * n_pix + k], px, py, e))
        continue;
      GS_SEC_COUNT(1);
      GS_SEC_COUNT_LANE(4);
      const float next = gs::transmit<false>(trans, e.alpha);
      if (next < gs::kMinTransmittance) {
        done = true;
        break;
      }
      const float w = __fmul_rn(e.alpha, trans);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = gs::accumulate<false>(acc[c], w,
                                       stage[(6 + c) * n_pix + k]);
      trans = next;
    }
  }
  GS_SEC_MARK(1);

  const long long o = static_cast<long long>(t) * n_pix + p;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[3 * o + c] = __fadd_rn(acc[c], __fmul_rn(trans, bg[c]));
  final_t[o] = trans;
  GS_SEC_MARK(2);
  GS_SEC_FLUSH();
  GS_SEC_TILE_END();
}

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, allocated the outputs,
// and passes n_tiles > 0 and tile_w * tile_h at most 1024.
extern "C" int gs_padded_fwd(const float* planes, const float* rgb,
                             const float* valid, const int* counts,
                             const float* bg, float* out, float* final_t,
                             int n_tiles, int k_cap, int tiles_x, int tile_w,
                             int tile_h, void* stream) {
  const int n_pix = tile_w * tile_h;
  const size_t smem = sizeof(float) * kUsedRows * n_pix;
  padded_fwd_kernel<<<n_tiles, n_pix, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      planes, rgb, valid, counts, bg, out, final_t, n_tiles, k_cap, tiles_x,
      tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

GS_SECTIONS_SETTER(gs_padded_fwd_sections)
