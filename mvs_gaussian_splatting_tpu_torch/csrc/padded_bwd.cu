// Padded-table composite, backward (B5): the gradient of padded_fwd.cu
// (B4) with respect to its tables, in exact mode, by replaying B4.
//
// Replaces the TPU kernel ops/pallas/composite.py:_bwd_kernel of the JAX
// package (mvs_gaussian_splatting_tpu; entry _composite_vjp_bwd). Only the
// math and the I/O contract carry over.
//
// Inputs
//   planes, rgb, valid, counts, geometry  as in padded_fwd.cu; order as in
//   stream_bwd.cu;
//   bg [3] as in padded_fwd.cu; final_T [T, P] saved by the forward (its
//   out is not read: exact_bwd.cuh sums the colour suffix itself);
//   g_out [T, P, 3], g_tfin [T, P]  the cotangents.
// Outputs, every slot written by the kernel (the caller need not zero them)
//   gplanes [6, T, K]: d x, y, conic a, b, c, opacity;
//   grgb    [T, K, 3].
// Each slot a tile visits before its early exit gets its sums over the
// tile's pixels; every other slot (past the exit, at and past counts) a
// zero. A padded or invalid slot is never included, so it is written as an
// exact zero too: those slots index Gaussian 0 (ops/binning.py), and the
// gather's backward adds whatever they hold to Gaussian 0.
//
// The gradient, what bounds the kernel on an H100 and its design are
// exact_bwd.cuh's, the body B2 (stream_bwd.cu) shares; this file says where
// a slot's sums go. A slot is read as B4 reads it (slots.cuh): an invalid
// slot is staged with opacity 0, so its cull box is empty (cull_box) and no
// warp replays it.

#include "exact_bwd.cuh"

namespace {

// Entry k of tile t is the slot t K + k of the [T, K] tables
// (gs::PaddedSlots), its gradients the same slot of gplanes and grgb.
struct PaddedGradSlots : gs::PaddedSlots {
  float* gplanes;
  float* grgb;

  // the sum of a first part, or one added to the earlier parts' (`add`)
  __device__ void store(long long e, int row, float v, bool add) const {
    float* dst = row < 6 ? gplanes + row * plane + e : grgb + 3 * e + row - 6;
    *dst = add ? __fadd_rn(*dst, v) : v;
  }
  // zeros in the tile's slots [from, K): past its early exit and at and
  // past counts
  __device__ void clear(int, long long base, int from, int tid,
                        int threads) const {
    const int n = k_cap - from;
    for (int i = tid; i < 6 * n; i += threads) {
      const int r = i / n;
      gplanes[r * plane + base + from + (i - r * n)] = 0.0f;
    }
    for (int i = tid; i < 3 * n; i += threads)
      grgb[3 * (base + from) + i] = 0.0f;
  }
};

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, and passes n_tiles > 0,
// tile_w, tile_h > 0 (any shape) and `order`, a permutation of
// [0, n_tiles) (int64): CTA b takes the tile order[b].
extern "C" int gs_padded_bwd(const float* planes, const float* rgb,
                             const float* valid, const int* counts,
                             const long long* order, const float* bg,
                             const float* final_t, const float* g_out,
                             const float* g_tfin, float* gplanes, float* grgb,
                             int n_tiles, int k_cap, int tiles_x, int tile_w,
                             int tile_h, void* stream) {
  const PaddedGradSlots slots{
      {planes, rgb, valid, counts, static_cast<long long>(n_tiles) * k_cap,
       k_cap},
      gplanes,
      grgb};
  return launch(slots, order, bg, final_t, g_out, g_tfin, n_tiles, tiles_x,
                tile_w, tile_h, stream);
}

// Resident CTAs per SM and registers per thread at tile_w x tile_h (the
// first argument is unused).
extern "C" int gs_padded_bwd_occupancy(int, int tile_w, int tile_h,
                                       int* ctas_per_sm, int* registers) {
  return occupancy<PaddedGradSlots>(tile_w, tile_h, ctas_per_sm, registers);
}

GS_SECTIONS_SETTER(gs_padded_bwd_sections)
