// Stream composite, backward (B2): the gradient of stream_fwd.cu's exact
// instantiation (B1) with respect to the packed attribute stream, by
// replaying that forward.
//
// Replaces the TPU kernel ops/pallas/stream.py:_stream_bwd_kernel (with its
// per-tile body _bwd_tile, exact branch) of the JAX package
// (mvs_gaussian_splatting_tpu). Only the math and the I/O contract carry
// over; the TPU structure (128-lane chunks, aligned DMA windows, the
// boundary read-merge of the previous tile's gradients, lane prefix scans)
// does not.
//
// Inputs
//   attrs, seg_start, counts, tile_ids, order  as in stream_fwd.cu;
//   bg [3] as in stream_fwd.cu; final_T [T, P] saved by the forward (its
//   out is not read: exact_bwd.cuh sums the colour suffix itself);
//   g_out [T, P, 3], g_tfin [T, P]  the cotangents.
// Output
//   gattrs [16, stride] f32, zeroed by the caller. For every entry a tile
//   visits before its early exit, the 9 used rows are written once:
//   0 dx, 1 dy, 2-4 d(conic a, b, c), 5 d(opacity), 6-8 d(rgb), each summed
//   over the tile's pixels. Every other column and rows 9-15 stay zero
//   (the kernel never visits columns outside the call's segments).
//
// The gradient, what bounds the kernel on an H100 and its design are
// exact_bwd.cuh's, the body B5 (padded_bwd.cu) shares; this file says where
// an entry's sums go (an entry is read as B1 reads it, slots.cuh).

#include "exact_bwd.cuh"

namespace {

// Entry k of tile t is the stream column seg_start[t] + k (gs::StreamSlots),
// its gradients the same column of gattrs.
struct StreamGradSlots : gs::StreamSlots {
  float* gattrs;

  // the sum of a first part, or one added to the earlier parts' (`add`)
  __device__ void store(long long e, int row, float v, bool add) const {
    float* dst = gattrs + row * stride + e;
    *dst = add ? __fadd_rn(*dst, v) : v;
  }
  // the columns past a tile's early exit stay as the caller zeroed them
  __device__ void clear(int, long long, int, int, int) const {}
};

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, zeroed gattrs, and
// passes n_tiles > 0, tile_w, tile_h > 0 (any shape: a tile of more than
// 1,024 pixels is walked in parts) and `order`, a permutation of
// [0, n_tiles) (int64): CTA b takes the tile order[b].
extern "C" int gs_stream_bwd(const float* attrs, long long stride,
                             const int* seg_start, const int* counts,
                             const int* tile_ids, const long long* order,
                             const float* bg, const float* final_t,
                             const float* g_out, const float* g_tfin,
                             float* gattrs, int n_tiles, int tiles_x,
                             int tile_w, int tile_h, void* stream) {
  const StreamGradSlots slots{{attrs, stride, seg_start, counts, tile_ids},
                              gattrs};
  return launch(slots, order, bg, final_t, g_out, g_tfin, n_tiles, tiles_x,
                tile_w, tile_h, stream);
}

// Resident CTAs per SM and registers per thread at tile_w x tile_h (the
// first argument is unused).
extern "C" int gs_stream_bwd_occupancy(int, int tile_w, int tile_h,
                                       int* ctas_per_sm, int* registers) {
  return occupancy<StreamGradSlots>(tile_w, tile_h, ctas_per_sm, registers);
}

GS_SECTIONS_SETTER(gs_stream_bwd_sections)
