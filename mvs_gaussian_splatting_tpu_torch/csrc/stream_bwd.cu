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
//   out [T, P, 3], final_T [T, P]   saved by the forward;
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
// an entry is read and where its sums go.

#include "exact_bwd.cuh"

namespace {

// Entry k of tile t is the stream column seg_start[t] + k, its gradients
// the same column of gattrs.
struct StreamSlots {
  const float* attrs;
  long long stride;
  const int* seg_start;
  const int* counts;
  const int* tile_ids;
  float* gattrs;

  __device__ long long base(int t) const { return seg_start[t]; }
  // never read past the stream, whatever the caller passed
  __device__ int count(int t) const {
    return static_cast<int>(max(
        0LL, min(static_cast<long long>(counts[t]), stride - seg_start[t])));
  }
  __device__ int tile(int t) const { return tile_ids[t]; }
  __device__ void stage(float* slot, long long e) const {
    gs::stage_async(slot, attrs + e, stride);
  }
  __device__ void fix(float*) const {}
  __device__ void store(long long e, int row, float v) const {
    gattrs[row * stride + e] = v;
  }
  // the columns past a tile's early exit stay as the caller zeroed them
  __device__ void clear(int, long long, int, int, int) const {}
};

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, zeroed gattrs, and
// passes n_tiles > 0, 0 < tile_w * tile_h <= 1024 and `order`, a
// permutation of [0, n_tiles) (int64): CTA b takes the tile order[b].
extern "C" int gs_stream_bwd(const float* attrs, long long stride,
                             const int* seg_start, const int* counts,
                             const int* tile_ids, const long long* order,
                             const float* out, const float* final_t,
                             const float* g_out, const float* g_tfin,
                             float* gattrs, int n_tiles, int tiles_x,
                             int tile_w, int tile_h, void* stream) {
  const StreamSlots slots{attrs, stride, seg_start, counts, tile_ids, gattrs};
  return launch(slots, order, out, final_t, g_out, g_tfin, n_tiles, tiles_x,
                tile_w, tile_h, stream);
}

// Resident CTAs per SM and registers per thread at tile_w x tile_h (the
// first argument is unused).
extern "C" int gs_stream_bwd_occupancy(int, int tile_w, int tile_h,
                                       int* ctas_per_sm, int* registers) {
  return occupancy<StreamSlots>(tile_w, tile_h, ctas_per_sm, registers);
}

GS_SECTIONS_SETTER(gs_stream_bwd_sections)
