// Where the composite kernels read entry k of tile t: the read half of the
// two layouts, shared by the forward body (fwd_body.cuh: B1 and B3f on the
// stream, B4 on padded tables) and the exact backward body (exact_bwd.cuh:
// B2, B5), which add where a gradient goes (stream_bwd.cu, padded_bwd.cu).
//
// A layout policy maps (t, k) to one column e = base(t) + k, k < count(t),
// names the image tile of the kernel's tile t (tile(t)), starts copying
// column e into an entry-major stage slot (stream_common.cuh: kSlot) with
// cp.async (stage), and, once the copy has landed, fixes up the slot before
// its cull box is taken (fix).

#pragma once

#include "stream_common.cuh"

namespace gs {

// The packed stream attrs [16, stride]: entry k of tile t is the column
// seg_start[t] + k; tile t is the image tile tile_ids[t].
struct StreamSlots {
  const float* attrs;
  long long stride;
  const int* seg_start;
  const int* counts;
  const int* tile_ids;

  __device__ long long base(int t) const { return seg_start[t]; }
  // never read past the stream, whatever the caller passed
  __device__ int count(int t) const {
    return static_cast<int>(max(
        0LL, min(static_cast<long long>(counts[t]), stride - seg_start[t])));
  }
  __device__ int tile(int t) const { return tile_ids[t]; }
  __device__ void stage(float* slot, long long e) const {
    stage_async(slot, attrs + e, stride);
  }
  __device__ void fix(float*) const {}
};

// Padded tables planes [6, T, K] (x, y, conic a, b, c, opacity), rgb
// [T, K, 3] and valid [T, K]: entry k of tile t is the slot t K + k,
// k < min(counts[t], K); tile t is the image tile t.
struct PaddedSlots {
  const float* planes;
  const float* rgb;
  const float* valid;
  const int* counts;
  long long plane;  // T K: the stride of a plane
  int k_cap;

  __device__ long long base(int t) const {
    return static_cast<long long>(t) * k_cap;
  }
  __device__ int count(int t) const { return max(0, min(counts[t], k_cap)); }
  __device__ int tile(int t) const { return t; }
  // the slot's attributes into the entry-major stage slot, and its valid
  // flag into the slot's unused last float
  __device__ void stage(float* slot, long long e) const {
    copy_async(slot, planes + e);
    copy_async(slot + 1, planes + plane + e);
#pragma unroll
    for (int r = 2; r < 6; ++r) copy_async(slot + r + 2, planes + r * plane + e);
#pragma unroll
    for (int c = 0; c < 3; ++c) copy_async(slot + 8 + c, rgb + 3 * e + c);
    copy_async(slot + 11, valid + e);
  }
  // an invalid slot composites nothing: opacity 0, so that its cull box is
  // empty (cull_box) and no warp walks it
  __device__ void fix(float* slot) const {
    if (!(slot[11] > 0.0f)) slot[7] = 0.0f;
  }
};

}  // namespace gs
