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
//   out [T, P, 3], final_T [T, P] f32; tile t is the image's tile t.
// Tile t composites its slots k < min(counts[t], K) whose valid is > 0, in
// order. (The TPU kernel walks whole 128-slot chunks and gates each slot by
// valid alone; the two agree when the valid slots are the first counts[t],
// as ops/binning.py:bin_gaussians lays them out.)
//
// The kernel is B1's (fwd_body.cuh, exact mode): the same body, per-entry
// arithmetic, compact warp blocks, cull, cp.async staging, tile order and
// pixel parts; B4 differs only in where an entry is read (gs::PaddedSlots,
// slots.cuh). An invalid slot is staged with opacity 0, so its cull box is
// empty and it never contributes, as in the row-warp design this replaced,
// whose outputs it gives to the bit.

#include "fwd_body.cuh"

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, allocated the outputs,
// and passes n_tiles > 0, tile_w, tile_h > 0 (any shape) and `order`, a
// permutation of [0, n_tiles) (int64): CTA b composites the tile order[b].
extern "C" int gs_padded_fwd(const float* planes, const float* rgb,
                             const float* valid, const int* counts,
                             const long long* order, const float* bg,
                             float* out, float* final_t, int n_tiles,
                             int k_cap, int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  const gs::PaddedSlots slots{planes, rgb, valid, counts,
                              static_cast<long long>(n_tiles) * k_cap, k_cap};
  return fwd_launch<gs::PaddedSlots, false>(slots, order, bg, out, final_t,
                                            n_tiles, tiles_x, tile_w, tile_h,
                                            stream);
}

// Resident CTAs per SM and registers per thread at tile_w x tile_h (the
// first argument is unused).
extern "C" int gs_padded_fwd_occupancy(int, int tile_w, int tile_h,
                                       int* ctas_per_sm, int* registers) {
  return fwd_occupancy<gs::PaddedSlots, false>(tile_w, tile_h, ctas_per_sm,
                                               registers);
}

GS_SECTIONS_SETTER(gs_padded_fwd_sections)
