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
// Outputs, the per-entry rule, what bounds the kernel on an H100 and its
// design are fwd_body.cuh's, the body B4 (padded_fwd.cu) shares; this file
// says where an entry is read (gs::StreamSlots, slots.cuh). Tile t of the
// call is the image tile tile_ids[t].

#include "fwd_body.cuh"

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, allocated the outputs,
// and passes n_tiles > 0, tile_w, tile_h > 0 (any shape: a tile of more
// than 1,024 pixels is walked in parts) and `order`, a permutation of
// [0, n_tiles) (int64): CTA b composites the tile order[b], and writes its
// row order[b] of the outputs.
extern "C" int gs_stream_fwd(const float* attrs, long long stride,
                             const int* seg_start, const int* counts,
                             const int* tile_ids, const long long* order,
                             const float* bg, float* out, float* final_t,
                             int n_tiles, int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  const gs::StreamSlots slots{attrs, stride, seg_start, counts, tile_ids};
  return fwd_launch<gs::StreamSlots, false>(slots, order, bg, out, final_t,
                                            n_tiles, tiles_x, tile_w, tile_h,
                                            stream);
}

extern "C" int gs_stream_fwd_fast(const float* attrs, long long stride,
                                  const int* seg_start, const int* counts,
                                  const int* tile_ids, const long long* order,
                                  const float* bg, float* out, float* final_t,
                                  int n_tiles, int tiles_x, int tile_w,
                                  int tile_h, void* stream) {
  const gs::StreamSlots slots{attrs, stride, seg_start, counts, tile_ids};
  return fwd_launch<gs::StreamSlots, true>(slots, order, bg, out, final_t,
                                           n_tiles, tiles_x, tile_w, tile_h,
                                           stream);
}

// Resident CTAs per SM and registers per thread of the launch at tile_w x
// tile_h (fast != 0: B3f, else B1), for chip_smoke.py's report.
extern "C" int gs_stream_fwd_occupancy(int fast, int tile_w, int tile_h,
                                       int* ctas_per_sm, int* registers) {
  return fast ? fwd_occupancy<gs::StreamSlots, true>(tile_w, tile_h,
                                                     ctas_per_sm, registers)
              : fwd_occupancy<gs::StreamSlots, false>(tile_w, tile_h,
                                                      ctas_per_sm, registers);
}

GS_SECTIONS_SETTER(gs_stream_fwd_sections)
