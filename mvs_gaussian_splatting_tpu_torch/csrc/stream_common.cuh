// Per-entry arithmetic shared by the composite kernels: stream_fwd.cu (B1
// and its fast-math instantiation), stream_bwd.cu (B2), stream_bwd_fast.cu
// (B3b), padded_fwd.cu (B4) and padded_bwd.cu (B5).
//
// A backward kernel replays its forward and takes the forward's include and
// terminate decisions from this replay. If one decision or one w differed
// from the forward's by a rounding, g.out - S_k would stop matching the
// saved out and the gradient would go wrong without any NaN. So a forward
// and its backward call the same inline functions below, and every
// operation in them is pinned with an explicit intrinsic, so that nvcc has
// no contraction choice to make differently in two kernels:
//   alpha (both modes): __fmul_rn / __fadd_rn / __fsub_rn, never contracted
//     into FMAs, and the full-precision expf: the rounding of the JAX
//     expression as written (build without --use_fast_math). Its 1/255
//     threshold decides which entries count, and an entry that flips moves
//     its pixel by up to 1/255 of a colour: with __expf in the fast mode, a
//     real view's fast image on an H100 moved 2.1e-3 from its plain
//     version, above the fast mode's 2e-3 contract, so alpha is exact in
//     both modes;
//   transmittance and colour sums: exact mode as written; fast mode T -
//     alpha T and the sums as one __fmaf_rn each. The 1e-4 threshold on T
//     ends a pixel where an entry weighs at most ~1e-4, so its flips stay
//     far inside the contract.
//
// Semantics (both modes): power = -0.5 (a dx^2 + c dy^2) - b dx dy,
// alpha = min(0.99, op exp(power)); the entry contributes iff power <= 0
// and alpha >= 1/255, and is included iff T (1 - alpha) >= 1e-4. The first
// contributing entry that fails that test is left out and ends the pixel.

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinTransmittance = 1e-4f;

// One entry seen from one pixel.
struct Entry {
  float dx, dy;  // entry centre minus pixel centre
  float g;       // exp(power)
  float raw;     // op * g, before the 0.99 clamp
  float alpha;   // min(0.99, raw)
};

// Fills e and returns whether the entry contributes at (px, py).
__device__ __forceinline__ bool entry_alpha(float x, float y, float ca,
                                            float cb, float cc, float op,
                                            float px, float py, Entry& e) {
  e.dx = __fsub_rn(x, px);
  e.dy = __fsub_rn(y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, e.dx), e.dx),
                               __fmul_rn(__fmul_rn(cc, e.dy), e.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, e.dx), e.dy));
  if (!(power <= 0.0f)) return false;
  e.g = expf(power);
  e.raw = __fmul_rn(op, e.g);
  // min(0.99, raw) that keeps a NaN, as jnp.minimum / torch.minimum do
  e.alpha = e.raw > kMaxAlpha ? kMaxAlpha : e.raw;
  return e.alpha >= kMinAlpha;
}

// Transmittance after an entry: T (1 - alpha); in fast mode T - alpha T
// with one rounding.
template <bool kFast>
__device__ __forceinline__ float transmit(float trans, float alpha) {
  return kFast ? __fmaf_rn(-alpha, trans, trans)
               : __fmul_rn(trans, __fsub_rn(1.0f, alpha));
}

// acc + w c
template <bool kFast>
__device__ __forceinline__ float accumulate(float acc, float w, float c) {
  return kFast ? __fmaf_rn(w, c, acc) : __fadd_rn(acc, __fmul_rn(w, c));
}

// One pixel's front-to-back walk over n staged entries (row r of entry k
// at stage[r * row_stride + k]; rows 0 x, 1 y, 2-4 conic, 5 opacity, 6-8
// rgb), carrying T, the colour sum and the done flag in registers.
template <bool kFast>
__device__ __forceinline__ void composite_batch(const float* stage,
                                                int row_stride, int n,
                                                float px, float py,
                                                float& trans, float acc[3],
                                                bool& done) {
  for (int k = 0; k < n; ++k) {
    Entry e;
    if (!entry_alpha(stage[k], stage[row_stride + k],
                     stage[2 * row_stride + k], stage[3 * row_stride + k],
                     stage[4 * row_stride + k], stage[5 * row_stride + k],
                     px, py, e))
      continue;
    const float next = transmit<kFast>(trans, e.alpha);
    if (next < kMinTransmittance) {
      done = true;
      break;
    }
    const float w = __fmul_rn(e.alpha, trans);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[c] = accumulate<kFast>(acc[c], w, stage[(6 + c) * row_stride + k]);
    trans = next;
  }
}

// Exact-mode backward of one staged entry at one pixel (B2, B5). Replays the
// entry with the forward's arithmetic; for an included entry writes its
// pixel's 9 partials into v (0 dx, 1 dy, 2-4 d(conic a, b, c), 5 d(op),
// 6-8 d(rgb)), advances T and the prefix S, and returns true. v is left as
// the caller set it otherwise. With T_k the transmittance before entry k,
// w_k = alpha_k T_k, g.v = sum_c g_out_c v_c and S_k = sum_{j<=k} w_j g.rgb_j:
//   dalpha = g.rgb T - (g.out - S) / (1 - alpha) - g_tfin T_fin / (1 - alpha),
//   dop = dalpha e^power and dpower = dalpha op e^power where op e^power <
//   0.99, both 0 on the clamp; dx = -dpower (a dx + b dy), dy = -dpower
//   (c dy + b dx), da = -dpower dx^2 / 2, db = -dpower dx dy,
//   dc = -dpower dy^2 / 2, drgb_c = g_out_c w.
__device__ __forceinline__ bool backward_entry_exact(
    const float* stage, int row_stride, int k, float px, float py,
    const float g_rgb[3], float g_dot_out, float tfin_term, float& trans,
    float& prefix, bool& done, float v[9]) {
  const float ca = stage[2 * row_stride + k];
  const float cb = stage[3 * row_stride + k];
  const float cc = stage[4 * row_stride + k];
  const float op = stage[5 * row_stride + k];
  Entry e;
  if (!entry_alpha(stage[k], stage[row_stride + k], ca, cb, cc, op, px,
                   py, e))
    return false;
  const float one_minus = __fsub_rn(1.0f, e.alpha);
  const float next = transmit<false>(trans, e.alpha);
  if (next < kMinTransmittance) {
    done = true;
    return false;
  }
  const float r = stage[6 * row_stride + k];
  const float gc = stage[7 * row_stride + k];
  const float b = stage[8 * row_stride + k];
  const float w = __fmul_rn(e.alpha, trans);
  const float g_dot_rgb = __fadd_rn(
      __fadd_rn(__fmul_rn(g_rgb[0], r), __fmul_rn(g_rgb[1], gc)),
      __fmul_rn(g_rgb[2], b));
  prefix = __fadd_rn(prefix, __fmul_rn(w, g_dot_rgb));
  const float dalpha = __fsub_rn(
      __fsub_rn(__fmul_rn(g_dot_rgb, trans),
                __fdiv_rn(__fsub_rn(g_dot_out, prefix), one_minus)),
      __fdiv_rn(tfin_term, one_minus));
  if (e.raw < kMaxAlpha) {
    const float dx = e.dx, dy = e.dy;
    const float dpower = __fmul_rn(__fmul_rn(dalpha, op), e.g);
    v[0] = __fmul_rn(dpower, -__fadd_rn(__fmul_rn(ca, dx), __fmul_rn(cb, dy)));
    v[1] = __fmul_rn(dpower, -__fadd_rn(__fmul_rn(cc, dy), __fmul_rn(cb, dx)));
    v[2] = __fmul_rn(dpower, __fmul_rn(__fmul_rn(-0.5f, dx), dx));
    v[3] = __fmul_rn(dpower, __fmul_rn(-dx, dy));
    v[4] = __fmul_rn(dpower, __fmul_rn(__fmul_rn(-0.5f, dy), dy));
    v[5] = __fmul_rn(dalpha, e.g);
  }
  v[6] = __fmul_rn(g_rgb[0], w);
  v[7] = __fmul_rn(g_rgb[1], w);
  v[8] = __fmul_rn(g_rgb[2], w);
  trans = next;
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace gs
