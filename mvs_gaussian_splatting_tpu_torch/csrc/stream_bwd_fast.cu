// Stream composite, backward in fast mode (B3b): the gradient of
// stream_fwd.cu's fast instantiation with respect to the packed attribute
// stream, by replaying that forward, with the per-entry pixel sums taken as
// TF32 tensor-core products of pixel moments.
//
// Replaces the TPU kernel ops/pallas/stream.py:_stream_bwd_kernel with its
// per-tile body _bwd_tile in fast mode (fast=True: the moment product of
// stream.py:301-311 and 362-402, FAST_BWD_HILO). Only the math and the I/O
// contract carry over, as for stream_bwd.cu (B2).
//
// Inputs, output and the per-pixel gradient are B2's (see stream_bwd.cu),
// with the fast replay of stream_common.cuh. Every per-entry gradient is a
// polynomial in (dx, dy) = (xl - pxl, yl - pyl), where (xl, yl) is the
// entry's centre and (pxl, pyl) the pixel's, both relative to the tile
// centre (ox, oy) = (x0 + tile_w / 2, y0 + tile_h / 2). The sum over a
// tile's pixels therefore needs only six moments of dpower and the colour
// sums:
//   s0 = sum dpower, s1x = sum dpower pxl, s1y = sum dpower pyl,
//   s2xx = sum dpower pxl^2, s2xy = sum dpower pxl pyl, s2yy = sum dpower pyl^2,
//   sum_p g_out_c w  (c = r, g, b),
// after which, per entry (stream.py:390-401),
//   mx = xl s0 - s1x, my = yl s0 - s1y,
//   dx = -(a mx + b my), dy = -(c my + b mx),
//   da = -(xl mx - xl s1x + s2xx) / 2, db = -(xl my - yl s1x + s2xy),
//   dc = -(yl my - yl s1y + s2yy) / 2, dop = s0 / op (0 where op <= 0),
//   drgb_c = sum_p g_out_c w.
// Those sums are one product M[16 x E] = Phi[16 x P] . D[P x E] per block
// of entries, with Phi rows per pixel: 0 one, 1 pxl, 2 pyl, 3 pxl^2,
// 4 pxl pyl, 5 pyl^2, 6-8 g_out hi, 9-11 g_out lo, 12-15 zero. Rows 0-5
// are small integers (|pxl|, |pyl| <= 32, so at most 1024), exact in TF32.
// D is dpower for rows 0-5 and w for rows 6-11, each split into a TF32 hi
// part and a TF32 lo part (the f32 remainder), as FAST_BWD_HILO splits
// dpower into bf16 hi + lo on the TPU; g_out rides in Phi as in the JAX
// kernel, also split hi + lo, so the colour sums are
// M[6 + c] + M[9 + c] = sum (g_hi + g_lo)(w_hi + w_lo): all four products,
// near-f32. The closed forms cancel where an entry's centre lies far from
// the tile (mx by about |xl| / tile, the conic terms by its square), as in
// the JAX kernel: the moments are therefore kept near f32, not TF32.
//
// What bounds it on an H100: operations. Per visited (entry, pixel) pair the
// replay costs about 30 f32 operations on the CUDA cores; the moment product
// is 4 x 16 multiply-adds per pair (hi and lo of D for each of 16 Phi
// rows, for dpower and for w), 1/16 of an m16n8k8 per pair on the tensor
// cores, where B2 spends 9 shuffle reductions (45 shuffles and adds per
// warp per entry).
// What the design does about it: one CTA per tile, one thread per pixel,
// T and the prefix S in registers, the segment staged through shared
// memory in batches of kBatch entries as in B2. Each thread replays 8
// entries at a time and writes its dpower and w into its warp's shared
// [8 entries x 32 pixels] buffers (row stride 36: conflict-free reads of
// the B fragments); the warp then issues 4 k-steps of
// mma.sync.m16n8k8.tf32 (hi and lo, for dpower and for w) with the loop-
// invariant Phi fragments in registers, skipped when no lane of the warp
// includes any of the 8 entries, and stores its [12 x 8] partial sums.
// After the batch the per-warp partials are added in warp order, one thread
// per (row, entry), and one thread per entry writes the closed forms. Every
// instance slot belongs to one tile, so no atomics are needed. wgmma,
// cp.async / TMA staging and a reduction across warps in the tensor cores
// are left for later.

#include <cstdint>

#include "stream_common.cuh"

namespace {

constexpr int kUsedRows = 9;
constexpr int kBatch = 32;    // entries staged per batch
constexpr int kGroup = 8;     // entries per MMA block (n = 8)
constexpr int kXStride = 36;  // row stride of a warp's [8 x 32] buffer
constexpr int kMomRows = 12;  // Phi rows kept: 6 moments, 3 g hi, 3 g lo

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as a TF32 hi part and the TF32 of its f32 remainder
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a . b for one m16n8k8 TF32 block, f32 accumulation
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phi row `row` at pixel p of the tile whose g_out rows start at g_tile.
__device__ __forceinline__ float phi(int row, int p, int tile_w, int tile_h,
                                     const float* g_tile) {
  const float pxl = static_cast<float>(p % tile_w - tile_w / 2);
  const float pyl = static_cast<float>(p / tile_w - tile_h / 2);
  if (row >= 6 && row < 12) {
    uint32_t hi, lo;
    split_tf32(g_tile[3 * p + (row - 6) % 3], hi, lo);
    return __uint_as_float(row < 9 ? hi : lo);
  }
  switch (row) {
    case 0: return 1.0f;
    case 1: return pxl;
    case 2: return pyl;
    case 3: return pxl * pxl;
    case 4: return pxl * pyl;
    case 5: return pyl * pyl;
    default: return 0.0f;
  }
}

__global__ void stream_bwd_fast_kernel(const float* __restrict__ attrs,
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
  const int n_pix = tile_w * tile_h;
  const int n_warps = n_pix >> 5;
  float* stage = smem;                                 // [9][kBatch]
  float* part = stage + kUsedRows * kBatch;            // [warps][12][kBatch]
  float* xbuf = part + n_warps * kMomRows * kBatch;    // [warps][2][8][36]
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int gid = lane >> 2;  // MMA groupID: row of A and C, column of B
  const int tig = lane & 3;   // MMA thread in group
  const int t = blockIdx.x;
  float* xd = xbuf + warp * 2 * kGroup * kXStride;  // dpower [8][36]
  float* xw = xd + kGroup * kXStride;               // w      [8][36]

  const int tile = tile_ids[t];
  const int x0 = (tile % tiles_x) * tile_w;
  const int y0 = (tile / tiles_x) * tile_h;
  const float px = static_cast<float>(x0 + p % tile_w);
  const float py = static_cast<float>(y0 + p / tile_w);
  const float ox = static_cast<float>(x0 + tile_w / 2);
  const float oy = static_cast<float>(y0 + tile_h / 2);

  const long long start = seg_start[t];
  const long long room = stride - start;
  const int count = static_cast<int>(
      max(0LL, min(static_cast<long long>(counts[t]), room)));

  const long long o = static_cast<long long>(t) * n_pix + p;
  const float g_rgb[3] = {g_out[3 * o + 0], g_out[3 * o + 1],
                          g_out[3 * o + 2]};
  const float g_dot_out = __fmaf_rn(
      g_rgb[2], out[3 * o + 2],
      __fmaf_rn(g_rgb[1], out[3 * o + 1], __fmul_rn(g_rgb[0], out[3 * o])));
  const float tfin_term = __fmul_rn(g_tfin[o], final_t[o]);

  // Phi's A fragments, loop-invariant: k-step s covers the warp's pixels
  // 8s .. 8s+7; a0 = Phi[gid][tig], a1 = Phi[gid+8][tig], a2 = Phi[gid][tig+4],
  // a3 = Phi[gid+8][tig+4] (PTX m16n8k8 .tf32 fragment layout).
  const float* g_tile = g_out + 3 * static_cast<long long>(t) * n_pix;
  uint32_t afrag[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int p0 = warp * 32 + 8 * s + tig;
    afrag[s][0] = to_tf32(phi(gid, p0, tile_w, tile_h, g_tile));
    afrag[s][1] = to_tf32(phi(gid + 8, p0, tile_w, tile_h, g_tile));
    afrag[s][2] = to_tf32(phi(gid, p0 + 4, tile_w, tile_h, g_tile));
    afrag[s][3] = to_tf32(phi(gid + 8, p0 + 4, tile_w, tile_h, g_tile));
  }

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

    for (int grp = 0; grp < n; grp += kGroup) {
      bool any_included = false;
      for (int j = 0; j < kGroup; ++j) {
        const int k = grp + j;
        float dpower = 0.0f, w = 0.0f;
        gs::Entry e;
        if (k < n && !done &&
            gs::entry_alpha(
                stage[k], stage[kBatch + k], stage[2 * kBatch + k],
                stage[3 * kBatch + k], stage[4 * kBatch + k],
                stage[5 * kBatch + k], px, py, e)) {
          const float next = gs::transmit<true>(trans, e.alpha);
          if (next < gs::kMinTransmittance) {
            done = true;
          } else {
            any_included = true;
            w = __fmul_rn(e.alpha, trans);
            const float g_dot_rgb = __fmaf_rn(
                g_rgb[2], stage[8 * kBatch + k],
                __fmaf_rn(g_rgb[1], stage[7 * kBatch + k],
                          __fmul_rn(g_rgb[0], stage[6 * kBatch + k])));
            prefix = __fmaf_rn(w, g_dot_rgb, prefix);
            const float one_minus = __fsub_rn(1.0f, e.alpha);
            const float dalpha = __fsub_rn(
                __fmul_rn(g_dot_rgb, trans),
                __fdiv_rn(__fadd_rn(__fsub_rn(g_dot_out, prefix), tfin_term),
                          one_minus));
            if (e.raw < gs::kMaxAlpha)
              dpower = __fmul_rn(__fmul_rn(dalpha, stage[5 * kBatch + k]),
                                 e.g);
            trans = next;
          }
        }
        xd[j * kXStride + lane] = dpower;
        xw[j * kXStride + lane] = w;
      }
      __syncwarp();
      float md[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // Phi . dpower
      float mw[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // Phi . w
      if (__any_sync(0xffffffffu, any_included)) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // b0 = D[tig][gid], b1 = D[tig+4][gid]: pixel 8s+tig(+4), entry gid
          uint32_t hi0, lo0, hi1, lo1;
          split_tf32(xd[gid * kXStride + 8 * s + tig], hi0, lo0);
          split_tf32(xd[gid * kXStride + 8 * s + tig + 4], hi1, lo1);
          mma_tf32(md, afrag[s], hi0, hi1);
          mma_tf32(md, afrag[s], lo0, lo1);
          split_tf32(xw[gid * kXStride + 8 * s + tig], hi0, lo0);
          split_tf32(xw[gid * kXStride + 8 * s + tig + 4], hi1, lo1);
          mma_tf32(mw, afrag[s], hi0, hi1);
          mma_tf32(mw, afrag[s], lo0, lo1);
        }
      }
      // C fragment: c0, c1 = M[gid][2 tig + {0, 1}], c2, c3 = M[gid + 8][..]
      float* dst = part + warp * kMomRows * kBatch + grp + 2 * tig;
      if (gid < 6) {
        dst[gid * kBatch] = md[0];
        dst[gid * kBatch + 1] = md[1];
      } else {
        dst[gid * kBatch] = mw[0];          // rows 6, 7: g hi . w
        dst[gid * kBatch + 1] = mw[1];
      }
      if (gid < 4) {
        dst[(gid + 8) * kBatch] = mw[2];    // rows 8-11: g hi, g lo . w
        dst[(gid + 8) * kBatch + 1] = mw[3];
      }
      __syncwarp();  // the buffers' readers ahead of the next group's writers
    }
    __syncthreads();
    // sum the warps' partials in warp order, into warp 0's slots
    for (int i = p; i < kMomRows * n; i += n_pix) {
      const int r = i / n, k = i - r * n;
      float s = 0.0f;
      for (int wp = 0; wp < n_warps; ++wp)
        s = __fadd_rn(s, part[(wp * kMomRows + r) * kBatch + k]);
      part[r * kBatch + k] = s;
    }
    __syncthreads();
    if (p < n) {
      const int k = p;
      const float* m = part + k;
      const float s0 = m[0], s1x = m[kBatch], s1y = m[2 * kBatch];
      const float s2xx = m[3 * kBatch], s2xy = m[4 * kBatch];
      const float s2yy = m[5 * kBatch];
      const float xl = __fsub_rn(stage[k], ox);
      const float yl = __fsub_rn(stage[kBatch + k], oy);
      const float ca = stage[2 * kBatch + k], cb = stage[3 * kBatch + k];
      const float cc = stage[4 * kBatch + k], op = stage[5 * kBatch + k];
      const float mx = xl * s0 - s1x;
      const float my = yl * s0 - s1y;
      float* g = gattrs + start + base + k;
      g[0] = -(ca * mx + cb * my);
      g[stride] = -(cc * my + cb * mx);
      g[2 * stride] = -0.5f * (xl * mx - xl * s1x + s2xx);
      g[3 * stride] = -(xl * my - yl * s1x + s2xy);
      g[4 * stride] = -0.5f * (yl * my - yl * s1y + s2yy);
      g[5 * stride] = op > 0.0f ? s0 / op : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        g[(6 + c) * stride] = m[(6 + c) * kBatch] + m[(9 + c) * kBatch];
    }
  }
}

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, zeroed gattrs, and
// passes n_tiles > 0, tile_w * tile_h a multiple of 32 and at most 1024,
// and tile_w, tile_h <= 64 (so Phi's moment rows are exact in TF32).
extern "C" int gs_stream_bwd_fast(const float* attrs, long long stride,
                                  const int* seg_start, const int* counts,
                                  const int* tile_ids, const float* out,
                                  const float* final_t, const float* g_out,
                                  const float* g_tfin, float* gattrs,
                                  int n_tiles, int tiles_x, int tile_w,
                                  int tile_h, void* stream) {
  const int n_pix = tile_w * tile_h;
  const int n_warps = n_pix / 32;
  const size_t smem =
      sizeof(float) * (kUsedRows * kBatch + n_warps * kMomRows * kBatch +
                       n_warps * 2 * kGroup * kXStride);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_bwd_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stream_bwd_fast_kernel<<<n_tiles, n_pix, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      attrs, stride, seg_start, counts, tile_ids, out, final_t, g_out, g_tfin,
      gattrs, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
