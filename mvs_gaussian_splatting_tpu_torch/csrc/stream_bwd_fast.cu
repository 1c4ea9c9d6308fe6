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
// part and a TF32 lo part (the f32 remainder; split_trunc), as
// FAST_BWD_HILO splits dpower into bf16 hi + lo on the TPU; g_out rides in
// Phi as in the JAX kernel, also split hi + lo, so the colour sums are
// M[6 + c] + M[9 + c] = sum (g_hi + g_lo)(w_hi + w_lo): all four products,
// near-f32. The closed forms cancel where an entry's centre lies far from
// the tile (mx by about |xl| / tile, the conic terms by its square), as in
// the JAX kernel: the moments are therefore kept near f32, not TF32.
//
// What bounds it on an H100: issued instructions. Per visited (entry,
// pixel) pair the replay costs about 30 f32 operations and an expf on the
// CUDA cores (a design with row warps issued ~102 SASS instructions per
// warp-step in its replay loop); the moment product is 4 x 16
// multiply-adds per pair (hi and lo of D for each of 16 Phi rows, for
// dpower and for w), 1/16 of an m16n8k8 per pair on the tensor cores.
// What the design does about it: one CTA per tile, one thread per pixel,
// T and the prefix S in registers, and
//   - B3f's compact 8 x 4 warp blocks and per-warp cull (stream_fwd.cu,
//     stream_common.cuh): a culled (warp, entry) contributes exact zeros to
//     the product, as an entry no pixel includes does;
//   - the segment staged entry-major with its cull boxes in batches of
//     kBatch = 64 entries by cp.async into two buffers, the next batch's
//     copy running during this one: three barriers per 64 entries (the
//     row-warp design: four per 32);
//   - each thread replays 8 entries at a time and writes its dpower and w
//     into its warp's shared [8 entries x 32 pixels] buffers (d_slot:
//     conflict-free, one 8-byte load per B fragment); the warp then issues
//     4 k-steps of mma.sync.m16n8k8.tf32 (hi and lo, split by truncation,
//     for dpower and for w, the two accumulators interleaved), skipping
//     each k-step whose 8 lanes (one pixel row of the block) included none
//     of the 8 entries, and stores its [12 x 8] partial sums;
//   - Phi's A fragments are built once per tile into shared memory (not
//     registers): 64 registers a thread at most (__launch_bounds__), so two
//     CTAs of 512 threads (32 warps) share an SM at 32 x 16 tiles;
//   - after the batch the per-warp partials are added in warp order (fixed:
//     deterministic), every thread taking (row, entry) pairs, and one
//     thread per entry writes the closed forms. Every instance slot belongs
//     to one tile, so no atomics are needed;
//   - the 8 replays of a group are unrolled (constant buffer offsets) and
//     take the exp without a branch around it (entry_alpha); CTAs take
//     the tiles heaviest first, as B3f does (`order`).
// Fast mode only: the division in dalpha is __fdividef (one reciprocal and
// a product, 2 ulp) instead of the correctly rounded __fdiv_rn; it moves
// the gradient rows by far less than the 1e-3 of row scale this allows
// (the contract is 5e-3). Alpha and the T test stay B3f's: the replay
// calls the same stream_common.cuh functions.

#include "sections.cuh"
#include "stream_common.cuh"

namespace {

constexpr int kBatch = 64;    // entries staged per batch
constexpr int kGroup = 8;     // entries per MMA block (n = 8)
constexpr int kMomRows = 12;  // Phi rows kept: 6 moments, 3 g hi, 3 g lo

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as a TF32 hi part and the TF32 of its f32 remainder (Phi's g_out,
// once per tile)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// The same split by truncation, for D in the inner loop: the tensor core
// reads only the top 19 bits of a .tf32 operand, so x itself serves as the
// hi part and x minus those bits (exact in f32) as the lo part, which the
// core truncates in turn: hi + lo is within 2^-20 |x| of x (2^-22 with
// cvt.rna, whose emulation costs ~9 instructions a split on sm_90a, this 2).
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & 0xffffe000u)));
}

// d += a . b for one m16n8k8 TF32 block, f32 accumulation (not volatile:
// the compiler may interleave independent products with other work)
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phi row `row` (TF32 bits) at the pixel of thread `tid`, zero for a
// masked lane: 0 one, 1 pxl, 2 pyl, 3 pxl^2, 4 pxl pyl, 5 pyl^2, 6-8 g_out
// hi, 9-11 g_out lo, relative to the tile centre.
__device__ __forceinline__ uint32_t phi(int row, int tid, int tile_w,
                                        int tile_h, bool compact,
                                        const float* g_tile) {
  int x, y;
  if (!gs::thread_pixel(tid, tile_w, tile_h, compact, x, y)) return 0u;
  const float pxl = static_cast<float>(x - tile_w / 2);
  const float pyl = static_cast<float>(y - tile_h / 2);
  if (row >= 6 && row < 12) {
    uint32_t hi, lo;
    split_tf32(g_tile[3 * (y * tile_w + x) + (row - 6) % 3], hi, lo);
    return row < 9 ? hi : lo;
  }
  switch (row) {
    case 0: return to_tf32(1.0f);
    case 1: return to_tf32(pxl);
    case 2: return to_tf32(pyl);
    case 3: return to_tf32(pxl * pxl);
    case 4: return to_tf32(pxl * pyl);
    case 5: return to_tf32(pyl * pyl);
    default: return 0u;
  }
}

// Where lane `lane`'s value of entry j sits in its warp's [8][32] D buffer:
// the lane pairs (8s + t, 8s + t + 4) of a k-step are adjacent, so a
// B fragment (b0, b1) is one 8-byte load, and rows are XOR-swizzled by
// 8 (j & 3) so that neither the lanes' stores nor the fragments' loads
// meet a bank conflict.
__device__ __forceinline__ int d_slot(int j, int lane) {
  const int pair = (lane & ~7) | ((lane & 3) << 1) | ((lane >> 2) & 1);
  return j * 32 + (pair ^ (8 * (j & 3)));
}

// Shared memory of a CTA with `warps` warps, in 4-byte words: the two
// stage buffers, the partials, the warps' D buffers and Phi's fragments.
__host__ __device__ constexpr int smem_words(int warps) {
  return 2 * kBatch * gs::kSlot + warps * kMomRows * kBatch +
         warps * 2 * kGroup * 32 + warps * 4 * 32 * 2 + warps * 4 * 16 * 2;
}

__global__ void __launch_bounds__(1024) stream_bwd_fast_kernel(
    const float* __restrict__ attrs, long long stride,
    const int* __restrict__ seg_start, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, const long long* __restrict__ order,
    const float* __restrict__ out, const float* __restrict__ final_t,
    const float* __restrict__ g_out, const float* __restrict__ g_tfin,
    float* __restrict__ gattrs, int tiles_x, int tile_w, int tile_h) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int n_warps = n_threads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // MMA groupID: row of A and C, column of B
  const int tig = lane & 3;   // MMA thread in group
  float* stage = reinterpret_cast<float*>(smem4);     // [2][kBatch][kSlot]
  float* part = stage + 2 * kBatch * gs::kSlot;       // [warps][12][kBatch]
  float* xd = part + n_warps * kMomRows * kBatch + warp * 2 * kGroup * 32;
  float* xw = xd + kGroup * 32;                       // [8][32] each, swizzled
  uint2* phi_a = reinterpret_cast<uint2*>(
      part + n_warps * kMomRows * kBatch + n_warps * 2 * kGroup * 32);
  uint2* phi_b = phi_a + n_warps * 4 * 32;            // [warps][4][16]
  const int t = static_cast<int>(order[blockIdx.x]);
  GS_SEC_TILE_BEGIN();
  GS_SEC_INIT();

  const long long start = seg_start[t];
  const long long room = stride - start;
  const int count = static_cast<int>(
      max(0LL, min(static_cast<long long>(counts[t]), room)));
  // entries are staged, boxed and written by threads tid, tid + n_threads,
  // ...: a CTA may have fewer threads than kBatch (an 8 x 4 tile has 32)
  for (int i = tid; i < min(kBatch, count); i += n_threads)
    gs::stage_async(stage + i * gs::kSlot, attrs + start + i, stride);
  gs::stage_commit();

  const bool compact = gs::compact_blocks(tile_w, tile_h);
  int lx, ly;
  const bool valid = gs::thread_pixel(tid, tile_w, tile_h, compact, lx, ly);
  const int tile = tile_ids[t];
  const int x0 = (tile % tiles_x) * tile_w;
  const int y0 = (tile / tiles_x) * tile_h;
  const float px = static_cast<float>(x0 + lx);
  const float py = static_cast<float>(y0 + ly);
  const float ox = static_cast<float>(x0 + tile_w / 2);
  const float oy = static_cast<float>(y0 + tile_h / 2);
  const gs::Rect rect = gs::warp_rect(valid, x0 + lx, y0 + ly);

  // Phi's A fragments: k-step s covers the warp's lanes 8s .. 8s+7;
  // a0 = Phi[gid][8s+tig], a2 = Phi[gid][8s+tig+4] in phi_a, a1, a3 the
  // same of row gid+8 in phi_b (lanes 0-15; rows 12-15 are zero), in the
  // PTX m16n8k8 .tf32 fragment layout. Each thread reads back only its own.
  const float* g_tile =
      g_out + 3 * static_cast<long long>(t) * tile_w * tile_h;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int q0 = warp * 32 + 8 * s + tig;
    phi_a[(warp * 4 + s) * 32 + lane] =
        make_uint2(phi(gid, q0, tile_w, tile_h, compact, g_tile),
                   phi(gid, q0 + 4, tile_w, tile_h, compact, g_tile));
    if (lane < 16)
      phi_b[(warp * 4 + s) * 16 + lane] =
          make_uint2(phi(gid + 8, q0, tile_w, tile_h, compact, g_tile),
                     phi(gid + 8, q0 + 4, tile_w, tile_h, compact, g_tile));
  }

  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_dot_out = 0.0f,
        tfin_term = 0.0f;
  if (valid) {
    const long long o =
        static_cast<long long>(t) * tile_w * tile_h + ly * tile_w + lx;
    g_r = g_out[3 * o];
    g_g = g_out[3 * o + 1];
    g_b = g_out[3 * o + 2];
    g_dot_out = __fmaf_rn(g_b, out[3 * o + 2],
                          __fmaf_rn(g_g, out[3 * o + 1],
                                    __fmul_rn(g_r, out[3 * o])));
    tfin_term = __fmul_rn(g_tfin[o], final_t[o]);
  }

  // T of the pixel, 0 once it is done (a masked lane is done from the
  // start): a done pixel then fails every T test and includes nothing, so
  // the replay needs no done flag of its own
  float trans = valid ? 1.0f : 0.0f;
  float prefix = 0.0f;

  for (int base = 0, buf = 0; base < count; base += kBatch, buf ^= 1) {
    const int n = min(kBatch, count - base);
    float* slots = stage + buf * kBatch * gs::kSlot;
    gs::stage_wait();
    for (int i = tid; i < ((n + kGroup - 1) & ~(kGroup - 1));
         i += n_threads) {
      if (i < n)
        gs::stage_box(slots + i * gs::kSlot);
      else  // pad the last group with entries the cull always rejects
        reinterpret_cast<float4*>(slots)[3 * i] =
            make_float4(0.0f, 0.0f, -INFINITY, -INFINITY);
    }
    GS_SEC_MARK(0);
    // Uniform barrier: the batch staged; ends the tile once every pixel is
    // done; and keeps the last batch's readers of the other stage buffer
    // and of the partials ahead of their writers below.
    if (__syncthreads_count(trans > 0.0f) == 0) break;
    GS_SEC_MARK(5);
    for (int i = tid; i < kBatch && base + kBatch + i < count;
         i += n_threads)
      gs::stage_async(stage + ((buf ^ 1) * kBatch + i) * gs::kSlot,
                      attrs + start + base + kBatch + i, stride);
    gs::stage_commit();
    GS_SEC_MARK(0);

    const float4* e4 = reinterpret_cast<const float4*>(slots);
    for (int grp = 0; grp < n; grp += kGroup) {
      bool any_included = false;
      // a warp whose pixels are all done replays nothing
      const bool warp_live = __any_sync(0xffffffffu, trans > 0.0f);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int k = grp + j;  // a sentinel past n is culled
        float dpower = 0.0f, w = 0.0f;
        const float4 geo = e4[3 * k];
        if (warp_live && k < n) {
          GS_SEC_COUNT(0);
          if (trans > 0.0f) GS_SEC_COUNT_LANE(2);
          if (!gs::box_hits(rect, geo)) GS_SEC_COUNT(3);
        }
        if (warp_live && gs::box_hits(rect, geo)) {  // warp-uniform
          gs::Entry e;
          if (gs::entry_alpha(geo.x, geo.y, e4[3 * k + 1].x,
                                   e4[3 * k + 1].y, e4[3 * k + 1].z,
                                   e4[3 * k + 1].w, px, py, e)) {
            if (trans > 0.0f) GS_SEC_COUNT_LANE(4);  // live pixels only
            const float next = gs::transmit<true>(trans, e.alpha);
            if (next < gs::kMinTransmittance) {
              trans = 0.0f;  // done (or was)
            } else {
              GS_SEC_COUNT(1);
              any_included = true;
              const float4 rgb = e4[3 * k + 2];
              w = __fmul_rn(e.alpha, trans);
              const float g_dot_rgb = __fmaf_rn(
                  g_b, rgb.z, __fmaf_rn(g_g, rgb.y, __fmul_rn(g_r, rgb.x)));
              prefix = __fmaf_rn(w, g_dot_rgb, prefix);
              const float one_minus = __fsub_rn(1.0f, e.alpha);
              const float dalpha = __fsub_rn(
                  __fmul_rn(g_dot_rgb, trans),
                  __fdividef(__fadd_rn(__fsub_rn(g_dot_out, prefix),
                                       tfin_term),
                             one_minus));
              if (e.raw < gs::kMaxAlpha)
                dpower = __fmul_rn(__fmul_rn(dalpha, e4[3 * k + 1].w), e.g);
              trans = next;
            }
          }
        }
        xd[d_slot(j, lane)] = dpower;
        xw[d_slot(j, lane)] = w;
      }
      GS_SEC_MARK(1);
      __syncwarp();
      float md[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // Phi . dpower
      float mw[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // Phi . w
      // bit l: lane l included an entry of the group; a lane that did not
      // wrote zeros, so a k-step whose 8 lanes all did not adds nothing
      const unsigned rows = __ballot_sync(0xffffffffu, any_included);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (!((rows >> (8 * s)) & 0xffu)) continue;  // warp-uniform
        const uint2 pa = phi_a[(warp * 4 + s) * 32 + lane];
        const uint2 pb = lane < 16 ? phi_b[(warp * 4 + s) * 16 + lane]
                                   : make_uint2(0u, 0u);
        const uint32_t a[4] = {pa.x, pb.x, pa.y, pb.y};
        // (b0, b1) = (D[8s+tig][gid], D[8s+tig+4][gid]): pixel lanes, entry
        const int q = gid * 32 + ((8 * s + 2 * tig) ^ (8 * (gid & 3)));
        const float2 vd = *reinterpret_cast<const float2*>(xd + q);
        const float2 vw = *reinterpret_cast<const float2*>(xw + q);
        uint32_t dh0, dl0, dh1, dl1, wh0, wl0, wh1, wl1;
        split_trunc(vd.x, dh0, dl0);
        split_trunc(vd.y, dh1, dl1);
        split_trunc(vw.x, wh0, wl0);
        split_trunc(vw.y, wh1, wl1);
        mma_tf32(md, a, dh0, dh1);
        mma_tf32(mw, a, wh0, wh1);
        mma_tf32(md, a, dl0, dl1);
        mma_tf32(mw, a, wl0, wl1);
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
      GS_SEC_MARK(2);
    }
    __syncthreads();
    GS_SEC_MARK(6);
    // sum the warps' partials in warp order, into warp 0's slots
    for (int i = tid; i < kMomRows * n; i += n_threads) {
      const int r = i / n, k = i - r * n;
      const float* src = part + r * kBatch + k;
      float s = 0.0f;
#pragma unroll 4
      for (int wp = 0; wp < n_warps; ++wp)
        s = __fadd_rn(s, src[wp * kMomRows * kBatch]);
      part[r * kBatch + k] = s;
    }
    GS_SEC_MARK(3);
    __syncthreads();
    GS_SEC_MARK(7);
    for (int k = tid; k < n; k += n_threads) {
      const float* m = part + k;
      const float s0 = m[0], s1x = m[kBatch], s1y = m[2 * kBatch];
      const float s2xx = m[3 * kBatch], s2xy = m[4 * kBatch];
      const float s2yy = m[5 * kBatch];
      const float* slot = slots + k * gs::kSlot;
      const float xl = __fsub_rn(slot[0], ox);
      const float yl = __fsub_rn(slot[1], oy);
      const float ca = slot[4], cb = slot[5], cc = slot[6], op = slot[7];
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
    GS_SEC_MARK(4);
  }
  gs::stage_wait();  // no copy outlives the CTA
  GS_SEC_MARK(5);
  GS_SEC_FLUSH();
  GS_SEC_TILE_END();
}

// Threads and dynamic shared memory of a tile's CTA; raises the kernel's
// shared-memory limit to it.
cudaError_t configure(int tile_w, int tile_h, int& threads, size_t& smem) {
  threads = gs::tile_threads(tile_w, tile_h);
  smem = sizeof(float) * smem_words(threads / 32);
  return cudaFuncSetAttribute(stream_bwd_fast_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Launch one CTA per tile on `stream` and return cudaGetLastError().
// The caller has checked shapes, types and devices, zeroed gattrs, and
// passes n_tiles > 0, tile_w * tile_h a multiple of 32 and at most 1024,
// tile_w, tile_h <= 64 (so Phi's moment rows are exact in TF32) and
// `order`, a permutation of [0, n_tiles) (int64): CTA b takes the tile
// order[b].
extern "C" int gs_stream_bwd_fast(const float* attrs, long long stride,
                                  const int* seg_start, const int* counts,
                                  const int* tile_ids, const long long* order,
                                  const float* out,
                                  const float* final_t, const float* g_out,
                                  const float* g_tfin, float* gattrs,
                                  int n_tiles, int tiles_x, int tile_w,
                                  int tile_h, void* stream) {
  int threads;
  size_t smem;
  const cudaError_t err = configure(tile_w, tile_h, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_bwd_fast_kernel<<<n_tiles, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      attrs, stride, seg_start, counts, tile_ids, order, out, final_t, g_out,
      g_tfin, gattrs, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM and registers per thread of the launch at tile_w x
// tile_h, for chip_smoke.py's report (the first argument is unused).
extern "C" int gs_stream_bwd_fast_occupancy(int, int tile_w, int tile_h,
                                            int* ctas_per_sm,
                                            int* registers) {
  int threads;
  size_t smem;
  cudaError_t err = configure(tile_w, tile_h, threads, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, stream_bwd_fast_kernel, threads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, stream_bwd_fast_kernel);
  if (err == cudaSuccess) *registers = attr.numRegs;
  return static_cast<int>(err);
}

GS_SECTIONS_SETTER(gs_stream_bwd_fast_sections)
