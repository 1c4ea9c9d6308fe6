// Section clocks for a kernel's time split, compiled in only with
// -DGS_SECTION_CLOCKS (profile_kernels.py builds such a library beside the
// real one); without it every macro below is empty and the kernels carry
// no counter.
//
// Each thread keeps its own clock64() mark; GS_SEC_MARK(s) adds the cycles
// since the last mark to section s, GS_SEC_COUNT(c) adds one to event count
// c from the lowest active lane of the warp (a per-warp event),
// GS_SEC_COUNT_LANE(c) one from every lane that runs it, and
// GS_SEC_FLUSH() adds lane 0's cycles and the warp's counts to the buffer
// set by the file's GS_SECTIONS_SETTER, at the end of the kernel, where the
// warp is converged. GS_SEC_TILE_BEGIN / END store each CTA's start and end
// %globaltimer (ns) at tiles[2 t], tiles[2 t + 1].

#pragma once

#ifdef GS_SECTION_CLOCKS

#include <cuda_runtime.h>

namespace gs_sections {
constexpr int kSections = 8;  // buffer: [0, 8) cycles, [8, 16) counts
namespace {  // one pair per source file: the host shadows must not clash
__device__ unsigned long long* g_buf = nullptr;
__device__ unsigned long long* g_tiles = nullptr;
}  // namespace

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace gs_sections

#define GS_SEC_INIT()                                              \
  long long gs_sec_t = clock64();                                  \
  long long gs_sec_cyc[gs_sections::kSections] = {};               \
  unsigned long long gs_sec_cnt[gs_sections::kSections] = {}
#define GS_SEC_MARK(s)                 \
  do {                                 \
    const long long gs_now = clock64(); \
    gs_sec_cyc[s] += gs_now - gs_sec_t; \
    gs_sec_t = gs_now;                 \
  } while (0)
#define GS_SEC_COUNT(c)                                                \
  do {                                                                 \
    if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) ++gs_sec_cnt[c]; \
  } while (0)
#define GS_SEC_COUNT_LANE(c) ++gs_sec_cnt[c]
#define GS_SEC_FLUSH()                                                   \
  do {                                                                   \
    for (int gs_i = 0; gs_i < gs_sections::kSections; ++gs_i) {         \
      const unsigned long long gs_c =                                    \
          __reduce_add_sync(0xffffffffu,                                 \
                            static_cast<unsigned>(gs_sec_cnt[gs_i]));    \
      if ((threadIdx.x & 31) == 0) {                                     \
        atomicAdd(gs_sections::g_buf + gs_i,                             \
                  static_cast<unsigned long long>(gs_sec_cyc[gs_i]));    \
        atomicAdd(gs_sections::g_buf + gs_sections::kSections + gs_i,    \
                  gs_c);                                                 \
      }                                                                  \
    }                                                                    \
  } while (0)
#define GS_SEC_TILE_BEGIN()                                              \
  do {                                                                   \
    if (threadIdx.x == 0)                                                \
      gs_sections::g_tiles[2 * blockIdx.x] = gs_sections::global_ns();   \
  } while (0)
#define GS_SEC_TILE_END()                                                \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0)                                                \
      gs_sections::g_tiles[2 * blockIdx.x + 1] = gs_sections::global_ns(); \
  } while (0)
// extern "C" int name(buf, tiles): points this file's kernels at a
// [16] u64 buffer and a [2 T] u64 buffer (device memory).
#define GS_SECTIONS_SETTER(name)                                          \
  extern "C" int name(void* buf, void* tiles) {                          \
    cudaError_t e = cudaMemcpyToSymbol(gs_sections::g_buf, &buf,          \
                                       sizeof(buf));                      \
    if (e == cudaSuccess)                                                 \
      e = cudaMemcpyToSymbol(gs_sections::g_tiles, &tiles, sizeof(tiles)); \
    return static_cast<int>(e);                                           \
  }

#else

#define GS_SEC_INIT() \
  do {                \
  } while (0)
#define GS_SEC_MARK(s) \
  do {                 \
  } while (0)
#define GS_SEC_COUNT(c) \
  do {                  \
  } while (0)
#define GS_SEC_COUNT_LANE(c) \
  do {                       \
  } while (0)
#define GS_SEC_FLUSH() \
  do {                 \
  } while (0)
#define GS_SEC_TILE_BEGIN() \
  do {                      \
  } while (0)
#define GS_SEC_TILE_END() \
  do {                    \
  } while (0)
#define GS_SECTIONS_SETTER(name)

#endif
