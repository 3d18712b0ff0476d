// Binary tensor-core pieces shared by the packed-score kernels (hamming_packed.cu and
// hamming_topk.cu): the mma.sync m16n8k256 .b1 .and.popc product (BMMA in SASS) and the
// 16-byte row loads that feed its B fragments.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// c += popcount(a & b) over a 16 x 256 by 256 x 8 bit tile
__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// words k..k+3 of a row of W words (zero past W or past the last row); VEC: one 16-byte
// load (W % 4 == 0 and a 16-byte aligned base, so the four are in or out together)
template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ row, bool live, int k, int W) {
  if constexpr (VEC) {
    return (live && k < W) ? __ldg(reinterpret_cast<const uint4*>(row + k)) : make_uint4(0, 0, 0, 0);
  } else {
    uint4 v;
    v.x = (live && k < W) ? __ldg(row + k) : 0u;
    v.y = (live && k + 1 < W) ? __ldg(row + k + 1) : 0u;
    v.z = (live && k + 2 < W) ? __ldg(row + k + 2) : 0u;
    v.w = (live && k + 3 < W) ? __ldg(row + k + 3) : 0u;
    return v;
  }
}

__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

}  // namespace
