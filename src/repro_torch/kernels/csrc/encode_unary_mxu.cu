// Binary contraction with a fused affine epilogue on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel encode_unary_mxu_pallas (src/repro/kernels/encode_unary_mxu.py:43,
// body _mxu_kernel :23): for a 0/1 matrix U (B, K) and a 0/1 matrix O stored transposed as
// (D, K), K contiguous,
//     out[b, d] = 2 * sum_k U[b, k] * O[d, k] - h        (int32, exact).
// Two datapaths run through it: the uHD table encode as a thermometer x one-hot product
// (K = H * levels) and the baseline encoder's bind + bundle as a one-hot x [P == L] product
// (K = (levels + 1) * H); the wrappers in ops.py take the operands (core/encoding.py keeps the
// baseline's O built once per codebook set).  Plain version: repro_torch/kernels/ref.py
// (encode_unary_mxu).
//
// What bounds it: 2 * B * K * D int8 operations at the tensor cores' dense int8 rate, or the
// bytes of the operands (B * K + D * K) and of the int32 output.  At a serving batch (B = 64)
// the D * K bytes of O dominate and it is memory-bound; at a training batch (B = 2048) it is
// bound by the tensor cores, and the operands reach shared memory many times over from L2.
//
// What the design does about it:
//   * wgmma.mma_async m64nNk32 .s32.s8.s8, both operands K-major in shared memory (the layout
//     they have in device memory: 8-bit wgmma takes only K-major), the s32 accumulator in
//     registers (exact for any K < 2^31); the TPU kernel's sequential K grid axis is the loop
//     inside the block;
//   * the K sweep runs in 128-byte slices, one 128-byte swizzle row, loaded by TMA
//     (cp.async.bulk.tensor, tensor maps built on the host with cuTensorMapEncodeTiled, found
//     through cudaGetDriverEntryPoint, so nothing links libcuda) into a ring of STAGES
//     shared-memory stages guarded by mbarriers: one producer thread keeps the ring full, the
//     consumer warpgroups wait on a stage's "full" barrier, issue four wgmma (k = 32 each) on
//     it, keep one wgmma group in flight and release the previous stage on its "empty" barrier;
//   * TMA's out-of-bounds zero fill replaces the masking of ragged B, D and K: rows past B or
//     D and bytes past K land as zeros and add nothing; the epilogue writes only inside (B, D);
//   * two tile shapes, chosen on the host from B and D alone:
//       - Wide: 128 x 256 output tiles (two consumer warpgroups of m64n256, 128 accumulators a
//         thread, registers moved to them from the producer with setmaxnreg), a 4-stage ring of
//         48 KB stages.  Used where the tiles fill most of the card (at least 96 tiles, so
//         B >= 384 at D = 8192): the largest tile keeps the operands' L2 -> shared traffic
//         lowest, 175 int8 ops a byte (the narrow tiles' is 64);
//       - Narrow: 64 x 64 tiles (one consumer warpgroup of m64n64), an 8-stage ring of 16 KB,
//         for serving batches: at B = 64 the grid is D / 64 = 128 blocks, each streaming its
//         own rows of O with 64 KB of loads in flight, which is what HBM needs to run at rate;
//   * blockIdx.x walks B tiles, so the blocks resident at once share the same rows of O
//     (read from device memory about once) and the whole of U (from L2);
//   * the 2 * count - h epilogue is applied in registers before the only global write.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver API function is found at run time
#include <cuda_runtime.h>

namespace {

constexpr int KT = 128;  // bytes (int8 elements) of K per stage: one 128-byte swizzle row
constexpr int WK = 32;   // K of one wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// rows [row, row + box rows) x bytes [k, k + 128) of a tensor map's (rows, K) matrix
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle layout: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); the tile starts on a 1024-byte boundary, and a
// step along K inside the swizzle row moves only the start address
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else wgmma_n256(d, da, db);
}

// WG consumer warpgroups (64 output rows each) and one producer warpgroup; BN output columns
template <int WG, int BN, int STAGES>
struct Tile {
  static constexpr int BM = 64 * WG;
  static constexpr int A_BYTES = BM * KT;
  static constexpr int B_BYTES = BN * KT;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = 128 * (WG + 1);
  // the stages, 1024 bytes of slack to align them, and the 2 * STAGES barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "swizzle atoms stay aligned");
  static_assert(BN <= 256 && BM <= 256, "a TMA box has at most 256 rows");
};

template <int WG, int BN, int STAGES>
__global__ void __launch_bounds__(Tile<WG, BN, STAGES>::THREADS, 1)
    encode_unary_mxu_kernel(const __grid_constant__ CUtensorMap map_u,
                            const __grid_constant__ CUtensorMap map_o, int B, int D, int K, int h,
                            int* __restrict__ out) {
  using T = Tile<WG, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sa = smem;                                   // STAGES x (BM, 128) of U
  uint8_t* sb = smem + STAGES * T::A_BYTES;             // STAGES x (BN, 128) of O
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
  const int nk = (K + KT - 1) / KT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {  // producer warpgroup: one thread issues every load
    if constexpr (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], T::STAGE_BYTES);  // out-of-bounds fill counts as loaded
        tma_load(sa + s * T::A_BYTES, &map_u, &full[s], kt * KT, m0);
        tma_load(sb + s * T::B_BYTES, &map_o, &full[s], kt * KT, n0);
      }
    }
    return;
  }
  if constexpr (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a_base = smem_u32(sa) + wg * 64 * KT, b_base = smem_u32(sb);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KT / WK; ++k)
      wgmma<BN>(acc, smem_desc(a_base + s * T::A_BYTES + k * WK),
                smem_desc(b_base + s * T::B_BYTES + k * WK));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the group of slice kt - 1 has finished reading its stage
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator layout of m64nN: register 4j + 2i + c holds row 16 * warp + lane / 4 + 8i,
  // column 8j + 2 * (lane % 4) + c
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool pairs = (D % 2) == 0;  // two columns a store stay 8-byte aligned
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= B || col >= D) continue;
      int* dst = out + static_cast<long long>(row) * D + col;
      const int v0 = 2 * acc[4 * j + 2 * i] - h, v1 = 2 * acc[4 * j + 2 * i + 1] - h;
      if (pairs) {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < D) dst[1] = v1;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, found once through the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// a (rows, K) int8 matrix, K contiguous, read in boxes of box_rows x 128 bytes, 128-byte swizzle,
// zero fill out of bounds
bool make_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KT), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WG, int BN, int STAGES>
int launch(const void* u, const void* o, int B, int D, int K, int h, int* out, cudaStream_t s) {
  using T = Tile<WG, BN, STAGES>;
  CUtensorMap mu, mo;
  if (!make_map(&mu, u, B, K, T::BM) || !make_map(&mo, o, D, K, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = encode_unary_mxu_kernel<WG, BN, STAGES>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((B + T::BM - 1) / T::BM, (D + BN - 1) / BN);
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(mu, mo, B, D, K, h, out);
  return static_cast<int>(cudaGetLastError());
}

using Wide = Tile<2, 256, 4>;
constexpr int WIDE_MIN_TILES = 96;  // about three quarters of the 132 SMs

}  // namespace

extern "C" {

// 1 where the wide tiles fill most of the card (one a streaming multiprocessor), else 0:
// the narrow tiles then give more blocks.  A function of the shape alone.
int uhd_encode_unary_mxu_wide(int B, int D) {
  const long long tiles =
      static_cast<long long>((B + Wide::BM - 1) / Wide::BM) * ((D + 255) / 256);
  return tiles >= WIDE_MIN_TILES;
}

// u (B, K) int8 0/1, o (D, K) int8 0/1 (K contiguous in both, K a multiple of 16, both bases
// 16-byte aligned), out (B, D) int32: out[b, d] = 2 * sum_k u[b, k] * o[d, k] - h.
// Returns the first CUDA error, or 0.
int uhd_encode_unary_mxu(const void* u, const void* o, int B, int D, int K, int h, int* out,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 16 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (uhd_encode_unary_mxu_wide(B, D)) return launch<2, 256, 4>(u, o, B, D, K, h, out, s);
  return launch<1, 64, 8>(u, o, B, D, K, h, out, s);
}

}  // extern "C"
