// Binary contraction with a fused affine epilogue on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel encode_unary_mxu_pallas (src/repro/kernels/encode_unary_mxu.py:43,
// body _mxu_kernel :23): for a 0/1 matrix U (B, K) and a 0/1 matrix O stored transposed as
// (D, K), K contiguous,
//     out[b, d] = 2 * sum_k U[b, k] * O[d, k] - h        (int32, exact).
// Two datapaths run through it: the uHD table encode as a thermometer x one-hot product
// (K = H * levels) and the baseline encoder's bind + bundle as a one-hot x [P == L] product
// (K = (levels + 1) * H); the wrappers in ops.py build the operands.  Plain version:
// repro_torch/kernels/ref.py (encode_unary_mxu).
//
// What bounds it: 2 * B * K * D int8 operations at the tensor cores' dense int8 rate, or the
// bytes of the operands (B * K + D * K) and of the int32 output.  At a serving batch (B = 64)
// the D * K bytes of O dominate and it is memory-bound; at a training batch (B = 2048) it is
// bound by the tensor cores.
//
// What the design does about it:
//   * the TPU kernel's bf16 MXU dot with an f32 accumulator becomes mma.sync m16n8k32 on
//     s8 operands with an s32 accumulator (exact for any K < 2^31); both operands are
//     K-major, which is the "row.col" form the instruction loads directly, so O is kept
//     (D, K);
//   * a block owns a 64 x 64 output tile (4 warps, 32 x 32 each, 8 mma a k-step); the K
//     sweep runs in 64-byte slices staged in shared memory by a 4-deep cp.async ring, so
//     three slices are in flight while one is multiplied; the shared row pitch is 80 bytes,
//     so a warp's fragment loads fall in distinct banks;
//   * the TPU kernel's sequential K grid axis becomes the loop inside the block, and its
//     epilogue (2 * count - h at the last K step, the "concurrent affine epilogue") is
//     applied in registers before the only global write;
//   * ragged B and D are masked in the kernel (rows past the edge stage zeros and nothing
//     past (B, D) is written), so there is no pad copy, unlike the JAX wrapper's jnp.pad;
//     K must be a multiple of 16 (16-byte copies): the wrappers pad K with zero columns,
//     which add nothing.
// Simple first: no wgmma, TMA or warp specialisation yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // output rows (batch) per block
constexpr int BN = 64;          // output columns (D) per block
constexpr int KT = 64;          // bytes of K per staged slice
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int PITCH = KT + 16;  // shared row pitch in bytes (16-byte aligned, conflict-free)
constexpr int THREADS = 128;    // 4 warps, 2 x 2 over the tile
constexpr int CHUNKS = KT / 16; // 16-byte copies per row and slice
static_assert(BM == BN, "stage() copies 64-row tiles of either operand");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + 64) x bytes [k0, k0 + KT) of a (rows, K) int8 matrix; rows past
// `rows` and bytes past K stage zeros.
__device__ __forceinline__ void stage(int8_t (*dst)[PITCH], const int8_t* __restrict__ src,
                                      int r0, int rows, int k0, int K) {
  for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 16;
    const int gr = r0 + r, gk = k0 + c;
    if (gr < rows && gk < K) {
      cp_async16(&dst[r][c], src + static_cast<long long>(gr) * K + gk);
    } else {
      *reinterpret_cast<uint4*>(&dst[r][c]) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__global__ void __launch_bounds__(THREADS) encode_unary_mxu_kernel(
    const int8_t* __restrict__ u, const int8_t* __restrict__ o, int B, int D, int K, int h,
    int* __restrict__ out) {
  __shared__ alignas(16) int8_t as[STAGES][BM][PITCH];
  __shared__ alignas(16) int8_t bs[STAGES][BN][PITCH];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane >> 2, t = lane & 3;  // mma groupID and thread-in-group
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + KT - 1) / KT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      stage(as[s], u, m0, B, s * KT, K);
      stage(bs[s], o, n0, D, s * KT, K);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt has landed; slice kt - 1's buffer is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      stage(as[nxt % STAGES], u, m0, B, nxt * KT, K);
      stage(bs[nxt % STAGES], o, n0, D, nxt * KT, K);
    }
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = lds32(&as[st][r][kk + t * 4]);
        a[i][1] = lds32(&as[st][r + 8][kk + t * 4]);
        a[i][2] = lds32(&as[st][r][kk + 16 + t * 4]);
        a[i][3] = lds32(&as[st][r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        b[j][0] = lds32(&bs[st][c][kk + t * 4]);
        b[j][1] = lds32(&bs[st][c][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at (row g, columns 2t, 2t + 1), c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + t * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + g + half * 8;
        if (row >= B) continue;
        int* dst = out + static_cast<long long>(row) * D + col;
        if (col < D) dst[0] = 2 * acc[i][j][half * 2] - h;
        if (col + 1 < D) dst[1] = 2 * acc[i][j][half * 2 + 1] - h;
      }
    }
  }
}

}  // namespace

extern "C" {

// u (B, K) int8 0/1, o (D, K) int8 0/1 (K contiguous in both, K a multiple of 16, rows
// 16-byte aligned), out (B, D) int32: out[b, d] = 2 * sum_k u[b, k] * o[d, k] - h.
// Returns the first CUDA error, or 0.
int uhd_encode_unary_mxu(const void* u, const void* o, int B, int D, int K, int h, int* out,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + BN - 1) / BN, (B + BM - 1) / BM);
  encode_unary_mxu_kernel<<<grid, THREADS, 0, s>>>(static_cast<const int8_t*>(u),
                                                  static_cast<const int8_t*>(o), B, D, K, h,
                                                  out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
