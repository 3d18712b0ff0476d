// Packed +-1 similarity scores for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamming_packed_pallas (src/repro/kernels/hamming_packed.py:34,
// body _hamming_kernel :22): for B packed queries and C packed rows of W 32-bit words,
// out[b, c] = d - 2 * sum_w popcount(q[b, w] ^ c[c, w]), the +-1 dot product of the two
// sign vectors of length d.  It is the per-shard partial score of D-sharded serving
// (ShardedExecution), where d is the shard's d_local.  Plain version:
// repro_torch/kernels/ref.py (hamming_packed).
//
// What bounds it.  The scores are an exact binary matrix product: with the AND form
// popcount(q ^ c) = popcount(q) + popcount(c) - 2 * popcount(q & c), and popcount(q & c) is
// the dot product of the 0/1 bits, so the least time is that of 2 * B * C * d int8
// operations on the tensor cores, or of the bytes ((B + C) * W words in, B * C scores out),
// whichever is larger.  At a serving batch against C = 10 classes the whole call is a few
// microseconds of work: it is latency-bound there.
//
// What the design does about it.  The wrapper picks a path from C alone (ops.packed_path):
//   * warp (C <= WARP_MAX_ROWS; the class store): one warp a query, lanes along a row's
//     16-byte chunks (words where W % 4 != 0 or a base is unaligned).  Every row's loads
//     are issued with no barrier and no branch (4, 8 or 16 rows a pass, by C; loads past
//     the edge are clamped to a chunk that exists and masked out of the sums), so all of a
//     step's loads are in flight at once; one __reduce_add_sync a row; lane r writes score
//     r.  One launch, no shared memory;
//   * tensor (C > WARP_MAX_ROWS; the store search): mma.sync m16n8k256 .b1 .and.popc on
//     the packed words as they are (BMMA in SASS).  A block stages 64 queries (four m16
//     tiles) in shared memory, chunk by chunk along W, and each of its 8 warps streams 32
//     rows (four n8 tiles) from device memory, 16 bytes a lane, straight into the B
//     fragments: every row word is read once and feeds 64 queries.  The K order inside a
//     512-bit step is permuted the same way in both operands (lane (g, t) holds words
//     4t..4t+3 of a 16-word step), which leaves the dot product as it is.  The epilogue
//     adds each query's and each row's popcount (summed as they are staged and loaded).
//     int8 wgmma on the bits expanded to bytes in shared memory was measured against it
//     and was slower (the expansion's shared-memory traffic; PERF.md).
//   Ragged B, C and W are masked in both paths: rows and queries past the edge load zero
//   words, and so do words past W, so they add nothing (pad bits are zero in both operands
//   and cancel in the XOR and in the AND).  No padding copy, unlike the JAX wrapper's
//   jnp.pad; nothing past (B, C) is written.  The host loops over row chunks of
//   ROWS_PER_LAUNCH, one launch each.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "bmma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS_PER_LAUNCH = 65535 * 16;  // 1,048,560 rows a launch (4096 row tiles)

enum Path { PATH_WARP = 0, PATH_TENSOR = 1 };

// ---------------------------------------------------------------------------
// warp path: one warp a query, C <= WARP_MAX_ROWS
// ---------------------------------------------------------------------------

constexpr int WARP_MAX_ROWS = 64;  // two scores a lane
constexpr int WARP_QUERIES = 4;    // queries (warps) a block

__device__ __forceinline__ unsigned popc_xor(uint32_t a, uint32_t b) { return __popc(a ^ b); }
__device__ __forceinline__ unsigned popc_xor(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) + __popc(a.w ^ b.w);
}

// One warp a query, lanes along a row's units (16-byte chunks with VEC, else words), PASS
// rows a pass.  Every load of a step is issued with no branch: units past W and rows past
// C read one that exists (the last) and are masked out of the sums, so all are in flight
// at once.  Lane r % 32 keeps row r's score.
template <bool VEC, int PASS>
__global__ void __launch_bounds__(32 * WARP_QUERIES) warp_packed_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows, int B, int C, int W,
    int d, int* __restrict__ out, long long out_stride) {
  using Unit = typename std::conditional<VEC, uint4, uint32_t>::type;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARP_QUERIES + static_cast<int>(threadIdx.x) / 32;
  if (b >= B) return;  // uniform over the warp
  const int n = VEC ? W / 4 : W;  // units a row
  const Unit* qp = reinterpret_cast<const Unit*>(q + static_cast<long long>(b) * W);
  const Unit* rw = reinterpret_cast<const Unit*>(rows);
  int s0 = 0, s1 = 0;  // the scores of rows lane and lane + 32
  for (int r0 = 0; r0 < C; r0 += PASS) {
    unsigned acc[PASS];
#pragma unroll
    for (int i = 0; i < PASS; ++i) acc[i] = 0u;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < n;
      const int jj = ok ? j : n - 1;
      const Unit qv = __ldg(qp + jj);
      Unit v[PASS];
#pragma unroll
      for (int i = 0; i < PASS; ++i)
        v[i] = __ldg(rw + static_cast<long long>(min(r0 + i, C - 1)) * n + jj);
#pragma unroll
      for (int i = 0; i < PASS; ++i) acc[i] += ok ? popc_xor(qv, v[i]) : 0u;
    }
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      const int r = r0 + i;
      if (r >= C) break;  // uniform over the warp
      const int score = d - 2 * static_cast<int>(__reduce_add_sync(FULL, acc[i]));
      if (lane == (r & 31)) {
        if (r < 32) s0 = score;
        else s1 = score;
      }
    }
  }
  int* op = out + static_cast<long long>(b) * out_stride;
  if (lane < C) op[lane] = s0;
  if (lane + 32 < C) op[lane + 32] = s1;
}

// out[b, c] for the two adjacent rows c, c + 1 (c even); int2 stores where they stay aligned
__device__ __forceinline__ void put2(int* __restrict__ out, long long out_stride, int b, int c,
                                     int B, int C, int v0, int v1) {
  if (b >= B || c >= C) return;
  int* dst = out + static_cast<long long>(b) * out_stride + c;
  if (c + 1 < C && (out_stride % 2) == 0 && (reinterpret_cast<uintptr_t>(out) % 8) == 0) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
  } else {
    dst[0] = v0;
    if (c + 1 < C) dst[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// tensor path: mma.sync m16n8k256 .b1 .and.popc on the packed words
// ---------------------------------------------------------------------------

constexpr int TQ = 64;                      // queries a block: four m16 tiles
constexpr int T_MT = TQ / 16;
constexpr int T_WARPS = 8;
constexpr int T_NT = 4;                     // n8 tiles a warp: 32 rows
constexpr int T_ROWS = T_WARPS * T_NT * 8;  // 256 rows a block
constexpr int T_KC = 128;                   // query words staged a chunk
constexpr int T_PITCH = T_KC + 16;          // = 16 mod 32: a quarter-warp's 16-byte reads hit 32 banks

template <bool VEC>
__global__ void __launch_bounds__(T_WARPS * 32) tensor_packed_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows, int B, int C, int W,
    int d, int* __restrict__ out, long long out_stride) {
  __shared__ alignas(16) uint32_t qs[TQ][T_PITCH];
  __shared__ int qpop[TQ];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // the fragments' group and thread in group
  const int b0 = blockIdx.x * TQ;
  const int n0 = blockIdx.y * T_ROWS + warp * (T_NT * 8);
  if (threadIdx.x < TQ) qpop[threadIdx.x] = 0;

  int acc[T_MT][T_NT][4];
#pragma unroll
  for (int m = 0; m < T_MT; ++m)
#pragma unroll
    for (int n = 0; n < T_NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0;
  unsigned cpop[T_NT] = {};  // this lane's share of its rows' popcounts
  const uint32_t* rp[T_NT];
  bool live[T_NT];
#pragma unroll
  for (int n = 0; n < T_NT; ++n) {
    const int r = n0 + n * 8 + g;
    live[n] = r < C;
    rp[n] = rows + static_cast<long long>(live[n] ? r : 0) * W;
  }

  for (int kc = 0; kc < W; kc += T_KC) {
    const int kn = min(T_KC, W - kc);
    __syncthreads();  // the previous chunk's reads are done (and qpop is zeroed)
    // warp w stages queries w, w + 8, ...; lanes along the chunk; each query's popcount
    // is summed as it is staged
    for (int r = warp; r < TQ; r += T_WARPS) {
      const bool qlive = b0 + r < B;
      const uint32_t* src = q + static_cast<long long>(qlive ? b0 + r : 0) * W + kc;
      unsigned pc = 0;
#pragma unroll
      for (int k = lane; k < T_KC; k += 32) {
        const uint32_t v = (qlive && k < kn) ? __ldg(src + k) : 0u;
        qs[r][k] = v;
        pc += __popc(v);
      }
      pc = __reduce_add_sync(FULL, pc);
      if (lane == 0) qpop[r] += static_cast<int>(pc);
    }
    __syncthreads();
    for (int k0 = 0; k0 < kn; k0 += 16) {  // a 512-bit step: two k256 MMAs
      uint4 bv[T_NT];
#pragma unroll
      for (int n = 0; n < T_NT; ++n) {
        bv[n] = load4<VEC>(rp[n], live[n], kc + k0 + 4 * t, W);
        cpop[n] += popc4(bv[n]);
      }
#pragma unroll
      for (int m = 0; m < T_MT; ++m) {
        const uint4 lo = *reinterpret_cast<const uint4*>(&qs[m * 16 + g][k0 + 4 * t]);
        const uint4 hi = *reinterpret_cast<const uint4*>(&qs[m * 16 + g + 8][k0 + 4 * t]);
#pragma unroll
        for (int n = 0; n < T_NT; ++n) {
          mma_b1(acc[m][n], lo.x, hi.x, lo.y, hi.y, bv[n].x, bv[n].y);
          mma_b1(acc[m][n], lo.z, hi.z, lo.w, hi.w, bv[n].z, bv[n].w);
        }
      }
    }
  }
  __syncthreads();  // qpop is complete even where W == 0

  // a row's popcount: the sum over the four lanes of its group
#pragma unroll
  for (int n = 0; n < T_NT; ++n) {
    cpop[n] += __shfl_xor_sync(FULL, cpop[n], 1);
    cpop[n] += __shfl_xor_sync(FULL, cpop[n], 2);
  }
  // accumulator i of tile (m, n): query m * 16 + g + 8 * (i / 2), row n * 8 + 2 * t + i % 2
#pragma unroll
  for (int n = 0; n < T_NT; ++n) {
    const int pc0 = static_cast<int>(__shfl_sync(FULL, cpop[n], (2 * t) * 4));
    const int pc1 = static_cast<int>(__shfl_sync(FULL, cpop[n], (2 * t + 1) * 4));
    const int c = n0 + n * 8 + 2 * t;
#pragma unroll
    for (int m = 0; m < T_MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ql = m * 16 + g + 8 * h;
        const int base = d - 2 * qpop[ql];
        put2(out, out_stride, b0 + ql, c, B, C, base - 2 * pc0 + 4 * acc[m][n][2 * h],
             base - 2 * pc1 + 4 * acc[m][n][2 * h + 1]);
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(int path, const uint32_t* q, const uint32_t* rows, int B, int C, int W, int d,
                   int* out, long long out_stride, cudaStream_t s) {
  if (path == PATH_WARP) {
    // PASS: the fewest rows that cover the store in one pass (at most 16)
    const dim3 grid((B + WARP_QUERIES - 1) / WARP_QUERIES), block(32 * WARP_QUERIES);
    if (C <= 4) warp_packed_kernel<VEC, 4><<<grid, block, 0, s>>>(q, rows, B, C, W, d, out, out_stride);
    else if (C <= 8) warp_packed_kernel<VEC, 8><<<grid, block, 0, s>>>(q, rows, B, C, W, d, out, out_stride);
    else warp_packed_kernel<VEC, 16><<<grid, block, 0, s>>>(q, rows, B, C, W, d, out, out_stride);
  } else {
    tensor_packed_kernel<VEC><<<dim3((B + TQ - 1) / TQ, (C + T_ROWS - 1) / T_ROWS),
                                T_WARPS * 32, 0, s>>>(q, rows, B, C, W, d, out, out_stride);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, W) and rows (C, W) packed words (int32 bit patterns), out (B, C) int32:
// out[b, c] = d - 2 * popcount(q[b] ^ rows[c]).  path: 0 warp (C <= WARP_MAX_ROWS), 1 tensor
// (ops.packed_path picks it from C).  Returns the first CUDA error, or 0.
int uhd_hamming_packed(const int* q, const int* rows, int B, int C, int W, int d, int path,
                       int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((path == PATH_WARP && C > WARP_MAX_ROWS) || path < PATH_WARP || path > PATH_TENSOR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rows);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;  // 16-byte loads
  for (int c0 = 0; c0 < C; c0 += ROWS_PER_LAUNCH) {
    const int cn = C - c0 < ROWS_PER_LAUNCH ? C - c0 : ROWS_PER_LAUNCH;
    const uint32_t* rp = rw + static_cast<long long>(c0) * W;
    const cudaError_t err = vec ? launch<true>(path, qw, rp, B, cn, W, d, out + c0, C, s)
                                : launch<false>(path, qw, rp, B, cn, W, d, out + c0, C, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
