// Packed +-1 similarity scores for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamming_packed_pallas (src/repro/kernels/hamming_packed.py:34,
// body _hamming_kernel :22): for B packed queries and C packed rows of W 32-bit words,
// out[b, c] = d - 2 * sum_w popcount(q[b, w] ^ c[c, w]), the +-1 dot product of the two
// sign vectors of length d.  It is the per-shard partial score of D-sharded serving
// (ShardedExecution), where d is the shard's d_local.  Plain version:
// repro_torch/kernels/ref.py (hamming_packed).
//
// What bounds it: XOR + popcount + add over B*C*W word pairs on the CUDA cores (popcount
// issues at a quarter of the int32 rate).  The bytes are small: (B + C) * W words in,
// B * C scores out.  At a serving batch against C = 10 classes the whole call is a few
// microseconds of work, so it is launch-bound there.
//
// What the design does about it:
//   * each block owns a TB x TC tile of (query, row) outputs, one output a thread; the
//     TPU kernel's whole-W block becomes a loop over W-chunks of WK words: the block
//     stages the tile's q words and c words of the chunk in shared memory (coalesced
//     loads along W), and each thread accumulates __popc over the chunk from 16-byte
//     shared-memory reads, so every global word is read once per tile and the shared
//     reads (two 16-byte loads per four popcounts) stay below the popcount rate;
//   * a warp covers 16 rows of 2 queries: its row reads fall in distinct banks (the row
//     pitch is WK + 4 words) and its query reads are broadcasts; its 16 stores of one
//     query's scores are contiguous;
//   * ragged B, C and W are masked in the kernel: rows and queries past the edge stage
//     zero words, and so does the chunk's tail past W, so they add nothing (pad bits are
//     zero in both operands and cancel in the XOR).  No padding copy, unlike the JAX
//     wrapper's jnp.pad; nothing past (B, C) is written.
//   * the host loops over row chunks so that gridDim.y stays within 65535.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 16;             // queries per block tile
constexpr int TC = 16;             // rows per block tile
constexpr int TPB = TB * TC;       // threads per block, one output each
constexpr int WK = 64;             // words per staged chunk
constexpr int PITCH = WK + 4;      // shared row pitch in words (16-byte aligned, conflict-free)
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(TPB) hamming_packed_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows, int B, int C, int W,
    int d, int* __restrict__ out, long long out_stride) {
  __shared__ alignas(16) uint32_t qs[TB][PITCH];
  __shared__ alignas(16) uint32_t cs[TC][PITCH];
  const int tr = threadIdx.x % TC;  // this thread's row within the tile
  const int tq = threadIdx.x / TC;  // this thread's query within the tile
  const int b0 = blockIdx.x * TB;
  const int c0 = blockIdx.y * TC;
  unsigned acc = 0;
  for (int k0 = 0; k0 < W; k0 += WK) {
    const int kn = min(WK, W - k0);
    for (int i = threadIdx.x; i < TB * WK; i += TPB) {
      const int r = i / WK, k = i % WK;
      const int b = b0 + r;
      qs[r][k] = (b < B && k < kn) ? q[static_cast<long long>(b) * W + k0 + k] : 0u;
    }
    for (int i = threadIdx.x; i < TC * WK; i += TPB) {
      const int r = i / WK, k = i % WK;
      const int c = c0 + r;
      cs[r][k] = (c < C && k < kn) ? rows[static_cast<long long>(c) * W + k0 + k] : 0u;
    }
    __syncthreads();
    const int kr = (kn + 3) & ~3;  // staged zeros past kn cancel
    for (int k = 0; k < kr; k += 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(&qs[tq][k]);
      const uint4 v = *reinterpret_cast<const uint4*>(&cs[tr][k]);
      acc += __popc(a.x ^ v.x) + __popc(a.y ^ v.y) + __popc(a.z ^ v.z) + __popc(a.w ^ v.w);
    }
    __syncthreads();
  }
  const int b = b0 + tq, c = c0 + tr;
  if (b < B && c < C) out[static_cast<long long>(b) * out_stride + c] = d - 2 * static_cast<int>(acc);
}

}  // namespace

extern "C" {

// q (B, W) and rows (C, W) packed words (int32 bit patterns), out (B, C) int32:
// out[b, c] = d - 2 * popcount(q[b] ^ rows[c]).  Returns the first CUDA error, or 0.
int uhd_hamming_packed(const int* q, const int* rows, int B, int C, int W, int d, int* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const int gx = (B + TB - 1) / TB;
  const int rows_per_launch = MAX_GRID_Y * TC;
  for (int c0 = 0; c0 < C; c0 += rows_per_launch) {
    const int cn = C - c0 < rows_per_launch ? C - c0 : rows_per_launch;
    hamming_packed_kernel<<<dim3(gx, (cn + TC - 1) / TC), TPB, 0, s>>>(
        reinterpret_cast<const uint32_t*>(q),
        reinterpret_cast<const uint32_t*>(rows) + static_cast<long long>(c0) * W, B, cn, W,
        d, out + c0, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
