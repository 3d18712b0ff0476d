// Class bundling with the fused sign epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bundle_binarize_pallas (src/repro/kernels/bundle_binarize.py:45,
// body _bundle_kernel :23): for B hypervectors hv (B, D) int32 with labels (B,),
//     sums[c, d] = sum over rows b with label c of hv[b, d]          (C, D) int32,
// written as the sums, or as the signs (+1 where sums >= 0, else -1) in int8 when `binarize`
// is set.  Labels outside [0, C) are dropped, as the TPU kernel's one-hot drops them.  It is
// the training step of encoders without a fused fit kernel (the baseline encoder: encode,
// then this).  Plain version: repro_torch/kernels/ref.py (bundle_binarize).
//
// What bounds it: the B * D * 4 bytes of hv, read once (the labels and the C * D output are
// small next to them); the adds are few.  So it is memory-bound, and launch-bound at small B.
//
// What the design does about it:
//   * it computes what the TPU kernel computes, not how: the TPU kernel multiplies a (C, B)
//     one-hot by hv on the MXU in float32, which is exact only while the sums stay below
//     2^24; here it is a segment sum in int32, exact at any B (until int32 itself overflows);
//   * a block owns a 32-column D-tile (256 blocks at D = 8192) and sweeps B with its 8 warps,
//     each warp reading whole 128-byte row segments (one coalesced transaction a row, four
//     rows in flight a warp) and adding them into a shared int32 accumulator acc[C_tile][32]
//     with shared-memory atomics, which are exact in any order;
//   * rows whose label is outside the block's classes are not read at all;
//   * the epilogue writes the sums, or their signs (the fused binarization, ties to +1),
//     straight from shared memory: the int32 sums never go to device memory when binarized;
//   * C is tiled over gridDim.z in tiles of 256 classes (32 KB of accumulator);
//   * ragged D is masked (lanes past D idle); there is no padding copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TD = 32;           // D columns per block, one per lane
constexpr int WARPS = 8;         // row groups per block
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;        // rows a warp has in flight
constexpr int C_TILE = 256;      // classes per block (256 * 32 * 4 bytes = 32 KB of shared memory)
constexpr int MAX_GRID_Z = 65535;

template <typename Out>
__global__ void __launch_bounds__(THREADS) bundle_binarize_kernel(
    const int* __restrict__ hv, const int* __restrict__ labels, int B, int C, int D,
    Out* __restrict__ out) {
  extern __shared__ int acc[];  // [ct][TD]
  const int d0 = blockIdx.x * TD;
  const int c0 = blockIdx.z * C_TILE;
  const int ct = min(C_TILE, C - c0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = d0 + lane;
  const bool live = col < D;
  for (int i = threadIdx.x; i < ct * TD; i += THREADS) acc[i] = 0;
  __syncthreads();

  for (int r0 = warp * UNROLL; r0 < B; r0 += WARPS * UNROLL) {
    int cls[UNROLL], val[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u;
      const int lab = r < B ? labels[r] : -1;
      const bool take = live && lab >= c0 && lab < c0 + ct;
      cls[u] = take ? lab - c0 : -1;
      val[u] = take ? hv[static_cast<long long>(r) * D + col] : 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (cls[u] >= 0) atomicAdd(&acc[cls[u] * TD + lane], val[u]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ct * TD; i += THREADS) {
    const int c = i / TD, j = i % TD;
    if (d0 + j >= D) continue;
    const int s = acc[i];
    Out* dst = out + static_cast<long long>(c0 + c) * D + d0 + j;
    if constexpr (sizeof(Out) == 1) {
      *dst = static_cast<Out>(s >= 0 ? 1 : -1);
    } else {
      *dst = static_cast<Out>(s);
    }
  }
}

}  // namespace

extern "C" {

// hv (B, D) int32, labels (B,) int32, out (C, D): int8 signs (+1 where the class sum is
// >= 0, else -1) when binarize != 0, else int32 sums.  Labels outside [0, C) are dropped.
// Returns the first CUDA error, or 0.
int uhd_bundle_binarize(const int* hv, const int* labels, int B, int C, int D, int binarize,
                        void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const int gz = (C + C_TILE - 1) / C_TILE;
  if (gz > MAX_GRID_Z) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + TD - 1) / TD, 1, gz);
  const size_t smem = static_cast<size_t>(C < C_TILE ? C : C_TILE) * TD * sizeof(int);
  if (binarize) {
    bundle_binarize_kernel<int8_t><<<grid, THREADS, smem, s>>>(hv, labels, B, C, D,
                                                               static_cast<int8_t*>(out));
  } else {
    bundle_binarize_kernel<int><<<grid, THREADS, smem, s>>>(hv, labels, B, C, D,
                                                            static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
