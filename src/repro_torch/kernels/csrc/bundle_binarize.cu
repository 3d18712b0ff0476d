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
// HBM reaches its rate only with enough bytes in flight: about 32 KB an SM at the latency of
// a load from device memory.
//
// What the design does about it:
//   * it computes what the TPU kernel computes, not how: the TPU kernel multiplies a (C, B)
//     one-hot by hv on the MXU in float32, which is exact only while the sums stay below
//     2^24; here it is a segment sum in int32, exact at any B while the sums fit in int32
//     (the adds wrap, so a partial sum may pass 2^31 on the way);
//   * a block owns a 128-column D-tile, four columns a lane: each lane reads 16 bytes of a
//     row (one 512-byte segment a warp), and each of the 8 warps keeps 8 rows in flight
//     (rows interleaved over the warps), 32 KB a block, four blocks an SM (registers capped
//     at 64 a thread);
//   * B is split over the blocks of a thread-block cluster (up to 8, a portable size), each
//     on a contiguous range of rows: the largest cluster whose grid runs in one wave, as
//     cudaOccupancyMaxActiveClusters counts it (D = 8192: 64 tiles x 4; D = 2048: 16 x 8);
//   * each block adds its rows into a shared int32 accumulator acc[C_tile][128] with
//     shared-memory atomics, which are exact in any order (column 4 * lane + v sits at
//     v * 32 + lane: a warp's atomics fall in 32 distinct banks);
//   * after a cluster barrier each block sums its share of the tile over the cluster's shared
//     memory (distributed shared memory) and writes the sums, or their signs (the fused
//     binarization, ties to +1): the int32 sums never go to device memory when binarized,
//     and a call is one launch;
//   * C is tiled over gridDim.z in tiles of 256 classes (128 KB of dynamic shared memory);
//     with one C tile every row is read at once, with more a block reads only the rows of
//     its classes;
//   * ragged D is masked: with D % 4 == 0 and a 16-byte aligned base a lane's four columns
//     are in or out together, else (VEC false) each lane reads columns v * 32 + lane, one
//     4-byte load each (coalesced).  There is no padding copy.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int TD = 128;          // D columns a block: four a lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 8;        // rows a warp has in flight
constexpr int C_TILE = 256;      // classes a block (256 * 128 * 4 bytes = 128 KB of shared memory)
constexpr int MAX_SPLIT = 8;     // blocks of a cluster along B (a portable cluster size)
constexpr int BLOCKS_PER_SM = 4;  // resident at once (at most 64 registers a thread)
constexpr int MAX_GRID_Z = 65535;
constexpr unsigned FULL = 0xffffffffu;

// the shared slot of tile column j: vector lanes hold columns 4 * lane + v at v * 32 + lane,
// element lanes columns v * 32 + lane at the same place
template <bool VEC>
__device__ __forceinline__ int slot(int j) {
  return VEC ? (j % 4) * 32 + j / 4 : j;
}

// add rows r0 + u * WARPS (u < UNROLL) of [.., r_end) into acc (the warps of a block
// interleave, so a short range still gives every warp rows); FILTER: read only the rows
// whose label falls in this block's classes (more than one C tile), else every row (one
// tile: the loads need not wait for the labels)
template <bool VEC, bool FILTER>
__device__ __forceinline__ void add_rows(const int* __restrict__ hv,
                                         const int* __restrict__ labels, int r0, int r_end,
                                         int c0, int ct, int D, int d0, int lane, int* acc) {
  const int mine =
      (lane < UNROLL && r0 + lane * WARPS < r_end) ? labels[r0 + lane * WARPS] : -1;
  int cls[UNROLL];
  int4 val[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int r = r0 + u * WARPS;
    const int lab = __shfl_sync(FULL, mine, u);
    cls[u] = (lab >= c0 && lab < c0 + ct) ? lab - c0 : -1;
    const bool take = r < r_end && (!FILTER || cls[u] >= 0);
    const int* row = hv + static_cast<long long>(r) * D + d0;
    if constexpr (VEC) {
      val[u] = (take && d0 + 4 * lane < D) ? __ldg(reinterpret_cast<const int4*>(row) + lane)
                                           : make_int4(0, 0, 0, 0);
    } else {
      val[u].x = (take && d0 + lane < D) ? __ldg(row + lane) : 0;
      val[u].y = (take && d0 + 32 + lane < D) ? __ldg(row + 32 + lane) : 0;
      val[u].z = (take && d0 + 64 + lane < D) ? __ldg(row + 64 + lane) : 0;
      val[u].w = (take && d0 + 96 + lane < D) ? __ldg(row + 96 + lane) : 0;
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (cls[u] < 0) continue;  // uniform over the warp
    int* a = acc + cls[u] * TD + lane;
    atomicAdd(a, val[u].x);
    atomicAdd(a + 32, val[u].y);
    atomicAdd(a + 64, val[u].z);
    atomicAdd(a + 96, val[u].w);
  }
}

template <typename Out, bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) bundle_binarize_kernel(
    const int* __restrict__ hv, const int* __restrict__ labels, int B, int C, int D,
    Out* __restrict__ out) {
  extern __shared__ int acc[];  // [ct][TD], by slot
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());  // the cluster spans gridDim.y
  const int rank = static_cast<int>(cluster.block_rank());
  const int d0 = blockIdx.x * TD;
  const int c0 = blockIdx.z * C_TILE;
  const int ct = min(C_TILE, C - c0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < ct * TD; i += THREADS) acc[i] = 0;
  __syncthreads();

  const int per = (B + splits - 1) / splits;
  const int r_begin = min(B, rank * per), r_end = min(B, r_begin + per);
  const bool filter = gridDim.z > 1;  // uniform over the grid
  for (int r0 = r_begin + warp; r0 < r_end; r0 += WARPS * UNROLL) {
    if (filter) add_rows<VEC, true>(hv, labels, r0, r_end, c0, ct, D, d0, lane, acc);
    else add_rows<VEC, false>(hv, labels, r0, r_end, c0, ct, D, d0, lane, acc);
  }
  cluster.sync();  // every block's sums are in its shared memory

  for (int i = rank * THREADS + static_cast<int>(threadIdx.x); i < ct * TD; i += splits * THREADS) {
    const int c = i / TD, j = i % TD;
    int* mine = &acc[c * TD + slot<VEC>(j)];
    int v[MAX_SPLIT];
#pragma unroll
    for (int k = 0; k < MAX_SPLIT; ++k)  // all of an element's loads in flight together
      v[k] = k < splits ? *cluster.map_shared_rank(mine, k) : 0;
    int s = 0;
#pragma unroll
    for (int k = 0; k < MAX_SPLIT; ++k) s += v[k];
    if (d0 + j >= D) continue;
    Out* dst = out + static_cast<long long>(c0 + c) * D + d0 + j;
    if constexpr (sizeof(Out) == 1) {
      *dst = static_cast<Out>(s >= 0 ? 1 : -1);
    } else {
      *dst = static_cast<Out>(s);
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

// How many clusters of `splits` blocks of this kernel, with `smem` bytes of shared memory
// each, the card holds at once (cudaOccupancyMaxActiveClusters), cached by device, kernel,
// size and bytes: a cluster must sit whole in one GPC, so fewer fit than the SM count and
// the blocks an SM holds alone would say.  The wrapper's calls may come from several host
// threads.
int active_clusters(const void* kernel, cudaLaunchConfig_t cfg, int splits, int* n) {
  static std::mutex lock;
  static std::map<std::tuple<int, const void*, int, int>, int> cache;
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  const std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_tuple(dev, kernel, splits, static_cast<int>(cfg.dynamicSmemBytes));
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *n = hit->second;
    return 0;
  }
  const cudaError_t err = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  cache[key] = *n;
  return 0;
}

// The launch of one call but its stream: grid, block, shared bytes, and the cluster size
// along B (in `la`, which cfg.attrs points at): the largest, up to 8, whose grid of clusters
// runs in one wave (a second wave for a few clusters would double the time), else 1.
template <typename Out, bool VEC>
int configure(int C, int D, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& la) {
  auto kernel = bundle_binarize_kernel<Out, VEC>;
  const int gx = (D + TD - 1) / TD, gz = (C + C_TILE - 1) / C_TILE;
  const int smem = (C < C_TILE ? C : C_TILE) * TD * static_cast<int>(sizeof(int));
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  la.id = cudaLaunchAttributeClusterDimension;
  la.val.clusterDim.x = 1;
  la.val.clusterDim.z = 1;
  cfg.attrs = &la;
  cfg.numAttrs = 1;
  const long long tiles = static_cast<long long>(gx) * gz;
  int splits = MAX_SPLIT;
  for (; splits > 1; splits /= 2) {
    la.val.clusterDim.y = splits;
    cfg.gridDim = dim3(gx, splits, gz);
    int n = 0;
    const int err = active_clusters(reinterpret_cast<const void*>(kernel), cfg, splits, &n);
    if (err) return err;
    if (tiles <= n) break;
  }
  la.val.clusterDim.y = splits;
  cfg.gridDim = dim3(gx, splits, gz);
  return 0;
}

template <typename Out, bool VEC>
int launch(const int* hv, const int* labels, int B, int C, int D, void* out, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute la;
  const int conf = configure<Out, VEC>(C, D, cfg, la);
  if (conf) return conf;
  cfg.stream = s;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, bundle_binarize_kernel<Out, VEC>, hv, labels,
                                             B, C, D, static_cast<Out*>(out));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// hv (B, D) int32, labels (B,) int32, out (C, D): int8 signs (+1 where the class sum is
// >= 0, else -1) when binarize != 0, else int32 sums.  Labels outside [0, C) are dropped.
// One launch.  Returns the first CUDA error, or 0.
int uhd_bundle_binarize(const int* hv, const int* labels, int B, int C, int D, int binarize,
                        void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if ((C + C_TILE - 1) / C_TILE > MAX_GRID_Z) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(hv) % 16 == 0;
  if (binarize) {
    return vec ? launch<int8_t, true>(hv, labels, B, C, D, out, s)
               : launch<int8_t, false>(hv, labels, B, C, D, out, s);
  }
  return vec ? launch<int, true>(hv, labels, B, C, D, out, s)
             : launch<int, false>(hv, labels, B, C, D, out, s);
}

// The cluster size a call with these C and D takes (aligned: the hv base is 16-byte
// aligned), or 0 where the occupancy query fails.  A function of the shape alone.
int uhd_bundle_binarize_cluster(int C, int D, int binarize, int aligned) {
  if (C <= 0 || D <= 0) return 1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute la;
  const bool vec = D % 4 == 0 && aligned;
  const int err = binarize ? (vec ? configure<int8_t, true>(C, D, cfg, la)
                                  : configure<int8_t, false>(C, D, cfg, la))
                           : (vec ? configure<int, true>(C, D, cfg, la)
                                  : configure<int, false>(C, D, cfg, la));
  return err ? 0 : static_cast<int>(la.val.clusterDim.y);
}

}  // extern "C"
