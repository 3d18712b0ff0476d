// Table-free uHD encode and fused training step for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/encode_bundle.py:
//   * encode_bundle_dynamic_pallas (:121, body _encode_bundle_dyn_kernel :88)
//     -> uhd_encode_bundle_dynamic: hv[b, d] = sum_h (2*[x[b,h] >= S[h,d]] - 1)
//   * fit_bundle_dynamic_pallas (:261, body _fit_bundle_dyn_kernel :224)
//     -> uhd_fit_bundle_dynamic: sums[c, d] = sum over rows labelled c of hv[b, d]
// S[h, d] is never stored: it is the quantized Sobol integer of point skip + d in
// dimension h, the XOR of the direction entries dir[h, j] selected by the set bits
// of gray(skip + d).  Plain versions: repro_torch/kernels/ref.py.
//
// What bounds it: compare-and-count work, B*H*D integer compares and adds on the
// CUDA cores (no tensor-core form is exact and cheap for a >= compare).  The bytes
// are small: x (B, H) int32, a (H, 32) direction matrix and the output.
//
// What the design does about it:
//   * one thread per output column d (DT columns a block), so each thread derives
//     gray(skip + d) once and builds S[h, d] for each h from bit planes:
//     bit m of S[h, d] is the parity of (P[h][m] & gray), where P[h][m] packs bit m
//     of the 32 direction entries of row h.  A warp stages a row with one ballot per
//     plane, up to the highest bit set in the HC-row chunk, so a (h, d) costs one
//     popcount per plane the entries use (log2(levels) for
//     quantized_direction_matrix), shared by the BB rows of the block;
//   * the block's x rows are staged in shared memory per HC-feature chunk, stored
//     transposed so a thread reads four rows with one 16-byte load;
//   * the BB row counters live in registers;
//   * the fused step folds hv into a (C, DT) partial in shared memory over several
//     row sub-tiles, then adds it to sums with int32 atomicAdd.  Integer addition is
//     exact in any order, so the result is deterministic.  Blocks split both D and
//     B, which gives enough blocks to fill 132 SMs at D = 8192.
// Ragged B, H and D are masked in the kernels: no padding, no correction.
// skip is a runtime argument, taken modulo 2**32 as the TPU kernel's uint32 index.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DT = 128;     // columns per block (one thread each)
constexpr int BB = 32;      // rows per sub-tile (register counters per thread)
constexpr int HC = 32;      // features per staged chunk
constexpr int WARPS = DT / 32;
constexpr int ROWS_PER_WARP = HC / WARPS;  // direction rows a warp stages per chunk
constexpr int MAXM = 32;    // threshold bits at most
constexpr int FIT_SUB = 4;  // row sub-tiles per fused-step block
constexpr int XS_PITCH = BB + 4;           // keeps rows 16-byte aligned
constexpr int ACC_SMEM_BYTES = 32 * 1024;  // (C, DT) partial in shared memory

__device__ __forceinline__ uint32_t load_dir(const void* dir, int dir_bytes, long long i) {
  if (dir_bytes == 1) return static_cast<const uint8_t*>(dir)[i];
  if (dir_bytes == 2) return static_cast<const uint16_t*>(dir)[i];
  return static_cast<const uint32_t*>(dir)[i];
}

__device__ __forceinline__ uint32_t gray_of(long long skip, int col) {
  const uint32_t idx = static_cast<uint32_t>(skip + col);  // modulo 2**32
  return idx ^ (idx >> 1);
}

// cnt[b] = #{h : x[b0 + b, h] >= S[h, col]} for the BB rows of one sub-tile.
// Called by every thread of the block (it synchronises).
__device__ __forceinline__ void count_tile(
    const int* __restrict__ x, const void* __restrict__ dir, int dir_bytes,
    int B, int H, int b0, uint32_t gray, int (&cnt)[BB],
    int (*xs)[XS_PITCH], uint32_t (*planes)[MAXM], int* nbits /* (WARPS,) */) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int b = 0; b < BB; ++b) cnt[b] = 0;
  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hn = min(HC, H - h0);
    // a warp stages whole direction rows, lane j holding entry j; the loads are
    // issued first so that their latency overlaps the x staging below
    uint32_t e[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int h = warp * ROWS_PER_WARP + r;
      e[r] = h < hn ? load_dir(dir, dir_bytes, static_cast<long long>(h0 + h) * 32 + lane) : 0u;
    }
    __syncthreads();  // the previous chunk is consumed
    for (int t = tid; t < BB * HC; t += DT) {
      const int b = t / HC, h = t % HC;
      const int gb = b0 + b;
      xs[h][b] = (gb < B && h < hn) ? x[static_cast<long long>(gb) * H + h0 + h] : INT_MIN;
    }
    // plane m of a row is one ballot.  Planes above the highest bit set in the chunk
    // are zero: they are neither built nor read, and the count of planes is uniform
    // over the block, so the compare loop below has one trip count
    uint32_t any = 0;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) any |= e[r];
    const int nbw = 32 - __clz(__reduce_or_sync(0xffffffffu, any));  // __clz(0) == 32
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int h = warp * ROWS_PER_WARP + r;
      uint32_t mine = 0;  // lane m keeps plane m
      for (int m = 0; m < nbw; ++m) {
        const uint32_t p = __ballot_sync(0xffffffffu, (e[r] >> m) & 1u);
        if (lane == m) mine = p;
      }
      planes[h][lane] = mine;
    }
    if (lane == 0) nbits[warp] = nbw;
    __syncthreads();
    int nb = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) nb = max(nb, nbits[w]);
    for (int h = 0; h < hn; ++h) {
      uint32_t s = 0;
      for (int m = 0; m < nb; ++m) s |= static_cast<uint32_t>(__popc(planes[h][m] & gray) & 1) << m;
      const int si = static_cast<int>(s);  // the TPU kernel compares int32 bit patterns
      const int4* xr = reinterpret_cast<const int4*>(xs[h]);
#pragma unroll
      for (int q = 0; q < BB / 4; ++q) {
        const int4 v = xr[q];
        cnt[4 * q + 0] += v.x >= si;
        cnt[4 * q + 1] += v.y >= si;
        cnt[4 * q + 2] += v.z >= si;
        cnt[4 * q + 3] += v.w >= si;
      }
    }
  }
}

__global__ void __launch_bounds__(DT) encode_kernel(
    const int* __restrict__ x, const void* __restrict__ dir, int dir_bytes,
    int* __restrict__ out, int B, int H, int D, long long skip) {
  __shared__ __align__(16) int xs[HC][XS_PITCH];
  __shared__ uint32_t planes[HC][MAXM];
  __shared__ int nbits[WARPS];
  const int col = blockIdx.x * DT + threadIdx.x;
  const int b0 = blockIdx.y * BB;
  int cnt[BB];
  count_tile(x, dir, dir_bytes, B, H, b0, gray_of(skip, col), cnt, xs, planes, nbits);
  if (col >= D) return;
#pragma unroll
  for (int b = 0; b < BB; ++b)
    if (b0 + b < B) out[static_cast<long long>(b0 + b) * D + col] = 2 * cnt[b] - H;
}

__global__ void __launch_bounds__(DT) fit_kernel(
    const int* __restrict__ x, const void* __restrict__ dir, int dir_bytes,
    const int* __restrict__ labels, int* __restrict__ sums, int B, int H, int C, int D,
    long long skip, int acc_in_smem) {
  __shared__ __align__(16) int xs[HC][XS_PITCH];
  __shared__ uint32_t planes[HC][MAXM];
  __shared__ int nbits[WARPS];
  extern __shared__ int acc[];  // (C, DT), only when acc_in_smem
  const int tid = threadIdx.x;
  const int col = blockIdx.x * DT + tid;
  const uint32_t gray = gray_of(skip, col);
  if (acc_in_smem)
    for (int c = 0; c < C; ++c) acc[c * DT + tid] = 0;  // each thread owns its column
  int cnt[BB];
  for (int sub = 0; sub < FIT_SUB; ++sub) {
    const int b0 = (blockIdx.y * FIT_SUB + sub) * BB;
    if (b0 >= B) break;  // uniform across the block
    count_tile(x, dir, dir_bytes, B, H, b0, gray, cnt, xs, planes, nbits);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      if (b0 + b >= B) continue;
      const int lab = __ldg(labels + b0 + b);
      if (lab < 0 || lab >= C) continue;  // out-of-range labels contribute nothing
      const int hv = 2 * cnt[b] - H;
      if (acc_in_smem) acc[lab * DT + tid] += hv;
      else if (col < D) atomicAdd(sums + static_cast<long long>(lab) * D + col, hv);
    }
  }
  if (!acc_in_smem || col >= D) return;
  for (int c = 0; c < C; ++c) {
    const int v = acc[c * DT + tid];
    if (v) atomicAdd(sums + static_cast<long long>(c) * D + col, v);
  }
}

}  // namespace

extern "C" {

// x (B, H) int32; dir (H, 32) unsigned entries of dir_bytes bytes; out (B, D) int32.
// Returns cudaGetLastError().
int uhd_encode_bundle_dynamic(const int* x, const void* dir, int dir_bytes, int* out,
                              int B, int H, int D, long long skip, void* stream) {
  if (B > 0 && D > 0) {
    const dim3 grid((D + DT - 1) / DT, (B + BB - 1) / BB);
    encode_kernel<<<grid, DT, 0, static_cast<cudaStream_t>(stream)>>>(
        x, dir, dir_bytes, out, B, H, D, skip);
  }
  return static_cast<int>(cudaGetLastError());
}

// As above, plus labels (B,) int32; sums (C, D) int32, zeroed by the caller.
int uhd_fit_bundle_dynamic(const int* x, const void* dir, int dir_bytes, const int* labels,
                           int* sums, int B, int H, int C, int D, long long skip,
                           void* stream) {
  if (B > 0 && D > 0 && C > 0) {
    const size_t acc_bytes = static_cast<size_t>(C) * DT * sizeof(int);
    const int in_smem = acc_bytes <= ACC_SMEM_BYTES;
    const dim3 grid((D + DT - 1) / DT, (B + BB * FIT_SUB - 1) / (BB * FIT_SUB));
    fit_kernel<<<grid, DT, in_smem ? acc_bytes : 0, static_cast<cudaStream_t>(stream)>>>(
        x, dir, dir_bytes, labels, sums, B, H, C, D, skip, in_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
