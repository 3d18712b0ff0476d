// Packed-Hamming top-k retrieval for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamming_topk_pallas (src/repro/kernels/hamming_topk.py:80,
// body _topk_kernel :41): for each packed query, the k nearest of C packed rows by
// popcount(q ^ row), ascending by (distance, row index), the lowest index winning ties.
// Plain versions: repro_torch/kernels/ref.py (hamming_topk, hamming_topk_oracle).
//
// What bounds it: XOR + popcount + add over B*C*W words on the CUDA cores (popcount
// issues at a quarter of the int32 rate); the row store, C*W*4 bytes, is read once per
// query tile.
//
// What the design does about it:
//   * the TPU kernel scans C in order inside one grid row per query tile.  Serving
//     batches are small (B = 64), so here C is split across blocks: block (r, t) scores
//     rows [r*RB, (r+1)*RB) against QB queries, one warp per row (lanes stride the
//     words, coalesced; queries come through the read-only cache), and reduces the lane
//     sums with shuffles;
//   * each candidate is a 64-bit key (distance << 32 | index).  Keys are unique and
//     their unsigned order is exactly the pinned (distance, index) order, so a block
//     bitonic-sorts its RB keys in shared memory and keeps the first min(k, rows) of
//     them: one sorted run per block;
//   * the runs are then merged in pairs, pass after pass, keeping the first k of each
//     merged run.  Each thread places one key at (its rank in its own run) + (the
//     number of keys below it in the other run, by binary search): the merge is exact
//     and needs no synchronisation.  The last pass writes indices and distances.
//     Every k from 1 to C works; a predict store (C <= RB) needs one launch.
//   * rows past C never become keys; pad bits are zero in both operands and cancel
//     in the XOR, so D % 32 != 0 needs nothing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int TPB = 256;          // threads per block
constexpr int RB = TPB;           // rows per scan block (one key per thread in the sort)
constexpr int QB = 8;             // queries per scan block
constexpr int QCHUNK = 8192;      // queries per host-side chunk (bounds grid.y and scratch)
constexpr u64 SENTINEL = (static_cast<u64>(INT_MAX) << 32) | static_cast<u64>(INT_MAX);

__device__ __forceinline__ void bitonic_sort(u64* a) {
  const int i = threadIdx.x;
  for (int size = 2; size <= RB; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      const int j = i ^ stride;
      if (j > i) {
        const bool up = (i & size) == 0;
        const u64 ai = a[i], aj = a[j];
        if ((ai > aj) == up) {
          a[i] = aj;
          a[j] = ai;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void put(u64 key, long long slot, u64* run_out, int* idx, int* dist) {
  if (run_out) {
    run_out[slot] = key;
  } else {
    idx[slot] = static_cast<int>(key & 0xffffffffull);
    dist[slot] = static_cast<int>(key >> 32);
  }
}

// Rows covered by run r when each run spans `span` rows, capped at k.
__device__ __forceinline__ int run_len(long long r, long long span, int C, int k) {
  const long long lo = r * span;
  const long long hi = min(static_cast<long long>(C), lo + span);
  return static_cast<int>(min(static_cast<long long>(k), hi - lo));
}

__global__ void __launch_bounds__(TPB) scan_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows, int B, int C, int W,
    int k, u64* __restrict__ runs, int stride, int* __restrict__ idx, int* __restrict__ dist) {
  __shared__ u64 keys[QB][RB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * RB;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, B - q0);
  for (int r = warp; r < RB; r += TPB / 32) {
    const int row = r0 + r;
    unsigned acc[QB];
#pragma unroll
    for (int t = 0; t < QB; ++t) acc[t] = 0;
    if (row < C) {
      const uint32_t* rp = rows + static_cast<long long>(row) * W;
      for (int j = lane; j < W; j += 32) {
        const uint32_t v = rp[j];
#pragma unroll
        for (int t = 0; t < QB; ++t)
          if (t < nq) acc[t] += __popc(v ^ __ldg(q + static_cast<long long>(q0 + t) * W + j));
      }
    }
#pragma unroll
    for (int t = 0; t < QB; ++t) {
      unsigned s = acc[t];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0)
        keys[t][r] = row < C ? (static_cast<u64>(s) << 32) | static_cast<u64>(row) : SENTINEL;
    }
  }
  for (int t = 0; t < nq; ++t) bitonic_sort(keys[t]);
  const int len = min(k, min(RB, C - r0));
  for (int t = 0; t < nq; ++t)
    for (int i = threadIdx.x; i < len; i += TPB) {
      const long long slot = runs ? (static_cast<long long>(q0 + t) * gridDim.x + blockIdx.x) * stride + i
                                  : static_cast<long long>(q0 + t) * k + i;
      put(keys[t][i], slot, runs, idx, dist);
    }
}

// Number of keys of the sorted run a[0, n) that are below key.
__device__ __forceinline__ int rank_in(const u64* a, int n, u64 key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(TPB) merge_kernel(
    const u64* __restrict__ in, int in_runs, int in_stride, long long span, u64* __restrict__ out,
    int out_stride, int C, int k, int* __restrict__ idx, int* __restrict__ dist) {
  const int out_runs = (in_runs + 1) / 2;
  const int per = (2 * in_stride + TPB - 1) / TPB;  // blocks per output run
  const int r = blockIdx.x / per;
  const int e = (blockIdx.x % per) * TPB + threadIdx.x;
  const int b = blockIdx.y;
  const int ra = 2 * r, rb = 2 * r + 1;
  const int la = run_len(ra, span, C, k);
  const int lb = rb < in_runs ? run_len(rb, span, C, k) : 0;
  if (e >= la + lb) return;
  const u64* A = in + (static_cast<long long>(b) * in_runs + ra) * in_stride;
  const u64* Bq = A + in_stride;
  u64 key;
  int pos;
  if (e < la) {
    key = A[e];
    pos = e + rank_in(Bq, lb, key);
  } else {
    key = Bq[e - la];
    pos = e - la + rank_in(A, la, key);
  }
  if (pos >= min(k, la + lb)) return;
  const long long slot = out ? (static_cast<long long>(b) * out_runs + r) * out_stride + pos
                             : static_cast<long long>(b) * k + pos;
  put(key, slot, out, idx, dist);
}

}  // namespace

extern "C" {

// Keys of scratch that each of the two scratch buffers must hold for (B, C, k).
long long uhd_hamming_topk_scratch(int B, int C, int k) {
  const long long nb = (static_cast<long long>(C) + RB - 1) / RB;
  if (nb <= 1) return 0;
  long long runs = nb, span = RB, best = 0;
  long long stride = k < RB ? k : RB;
  for (;;) {
    best = runs * stride > best ? runs * stride : best;
    if (runs == 1) break;
    runs = (runs + 1) / 2;
    span *= 2;
    stride = k < span ? k : span;
  }
  return best * (B < QCHUNK ? B : QCHUNK);
}

// q (B, W) and rows (C, W) packed words; idx, dist (B, k) int32; 1 <= k <= C.
// scratch_a/b hold uhd_hamming_topk_scratch(B, C, k) 64-bit keys each (may be null
// when that is 0).  Returns the first CUDA error, or 0.
int uhd_hamming_topk(const int* q, const int* rows, int B, int C, int W, int k,
                     void* scratch_a, void* scratch_b, int* idx, int* dist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (C + RB - 1) / RB;
  for (int q0 = 0; q0 < B; q0 += QCHUNK) {
    const int qn = B - q0 < QCHUNK ? B - q0 : QCHUNK;
    const uint32_t* qp = reinterpret_cast<const uint32_t*>(q) + static_cast<long long>(q0) * W;
    int* ip = idx + static_cast<long long>(q0) * k;
    int* dp = dist + static_cast<long long>(q0) * k;
    u64* in = static_cast<u64*>(scratch_a);
    u64* out = static_cast<u64*>(scratch_b);
    int stride = k < RB ? k : RB;
    scan_kernel<<<dim3(nb, (qn + QB - 1) / QB), TPB, 0, s>>>(
        qp, reinterpret_cast<const uint32_t*>(rows), qn, C, W, k, nb > 1 ? in : nullptr,
        stride, ip, dp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    long long span = RB;
    for (int runs = nb; runs > 1;) {
      const int out_runs = (runs + 1) / 2;
      const int out_stride = static_cast<int>(k < 2 * span ? k : 2 * span);
      const int per = (2 * stride + TPB - 1) / TPB;
      merge_kernel<<<dim3(out_runs * per, qn), TPB, 0, s>>>(
          in, runs, stride, span, out_runs > 1 ? out : nullptr, out_stride, C, k, ip, dp);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      u64* t = in;
      in = out;
      out = t;
      runs = out_runs;
      stride = out_stride;
      span *= 2;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
