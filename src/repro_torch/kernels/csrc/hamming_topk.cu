// Packed-Hamming top-k retrieval for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamming_topk_pallas (src/repro/kernels/hamming_topk.py:80,
// body _topk_kernel :41): for each packed query, the k nearest of C packed rows by
// popcount(q ^ row), ascending by (distance, row index), the lowest index winning ties.
// Plain versions: repro_torch/kernels/ref.py (hamming_topk, hamming_topk_oracle).
//
// What bounds it: XOR + popcount + add over B*C*W words on the CUDA cores; the
// popcount pipe (16 results a clock an SM, a quarter of the int32 rate) is the
// narrowest.  The row store, C*W*4 bytes, is read once per query tile.
//
// What the design does about it.  Each candidate is a 64-bit key (distance << 32 |
// index).  Keys are unique and their unsigned order is exactly the pinned (distance,
// index) order.  The wrapper picks one of two paths from C alone (ops.topk_path):
//   * warp (C <= WARP_MAX_ROWS; the predict path's class store): one warp a query, the
//     grid over queries.  Lanes stride the W words of four rows at a time (coalesced)
//     and sum each row with one warp reduction; lane r % 32 keeps row r's key.  k
//     rounds of a warp-wide minimum (two 32-bit reductions: the distance, then the
//     lowest index at it) emit the keys in order.  No shared memory, no sort, no
//     scratch, one launch;
//   * select (C > WARP_MAX_ROWS; the store search): block (r, t) scores rows
//     [r*RB, (r+1)*RB) against SQB queries staged in shared memory in chunks of WC
//     words (each row word loaded feeds SQB queries), one warp per row, lane t keeping
//     query t's distance.  Then one warp per query selects the first min(k, rows) keys
//     of the block by as many rounds of the warp-wide minimum: one sorted run per
//     block, without a sort.
//   The select path's runs are then merged in pairs, pass after pass, keeping the first
//   k of each merged run.  Each thread places one key at (its rank in its own run) +
//   (the number of keys below it in the other run, by binary search): the merge is
//   exact and needs no synchronisation.  The last pass writes indices and distances.
//   Every k from 1 to C works on both paths; a store of C <= RB rows needs one launch.
//   Rows past C never become keys; pad bits are zero in both operands and cancel in
//   the XOR, so D % 32 != 0 needs nothing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int TPB = 256;          // threads per block of the select scan and the merge
constexpr int RB = TPB;           // rows per select scan block (eight keys a lane)
constexpr int SQB = 16;           // queries per select scan block (<= 32: lane t keeps query t)
constexpr int WC = 256;           // query words a select block stages per chunk
constexpr int QCHUNK = 8192;      // queries per host-side chunk (bounds grid.y and scratch)
constexpr int WARP_MAX_ROWS = 64; // rows the warp path takes: two keys a lane
constexpr int WARP_QUERIES = 4;   // queries (warps) a warp-path block holds
constexpr u64 SENTINEL = (static_cast<u64>(INT_MAX) << 32) | static_cast<u64>(INT_MAX);
constexpr unsigned FULL = 0xffffffffu;

enum Path { PATH_WARP = 0, PATH_SELECT = 1 };

// The smallest of the warp's keys (each lane offers m), by two 32-bit reductions:
// the least distance, then the least index among the keys at that distance.
__device__ __forceinline__ u64 warp_min_key(u64 m) {
  const unsigned d = static_cast<unsigned>(m >> 32);
  const unsigned dmin = __reduce_min_sync(FULL, d);
  const unsigned imin = __reduce_min_sync(FULL, d == dmin ? static_cast<unsigned>(m) : 0xffffffffu);
  return (static_cast<u64>(dmin) << 32) | imin;
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

// Slot i of query b's output: its block's run in the scratch, or (one block) the result.
__device__ __forceinline__ long long run_slot(int b, int i, int k, const u64* runs, int stride) {
  return runs ? (static_cast<long long>(b) * gridDim.x + blockIdx.x) * stride + i
              : static_cast<long long>(b) * k + i;
}

// The warp path: one warp a query, C <= WARP_MAX_ROWS rows, any k in [1, C].
__global__ void __launch_bounds__(32 * WARP_QUERIES) warp_topk_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows, int B, int C, int W, int k,
    int* __restrict__ idx, int* __restrict__ dist) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARP_QUERIES + static_cast<int>(threadIdx.x) / 32;
  if (b >= B) return;  // uniform over the warp
  const uint32_t* qp = q + static_cast<long long>(b) * W;
  u64 key0 = SENTINEL, key1 = SENTINEL;  // rows lane and lane + 32
  for (int r0 = 0; r0 < C; r0 += 4) {
    unsigned acc[4] = {0u, 0u, 0u, 0u};
    const uint32_t* rp = rows + static_cast<long long>(r0) * W;
#pragma unroll 4
    for (int j = lane; j < W; j += 32) {
      const uint32_t qv = __ldg(qp + j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < C) acc[i] += __popc(qv ^ __ldg(rp + static_cast<long long>(i) * W + j));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      if (r >= C) break;  // uniform over the warp
      const u64 key = (static_cast<u64>(__reduce_add_sync(FULL, acc[i])) << 32) |
                      static_cast<unsigned>(r);
      if (lane == (r & 31)) {
        if (r < 32) key0 = key;
        else key1 = key;
      }
    }
  }
  int* ip = idx + static_cast<long long>(b) * k;
  int* dp = dist + static_cast<long long>(b) * k;
  for (int i = 0; i < k; ++i) {
    const u64 best = warp_min_key(key0 < key1 ? key0 : key1);  // a row's key: k <= C
    if (key0 == best) key0 = SENTINEL;
    else if (key1 == best) key1 = SENTINEL;
    if (lane == 0) {
      ip[i] = static_cast<int>(best & 0xffffffffull);
      dp[i] = static_cast<int>(best >> 32);
    }
  }
}

// The select path's scan: block (r, t) scores rows [r*RB, (r+1)*RB) against SQB
// queries and writes the first min(k, rows) keys of each query.
__global__ void __launch_bounds__(TPB) select_scan_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows, int B, int C, int W,
    int k, u64* __restrict__ runs, int stride, int* __restrict__ idx, int* __restrict__ dist) {
  __shared__ uint32_t qs[SQB][WC];  // a chunk of the block's query words
  __shared__ unsigned ds[SQB][RB];  // distances, summed over the chunks
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * RB;
  const int q0 = blockIdx.y * SQB;
  const int nq = min(SQB, B - q0);
  const int n = min(RB, C - r0);  // rows of this block
  for (int w0 = 0; w0 < W; w0 += WC) {
    const int wn = min(WC, W - w0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < SQB * WC; i += TPB) {
      const int t = i / WC, j = i % WC;
      qs[t][j] = (t < nq && j < wn) ? __ldg(q + static_cast<long long>(q0 + t) * W + w0 + j) : 0u;
    }
    __syncthreads();
    for (int r = warp; r < n; r += TPB / 32) {
      const uint32_t* rp = rows + static_cast<long long>(r0 + r) * W + w0;
      unsigned acc[SQB];
#pragma unroll
      for (int t = 0; t < SQB; ++t) acc[t] = 0u;
      for (int j = lane; j < wn; j += 32) {
        const uint32_t v = __ldg(rp + j);
#pragma unroll
        for (int t = 0; t < SQB; ++t) acc[t] += __popc(v ^ qs[t][j]);
      }
#pragma unroll
      for (int t = 0; t < SQB; ++t) {
        const unsigned sum = __reduce_add_sync(FULL, acc[t]);
        if (lane == t) ds[t][r] = (w0 ? ds[t][r] : 0u) + sum;
      }
    }
  }
  __syncthreads();
  const int len = min(k, n);
  for (int t = warp; t < nq; t += TPB / 32) {  // one warp a query
    u64 key[RB / 32];
#pragma unroll
    for (int i = 0; i < RB / 32; ++i) {
      const int r = lane + 32 * i;
      key[i] = r < n ? (static_cast<u64>(ds[t][r]) << 32) | static_cast<unsigned>(r0 + r)
                     : SENTINEL;
    }
    for (int i = 0; i < len; ++i) {
      u64 m = key[0];
#pragma unroll
      for (int j = 1; j < RB / 32; ++j) m = key[j] < m ? key[j] : m;
      const u64 best = warp_min_key(m);  // a row's key: i < n
#pragma unroll
      for (int j = 0; j < RB / 32; ++j)
        if (key[j] == best) key[j] = SENTINEL;
      if (lane == 0) put(best, run_slot(q0 + t, i, k, runs, stride), runs, idx, dist);
    }
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

// q (B, W) and rows (C, W) packed words; idx, dist (B, k) int32; 1 <= k <= C; path
// 0 (warp: C <= WARP_MAX_ROWS) or 1 (select).
// scratch_a/b hold uhd_hamming_topk_scratch(B, C, k) 64-bit keys each (may be null
// when that is 0; the warp path uses none).  Returns the first CUDA error, or 0.
int uhd_hamming_topk(const int* q, const int* rows, int B, int C, int W, int k, int path,
                     void* scratch_a, void* scratch_b, int* idx, int* dist, void* stream) {
  if ((path == PATH_WARP && C > WARP_MAX_ROWS) || path < PATH_WARP || path > PATH_SELECT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rows);
  const int nb = (C + RB - 1) / RB;
  for (int q0 = 0; q0 < B; q0 += QCHUNK) {
    const int qn = B - q0 < QCHUNK ? B - q0 : QCHUNK;
    const uint32_t* qp = reinterpret_cast<const uint32_t*>(q) + static_cast<long long>(q0) * W;
    int* ip = idx + static_cast<long long>(q0) * k;
    int* dp = dist + static_cast<long long>(q0) * k;
    if (path == PATH_WARP) {
      warp_topk_kernel<<<(qn + WARP_QUERIES - 1) / WARP_QUERIES, 32 * WARP_QUERIES, 0, s>>>(
          qp, rw, qn, C, W, k, ip, dp);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      continue;
    }
    u64* in = static_cast<u64*>(scratch_a);
    u64* out = static_cast<u64*>(scratch_b);
    int stride = k < RB ? k : RB;
    select_scan_kernel<<<dim3(nb, (qn + SQB - 1) / SQB), TPB, 0, s>>>(
        qp, rw, qn, C, W, k, nb > 1 ? in : nullptr, stride, ip, dp);
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
