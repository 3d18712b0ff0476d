// Packed-Hamming top-k retrieval for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamming_topk_pallas (src/repro/kernels/hamming_topk.py:80,
// body _topk_kernel :41): for each packed query, the k nearest of C packed rows by
// popcount(q ^ row), ascending by (distance, row index), the lowest index winning ties.
// Plain versions: repro_torch/kernels/ref.py (hamming_topk, hamming_topk_oracle).
//
// What bounds it.  The distances are an exact binary matrix product: popcount(q ^ c) =
// popcount(q) + popcount(c) - 2 * popcount(q & c), and popcount(q & c) is the dot product
// of the 0/1 bits.  On the tensor cores (mma.sync m16n8k256 .b1 .and.popc, BMMA in SASS:
// 0.59 a clock an SM, 10 P binary ops/s on the card) 64 queries against 2^20 rows of 8,192
// bits are 0.11 ms of products, so the store's bytes, C * W * 4 read once per 64 queries,
// bound a search: 1 GiB at 3.35 TB/s is 0.32 ms.  The selection is k of C keys a query.
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
//   * tensor (C > WARP_MAX_ROWS; the store search): a block holds 64 queries (four m16
//     tiles) in shared memory, 256 words at a time (once, where W <= 256), each query's
//     popcount summed as it is staged, and walks a contiguous range of 256-row tiles: the
//     rows split over one block an SM (tiles_per_block), so the store is read once per
//     64 queries.  Where that grid would leave SMs idle (a store of a few thousand rows,
//     or few queries) a block takes 16 or 32 queries instead (Plan::mt), a template
//     argument so that the products stay straight-line code.  Each of its 8 warps
//     streams 32 rows of a tile (four n8 tiles) from device memory, 16 bytes a lane,
//     straight into the B fragments, with the loads of the next DEPTH 512-bit steps in
//     flight (across tile edges too, so the next tile's loads run under a tile's
//     epilogue).  The epilogue puts the tile's (queries, 256) distances in shared memory,
//     then one warp a query selects from them.  For k <=
//     RUN_MAX_K the warp keeps the query's first k keys of the block's rows as a sorted
//     list a lane each: a tile's key below the list's last joins it (a warp-wide minimum,
//     then a shift), and after the first tiles almost none does; the block writes one
//     sorted run.  For larger k each tile writes its first min(k, 256) keys as a run, as
//     many rounds of the warp-wide minimum.
//   The runs are then merged in pairs, pass after pass, keeping the first k of each
//   merged run.  Each thread places one key at (its rank in its own run) + (the number
//   of keys below it in the other run, by binary search): the merge is exact and needs
//   no synchronisation.  The last pass writes indices and distances.  Every k from 1 to
//   C works on both paths; a store of C <= 256 rows needs one launch.  Rows past C never
//   become keys; pad bits are zero in both operands (words past W load as zero), so D %
//   32 != 0 needs nothing.
//
// The CUDA-core scan it replaced (XOR + __popc over 16 queries a block, the store read
// four times for 64 queries) took 4.60 ms at B = 64, C = 2^20, W = 256, k = 8, and its
// 12 merge passes over 4,096 runs 0.29 ms more (PERF.md): the popcount pipe's limit.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma.cuh"

namespace {

typedef unsigned long long u64;

constexpr int TPB = 256;          // threads per block of the merge
constexpr int QCHUNK = 8192;      // queries per host-side chunk (bounds grid.y and scratch)
constexpr int WARP_MAX_ROWS = 64; // rows the warp path takes: two keys a lane
constexpr int WARP_QUERIES = 4;   // queries (warps) a warp-path block holds
constexpr u64 SENTINEL = (static_cast<u64>(INT_MAX) << 32) | static_cast<u64>(INT_MAX);
constexpr unsigned FULL = 0xffffffffu;

enum Path { PATH_WARP = 0, PATH_TENSOR = 1 };

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

// ---------------------------------------------------------------------------
// tensor path: mma.sync m16n8k256 .b1 .and.popc, a k-best selection in the epilogue
// ---------------------------------------------------------------------------

constexpr int MQ = 16;                    // queries an m16 tile
constexpr int T_MT = 4;                   // m16 tiles a block at most: 64 queries
constexpr int T_WARPS = 8;
constexpr int T_NT = 4;                   // n8 tiles a warp: 32 rows
constexpr int TILE = T_WARPS * T_NT * 8;  // 256 rows a tile
constexpr int KC = 256;                   // query words staged a chunk
constexpr int KC_STEPS = KC / 16;         // 512-bit steps a chunk
constexpr int Q_PITCH = KC + 16;          // = 16 mod 32: a quarter-warp's 16-byte reads hit 32 banks
constexpr int D_PITCH = TILE + 8;         // = 8 mod 32: a half-warp's 8-byte writes hit 32 banks
constexpr int DEPTH = 4;                  // 512-bit steps of row loads in flight (divides KC_STEPS)
constexpr int RUN_MAX_K = 32;             // the largest k a warp keeps as a running list
static_assert(KC == T_WARPS * 32, "a block stages a query chunk one column a thread");

// shared memory of a block of MT m16 tiles
constexpr int t_smem(int mt) { return mt * MQ * (RUN_MAX_K * 8 + Q_PITCH * 4 + D_PITCH * 4 + 4); }

// Block (x, y) scores queries [16 MT y, 16 MT (y + 1)) against rows [x * tiles_per_block *
// TILE, ...) a tile at a time.  RUNNING (k <= RUN_MAX_K): one sorted run of the block's first
// min(k, rows) keys a query, run x of n_runs; else a run a tile, run x * tiles_per_block
// + tile.  A run's slot i of query b is runs[(b * n_runs + run) * stride + i], or with
// one run (runs null) the result itself.
template <bool VEC, bool RUNNING, int MT>
__global__ void __launch_bounds__(T_WARPS * 32, 1) tensor_topk_kernel(
    const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows, int B, int C, int W,
    int k, int tiles_per_block, u64* __restrict__ runs, long long n_runs, int stride,
    int* __restrict__ idx, int* __restrict__ dist) {
  extern __shared__ uint4 smem[];
  constexpr int tq = MT * MQ;  // queries a block
  u64* lists = reinterpret_cast<u64*>(smem);                          // [tq][RUN_MAX_K]
  uint32_t* qs = reinterpret_cast<uint32_t*>(lists + tq * RUN_MAX_K);  // [tq][Q_PITCH]
  int* ds = reinterpret_cast<int*>(qs + tq * Q_PITCH);                 // [tq][D_PITCH]
  int* qpop = ds + tq * D_PITCH;                                       // [tq]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // the fragments' group and thread in group
  const int b0 = blockIdx.y * tq;
  const int nq = min(tq, B - b0);
  const long long first = static_cast<long long>(blockIdx.x) * tiles_per_block * TILE;
  const int row0 = static_cast<int>(first);
  const int row_end = static_cast<int>(min(static_cast<long long>(C),
                                           first + static_cast<long long>(tiles_per_block) * TILE));
  const int nt = (row_end - row0 + TILE - 1) / TILE;  // tiles of this block
  // a tile's steps: KC_STEPS a chunk, the last chunk's rounded up to a multiple of DEPTH
  // (words past W load as zero and add nothing)
  const int nch = max(1, (W + KC - 1) / KC);
  const int last = max(DEPTH, ((W - (nch - 1) * KC + 15) / 16 + DEPTH - 1) / DEPTH * DEPTH);
  const int steps = KC_STEPS * (nch - 1) + last;

  if (threadIdx.x < tq) qpop[threadIdx.x] = 0;
  if (RUNNING)
    for (int i = threadIdx.x; i < tq * RUN_MAX_K; i += T_WARPS * 32) lists[i] = SENTINEL;

  // the loads run DEPTH steps ahead of the products: step lj of tile lt is next
  int lt = 0, lj = 0;
  const uint32_t* lp[T_NT];
  bool live[T_NT];
  auto aim = [&](int tile) {
#pragma unroll
    for (int n = 0; n < T_NT; ++n) {
      const int r = row0 + tile * TILE + warp * (T_NT * 8) + n * 8 + g;
      live[n] = tile < nt && r < row_end;
      lp[n] = rows + static_cast<long long>(live[n] ? r : 0) * W;
    }
  };
  auto fetch = [&](uint4 (&v)[T_NT]) {
#pragma unroll
    for (int n = 0; n < T_NT; ++n) v[n] = load4<VEC>(lp[n], live[n], 16 * lj + 4 * t, W);
    if (++lj == steps) {
      lj = 0;
      aim(++lt);
    }
  };
  // stage chunk c of the block's queries (zero past W and past B), a column a thread with
  // an m16 tile's loads in flight at once; `count` adds each query's popcount
  auto stage = [&](int c, bool count) {
    __syncthreads();  // the previous chunk's reads are done
    const int kc = c * KC, j = threadIdx.x;
    const bool jlive = j < W - kc;
    for (int r0 = 0; r0 < tq; r0 += MQ) {
      uint32_t v[MQ];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
        v[i] = (jlive && r0 + i < nq) ? __ldg(q + static_cast<long long>(b0 + r0 + i) * W + kc + j) : 0u;
#pragma unroll
      for (int i = 0; i < MQ; ++i) qs[(r0 + i) * Q_PITCH + j] = v[i];
    }
    __syncthreads();
    if (count)  // read in the epilogue, behind its barriers
      for (int r = warp; r < nq; r += T_WARPS) {
        unsigned pc = 0;
#pragma unroll
        for (int jj = lane; jj < KC; jj += 32) pc += __popc(qs[r * Q_PITCH + jj]);
        pc = __reduce_add_sync(FULL, pc);
        if (lane == 0) qpop[r] += static_cast<int>(pc);
      }
  };

  aim(0);
  uint4 buf[DEPTH][T_NT];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) fetch(buf[d]);

  for (int tile = 0; tile < nt; ++tile) {
    int acc[MT][T_NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < T_NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0;
    unsigned cpop[T_NT] = {};  // this lane's share of its rows' popcounts
    for (int c = 0; c < nch; ++c) {
      if (tile == 0 || nch > 1) stage(c, tile == 0);  // staged once where W <= KC
      const int sc = c + 1 < nch ? KC_STEPS : last;
      for (int j0 = 0; j0 < sc; j0 += DEPTH) {
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          uint4 bv[T_NT];
#pragma unroll
          for (int n = 0; n < T_NT; ++n) {
            bv[n] = buf[d][n];
            cpop[n] += popc4(bv[n]);
          }
          fetch(buf[d]);
          const int kw = 16 * (j0 + d) + 4 * t;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const uint4 lo = *reinterpret_cast<const uint4*>(&qs[(m * 16 + g) * Q_PITCH + kw]);
            const uint4 hi = *reinterpret_cast<const uint4*>(&qs[(m * 16 + g + 8) * Q_PITCH + kw]);
#pragma unroll
            for (int n = 0; n < T_NT; ++n) {
              mma_b1(acc[m][n], lo.x, hi.x, lo.y, hi.y, bv[n].x, bv[n].y);
              mma_b1(acc[m][n], lo.z, hi.z, lo.w, hi.w, bv[n].z, bv[n].w);
            }
          }
        }
      }
    }

    // a row's popcount: the sum over the four lanes of its group
#pragma unroll
    for (int n = 0; n < T_NT; ++n) {
      cpop[n] += __shfl_xor_sync(FULL, cpop[n], 1);
      cpop[n] += __shfl_xor_sync(FULL, cpop[n], 2);
    }
    __syncthreads();  // the previous tile's selection has read ds
    // accumulator i of tile (m, n): query m * 16 + g + 8 * (i / 2), row n * 8 + 2 * t + i % 2
#pragma unroll
    for (int n = 0; n < T_NT; ++n) {
      const int pc0 = static_cast<int>(__shfl_sync(FULL, cpop[n], (2 * t) * 4));
      const int pc1 = static_cast<int>(__shfl_sync(FULL, cpop[n], (2 * t + 1) * 4));
      const int c = warp * (T_NT * 8) + n * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ql = m * 16 + g + 8 * h;
          *reinterpret_cast<int2*>(&ds[ql * D_PITCH + c]) =
              make_int2(qpop[ql] + pc0 - 2 * acc[m][n][2 * h], qpop[ql] + pc1 - 2 * acc[m][n][2 * h + 1]);
        }
      }
    }
    __syncthreads();

    // one warp a query: lane keeps rows lane + 32 i of the tile
    const int trow = row0 + tile * TILE;
    const int n_rows = min(TILE, row_end - trow);
    for (int ql = warp; ql < nq; ql += T_WARPS) {
      u64 key[TILE / 32];
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const int r = lane + 32 * i;
        key[i] = r < n_rows ? (static_cast<u64>(static_cast<unsigned>(ds[ql * D_PITCH + r])) << 32) |
                                  static_cast<unsigned>(trow + r)
                            : SENTINEL;
      }
      if (RUNNING) {
        // the list: lane i < k holds the i-th key of the block's rows so far
        u64* list = lists + ql * RUN_MAX_K;
        u64 last_key = list[k - 1];
        bool below = false;
#pragma unroll
        for (int i = 0; i < TILE / 32; ++i) {
          key[i] = key[i] < last_key ? key[i] : SENTINEL;
          below |= key[i] != SENTINEL;
        }
        if (!__any_sync(FULL, below)) continue;  // uniform over the warp
        u64 mine = lane < k ? list[lane] : SENTINEL;
        for (;;) {
          u64 m = key[0];
#pragma unroll
          for (int j = 1; j < TILE / 32; ++j) m = key[j] < m ? key[j] : m;
          const u64 best = warp_min_key(m);
          if (best >= last_key) break;  // uniform; a SENTINEL best too
          const int pos = __popc(__ballot_sync(FULL, mine < best));
          const u64 up = __shfl_up_sync(FULL, mine, 1);
          mine = lane < pos ? mine : lane == pos ? best : lane < k ? up : SENTINEL;
          last_key = __shfl_sync(FULL, mine, k - 1);
#pragma unroll
          for (int j = 0; j < TILE / 32; ++j)
            if (key[j] == best) key[j] = SENTINEL;
        }
        if (lane < k) list[lane] = mine;
      } else {
        const long long run = static_cast<long long>(blockIdx.x) * tiles_per_block + tile;
        const long long base = runs ? (static_cast<long long>(b0 + ql) * n_runs + run) * stride
                                    : static_cast<long long>(b0 + ql) * k;
        const int len = min(k, n_rows);
        for (int i = 0; i < len; ++i) {
          u64 m = key[0];
#pragma unroll
          for (int j = 1; j < TILE / 32; ++j) m = key[j] < m ? key[j] : m;
          const u64 best = warp_min_key(m);  // a row's key: i < n_rows
#pragma unroll
          for (int j = 0; j < TILE / 32; ++j)
            if (key[j] == best) key[j] = SENTINEL;
          if (lane == 0) put(best, base + i, runs, idx, dist);
        }
      }
    }
  }

  if (RUNNING) {  // each warp writes the lists it kept
    const int len = min(k, row_end - row0);
    for (int ql = warp; ql < nq; ql += T_WARPS) {
      const long long base = runs ? (static_cast<long long>(b0 + ql) * n_runs + blockIdx.x) * stride
                                  : static_cast<long long>(b0 + ql) * k;
      if (lane < len) put(lists[ql * RUN_MAX_K + lane], base + lane, runs, idx, dist);
    }
  }
}

// How the tensor path splits B queries and a store of C rows for k on a card of `sms` SMs:
// tiles_per_block tiles a block, one block an SM; mt m16 tiles of queries a block, the
// fewest that keep the grid within one block an SM (a small store is read once per 16 or
// 32 queries, from L2, so that more SMs share it); `runs` sorted runs of `span` rows
// each, with `stride` slots a run.
struct Plan {
  int tiles_per_block, blocks, mt;
  long long runs, span;
  int stride;
};

Plan plan(int B, int C, int k, int sms) {
  Plan p;
  const int tiles = (C + TILE - 1) / TILE;
  p.tiles_per_block = (tiles + sms - 1) / sms;
  p.blocks = (tiles + p.tiles_per_block - 1) / p.tiles_per_block;
  const long long nb = B < QCHUNK ? B : QCHUNK;
  p.mt = T_MT;
  for (int mt = 1; mt < T_MT; mt *= 2)
    if (p.blocks * ((nb + mt * MQ - 1) / (mt * MQ)) <= sms) {
      p.mt = mt;
      break;
    }
  const bool running = k <= RUN_MAX_K;
  p.runs = running ? p.blocks : tiles;
  p.span = running ? static_cast<long long>(p.tiles_per_block) * TILE : TILE;
  p.stride = static_cast<int>(k < p.span ? k : p.span);
  return p;
}

template <bool VEC, bool RUNNING, int MT>
cudaError_t launch_tensor_mt(const uint32_t* q, const uint32_t* rows, int B, int C, int W, int k,
                          const Plan& p, u64* runs, int* idx, int* dist, cudaStream_t s) {
  auto kernel = tensor_topk_kernel<VEC, RUNNING, MT>;
  // the block's shared memory, allowed once a device (the attribute is the current
  // device's)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, t_smem(MT));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  kernel<<<dim3(p.blocks, (B + MT * MQ - 1) / (MT * MQ)), T_WARPS * 32, t_smem(MT), s>>>(
      q, rows, B, C, W, k, p.tiles_per_block, runs, p.runs, p.stride, idx, dist);
  return cudaGetLastError();
}

template <bool VEC, bool RUNNING>
cudaError_t launch_tensor(const uint32_t* q, const uint32_t* rows, int B, int C, int W, int k,
                          const Plan& p, u64* runs, int* idx, int* dist, cudaStream_t s) {
  return p.mt == 1   ? launch_tensor_mt<VEC, RUNNING, 1>(q, rows, B, C, W, k, p, runs, idx, dist, s)
         : p.mt == 2 ? launch_tensor_mt<VEC, RUNNING, 2>(q, rows, B, C, W, k, p, runs, idx, dist, s)
                     : launch_tensor_mt<VEC, RUNNING, T_MT>(q, rows, B, C, W, k, p, runs, idx, dist, s);
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

// Keys of scratch that each of the two scratch buffers must hold for (B, C, k) on the
// tensor path of a card of `sms` SMs (the warp path uses none).
long long uhd_hamming_topk_scratch(int B, int C, int k, int sms) {
  if (C <= TILE || sms < 1) return 0;  // one tile, one run (or a launch refused)
  const Plan p = plan(B, C, k, sms);
  if (p.runs <= 1) return 0;
  long long runs = p.runs, span = p.span, best = 0;
  long long stride = p.stride;
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
// 0 (warp: C <= WARP_MAX_ROWS) or 1 (tensor); sms, the current card's SM count.
// scratch_a/b hold uhd_hamming_topk_scratch(B, C, k, sms) 64-bit keys each (may be null
// when that is 0; the warp path uses none).  Returns the first CUDA error, or 0.
int uhd_hamming_topk(const int* q, const int* rows, int B, int C, int W, int k, int path,
                     int sms, void* scratch_a, void* scratch_b, int* idx, int* dist,
                     void* stream) {
  if ((path == PATH_WARP && C > WARP_MAX_ROWS) || path < PATH_WARP || path > PATH_TENSOR ||
      sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rows);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;  // 16-byte loads
  const Plan p = path == PATH_TENSOR ? plan(B, C, k, sms) : Plan{};
  for (int q0 = 0; q0 < B; q0 += QCHUNK) {
    const int qn = B - q0 < QCHUNK ? B - q0 : QCHUNK;
    const uint32_t* qp = qw + static_cast<long long>(q0) * W;
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
    u64* first = p.runs > 1 ? in : nullptr;
    const bool running = k <= RUN_MAX_K;
    cudaError_t err =
        vec ? (running ? launch_tensor<true, true>(qp, rw, qn, C, W, k, p, first, ip, dp, s)
                       : launch_tensor<true, false>(qp, rw, qn, C, W, k, p, first, ip, dp, s))
            : (running ? launch_tensor<false, true>(qp, rw, qn, C, W, k, p, first, ip, dp, s)
                       : launch_tensor<false, false>(qp, rw, qn, C, W, k, p, first, ip, dp, s));
    if (err != cudaSuccess) return static_cast<int>(err);
    long long span = p.span;
    int stride = p.stride;
    for (int runs = static_cast<int>(p.runs); runs > 1;) {
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
