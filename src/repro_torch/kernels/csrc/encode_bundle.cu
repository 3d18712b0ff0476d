// uHD encode and fused training step for Hopper (sm_90a), over a stored threshold
// table or over thresholds generated from Sobol direction numbers.
//
// Replaces four Pallas TPU kernels of src/repro/kernels/encode_bundle.py:
//   * encode_bundle_pallas (:55, body _encode_bundle_kernel :40)
//     -> uhd_encode_bundle: hv[b, d] = sum_h (2*[x[b,h] >= S[h,d]] - 1), S an (H, D) table
//   * encode_bundle_dynamic_pallas (:121, body _encode_bundle_dyn_kernel :88)
//     -> uhd_encode_bundle_dynamic: the same, S generated
//   * fit_bundle_pallas (:187, body _fit_bundle_kernel :170)
//     -> uhd_fit_bundle: sums[c, d] = sum over rows labelled c of hv[b, d], S a table
//   * fit_bundle_dynamic_pallas (:261, body _fit_bundle_dyn_kernel :224)
//     -> uhd_fit_bundle_dynamic: the same, S generated
// A generated S[h, d] is never stored: it is the quantized Sobol integer of point
// skip + d in dimension h, the XOR of the direction entries dir[h, j] selected by the
// set bits of gray(skip + d).  Plain versions: repro_torch/kernels/ref.py.
//
// What bounds it: compare-and-count work, B*H*D integer compares and adds on the
// CUDA cores (no tensor-core form is exact and cheap for a >= compare).  The bytes
// are small: x (B, H) int32, the threshold source ((H, D) int8 or int32 table, or a
// (H, 32) direction matrix) and the output.
//
// What the design does about it:
//   * one thread per output column d (DT columns a block); the compare loop is shared
//     by both threshold sources (count_tile, templated over the source), which hand it
//     S[h, d] for the HC features of a staged chunk:
//       - Table: the block stages an (HC, DT) tile of the table in shared memory, in
//         its stored width, with 16-byte coalesced loads issued before the x staging
//         (element loads where rows are not 16-byte aligned: ragged D);
//       - Generated: each thread derives gray(skip + d) once and builds S[h, d] for
//         each h from bit planes: bit m of S[h, d] is the parity of (P[h][m] & gray),
//         where P[h][m] packs bit m of the 32 direction entries of row h.  A warp
//         stages a row with one ballot per plane, up to the highest bit set in the
//         HC-row chunk, so a (h, d) costs one popcount per plane the entries use;
//   * the block's x rows are staged in shared memory per HC-feature chunk, stored
//     transposed so a thread reads four rows with one 16-byte load;
//   * the BB row counters live in registers;
//   * the fused step folds hv into a (C, DT) partial in shared memory over several
//     row sub-tiles, then adds it to sums with int32 atomicAdd.  Integer addition is
//     exact in any order, so the result is deterministic.  Blocks split both D and
//     B, which gives enough blocks to fill 132 SMs at D = 8192.
//
// The table-free training step over a uint8 direction matrix (thresholds in [0, 256),
// every configuration the launchers run) takes another form, with the same integers:
//     sums[c, d] = sum_h (2 * G[c, h, S[h, d]] - n_c),
//     G[c, h, t] = #{b : label b = c, x[b, h] >= t},  n_c = #{b : label b = c},
// so its work is B*H histogram counts plus C*H*D gather-adds and H*D threshold
// generations, none of which grows with B (the direct form is 2*B*H*D compares):
//   * hist_kernel: a block counts HIST_F features of every row into shared memory,
//     bucketing x as clamp(x, -1, T_h - 1) with T_h = 2^(bits of row h's direction
//     entries), so any int32 x compares as the TPU kernel compares it; labels outside
//     [0, C) count nowhere; then suffix sums over t give G, stored (H, 256, CP) int32
//     (CP = C rounded up to 4), and block 0 writes n_c.  It also ORs the direction
//     entries into one word, the bits any threshold uses;
//   * gather_kernel: one thread per output column, blocks split D and H (enough
//     blocks for 132 SMs at D = 2048 as at 8192); per chunk of features a block
//     stages G[h, 0..T) for every class in shared memory and the direction bit
//     planes, then each thread generates S[h, d] once and adds the C counts of row
//     (h, S) into registers, and writes 2 * acc - H * n_c (the H * n_c term once, by
//     the first H-split) with int32 atomics, exact in any order.
// The wrapper allocates G, n_c and the OR word; the kernels allocate nothing.
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

// ---------------------------------------------------------------------------
// Threshold sources.  Per HC-feature chunk [h0, h0 + hn), count_tile calls
// load (before the barrier that frees the previous chunk's shared memory),
// store (after it), ready (after the barrier that publishes the chunk), then
// at(h) for each h < hn: S[h0 + h, this thread's column] as an int.
// ---------------------------------------------------------------------------

// S read from a row-major (H, D) table of T (int8_t or int32_t).
template <class T>
struct Table {
  struct Args {
    const T* tab;
    int vec;  // rows start on 16-byte boundaries (D * sizeof(T) % 16 == 0, aligned base)
  };
  struct Shared {
    alignas(16) T ts[HC][DT];
  };
  static constexpr int PER_ROW = DT * static_cast<int>(sizeof(T)) / 16;  // int4 a tile row
  static constexpr int NV = HC * PER_ROW / DT;                             // int4 a thread
  static constexpr int ELEMS = 16 / static_cast<int>(sizeof(T));         // T in an int4
  static_assert(HC * PER_ROW % DT == 0, "a chunk's int4 loads split evenly over the block");

  const Args a;
  Shared& sh;
  const int D, col0;
  int4 v[NV];

  __device__ Table(const Args& args, Shared& s, int d, int c0) : a(args), sh(s), D(d), col0(c0) {}

  __device__ __forceinline__ void load(int h0, int hn) {
    if (!a.vec) return;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int q = threadIdx.x + i * DT, r = q / PER_ROW, e = col0 + (q % PER_ROW) * ELEMS;
      // with aligned rows D is a multiple of ELEMS, so an int4 starting inside the
      // row ends inside it
      v[i] = (r < hn && e < D)
                 ? __ldg(reinterpret_cast<const int4*>(a.tab + static_cast<long long>(h0 + r) * D + e))
                 : make_int4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(int h0, int hn) {
    if (a.vec) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int q = threadIdx.x + i * DT;
        reinterpret_cast<int4*>(&sh.ts[q / PER_ROW][0])[q % PER_ROW] = v[i];
      }
      return;
    }
    const int col = col0 + threadIdx.x;
    for (int r = 0; r < HC; ++r)
      sh.ts[r][threadIdx.x] =
          (r < hn && col < D) ? a.tab[static_cast<long long>(h0 + r) * D + col] : T(0);
  }

  __device__ __forceinline__ void ready() {}

  __device__ __forceinline__ int at(int h) const {
    return static_cast<int>(sh.ts[h][threadIdx.x]);  // int8 sign-extends, as in the plain version
  }
};

__device__ __forceinline__ uint32_t load_dir(const void* dir, int dir_bytes, long long i) {
  if (dir_bytes == 1) return static_cast<const uint8_t*>(dir)[i];
  if (dir_bytes == 2) return static_cast<const uint16_t*>(dir)[i];
  return static_cast<const uint32_t*>(dir)[i];
}

// S generated from the (H, 32) direction matrix of dir_bytes-byte unsigned entries.
struct Generated {
  struct Args {
    const void* dir;
    int dir_bytes;
    long long skip;
  };
  struct Shared {
    uint32_t planes[HC][MAXM];
    int nbits[WARPS];
  };

  const Args a;
  Shared& sh;
  const uint32_t gray;
  uint32_t e[ROWS_PER_WARP];
  int nb = 0;

  __device__ Generated(const Args& args, Shared& s, int /*D*/, int col0)
      : a(args), sh(s), gray(gray_of(args.skip, col0 + static_cast<int>(threadIdx.x))) {}

  static __device__ __forceinline__ uint32_t gray_of(long long skip, int col) {
    const uint32_t idx = static_cast<uint32_t>(skip + col);  // modulo 2**32
    return idx ^ (idx >> 1);
  }

  // a warp loads whole direction rows, lane j holding entry j
  __device__ __forceinline__ void load(int h0, int hn) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int h = warp * ROWS_PER_WARP + r;
      e[r] = h < hn ? load_dir(a.dir, a.dir_bytes, static_cast<long long>(h0 + h) * 32 + lane) : 0u;
    }
  }

  // plane m of a row is one ballot.  Planes above the highest bit set in the chunk
  // are zero: they are neither built nor read, and the count of planes is uniform
  // over the block, so the compare loop has one trip count
  __device__ __forceinline__ void store(int /*h0*/, int /*hn*/) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    uint32_t any = 0;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) any |= e[r];
    const int nbw = 32 - __clz(__reduce_or_sync(0xffffffffu, any));  // __clz(0) == 32
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      uint32_t mine = 0;  // lane m keeps plane m
      for (int m = 0; m < nbw; ++m) {
        const uint32_t p = __ballot_sync(0xffffffffu, (e[r] >> m) & 1u);
        if (lane == m) mine = p;
      }
      sh.planes[warp * ROWS_PER_WARP + r][lane] = mine;
    }
    if (lane == 0) sh.nbits[warp] = nbw;
  }

  __device__ __forceinline__ void ready() {
    nb = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) nb = max(nb, sh.nbits[w]);
  }

  __device__ __forceinline__ int at(int h) const {
    uint32_t s = 0;
    // unrolled by 4: nvcc's default unroll of this runtime-count loop inside the
    // shared compare loop cost the encode kernel 25% (levels 16: nb = 4)
#pragma unroll 4
    for (int m = 0; m < nb; ++m) s |= static_cast<uint32_t>(__popc(sh.planes[h][m] & gray) & 1) << m;
    return static_cast<int>(s);  // the TPU kernel compares int32 bit patterns
  }
};

// cnt[b] = #{h : x[b0 + b, h] >= S[h, col]} for the BB rows of one sub-tile.
// Called by every thread of the block (it synchronises).
template <class Src>
__device__ __forceinline__ void count_tile(const int* __restrict__ x, Src& src, int B, int H,
                                           int b0, int (&cnt)[BB], int (*xs)[XS_PITCH]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int b = 0; b < BB; ++b) cnt[b] = 0;
  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hn = min(HC, H - h0);
    src.load(h0, hn);  // issued first, so their latency overlaps the x staging below
    __syncthreads();   // the previous chunk is consumed
    for (int t = tid; t < BB * HC; t += DT) {
      const int b = t / HC, h = t % HC;
      const int gb = b0 + b;
      xs[h][b] = (gb < B && h < hn) ? x[static_cast<long long>(gb) * H + h0 + h] : INT_MIN;
    }
    src.store(h0, hn);
    __syncthreads();
    src.ready();
    for (int h = 0; h < hn; ++h) {
      const int si = src.at(h);
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

template <class Src>
__global__ void __launch_bounds__(DT) encode_kernel(const int* __restrict__ x,
                                                    typename Src::Args args,
                                                    int* __restrict__ out, int B, int H, int D) {
  __shared__ __align__(16) int xs[HC][XS_PITCH];
  __shared__ typename Src::Shared sh;
  const int col0 = blockIdx.x * DT, col = col0 + threadIdx.x;
  const int b0 = blockIdx.y * BB;
  Src src(args, sh, D, col0);
  int cnt[BB];
  count_tile(x, src, B, H, b0, cnt, xs);
  if (col >= D) return;
#pragma unroll
  for (int b = 0; b < BB; ++b)
    if (b0 + b < B) out[static_cast<long long>(b0 + b) * D + col] = 2 * cnt[b] - H;
}

template <class Src>
__global__ void __launch_bounds__(DT) fit_kernel(const int* __restrict__ x,
                                                 typename Src::Args args,
                                                 const int* __restrict__ labels,
                                                 int* __restrict__ sums, int B, int H, int C,
                                                 int D, int acc_in_smem) {
  __shared__ __align__(16) int xs[HC][XS_PITCH];
  __shared__ typename Src::Shared sh;
  extern __shared__ int acc[];  // (C, DT), only when acc_in_smem
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * DT, col = col0 + tid;
  Src src(args, sh, D, col0);
  if (acc_in_smem)
    for (int c = 0; c < C; ++c) acc[c * DT + tid] = 0;  // each thread owns its column
  int cnt[BB];
  for (int sub = 0; sub < FIT_SUB; ++sub) {
    const int b0 = (blockIdx.y * FIT_SUB + sub) * BB;
    if (b0 >= B) break;  // uniform across the block
    count_tile(x, src, B, H, b0, cnt, xs);
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

template <class Src>
void launch_encode(const int* x, const typename Src::Args& args, int* out, int B, int H, int D,
                   void* stream) {
  if (B <= 0 || D <= 0) return;
  const dim3 grid((D + DT - 1) / DT, (B + BB - 1) / BB);
  encode_kernel<Src><<<grid, DT, 0, static_cast<cudaStream_t>(stream)>>>(x, args, out, B, H, D);
}

template <class Src>
void launch_fit(const int* x, const typename Src::Args& args, const int* labels, int* sums,
                int B, int H, int C, int D, void* stream) {
  if (B <= 0 || D <= 0 || C <= 0) return;
  const size_t acc_bytes = static_cast<size_t>(C) * DT * sizeof(int);
  const int in_smem = acc_bytes <= ACC_SMEM_BYTES;
  const dim3 grid((D + DT - 1) / DT, (B + BB * FIT_SUB - 1) / (BB * FIT_SUB));
  fit_kernel<Src><<<grid, DT, in_smem ? acc_bytes : 0, static_cast<cudaStream_t>(stream)>>>(
      x, args, labels, sums, B, H, C, D, in_smem);
}

// ---------------------------------------------------------------------------
// The histogram form of the table-free training step (uint8 direction entries).
// ---------------------------------------------------------------------------

constexpr int HIST_F = 4;             // features a histogram block counts
constexpr int HIST_THREADS = 256;
constexpr int T_MAX = 256;            // uint8 entries: thresholds lie in [0, 256)
constexpr int HIST_MAX_CP = 48;       // classes (rounded up to 4) the histogram form takes
constexpr int GATHER_SMEM_INTS = 12288;  // a 48 KB tile of G
constexpr int GATHER_MAX_F = 128;     // features a gather chunk holds at most
constexpr int PLANES = 8;             // bit planes of uint8 entries
constexpr int GATHER_BLOCKS = 4 * 132;   // blocks the gather grid aims at (4 an SM)

int hist_smem_bytes(int cp) { return HIST_F * (T_MAX + 1) * cp * static_cast<int>(sizeof(int)); }

__global__ void __launch_bounds__(HIST_THREADS) hist_kernel(
    const int* __restrict__ x, const uint8_t* __restrict__ dir, const int* __restrict__ labels,
    int* __restrict__ G, int* __restrict__ ncls, unsigned* __restrict__ dir_or, int B, int H,
    int C, int CP) {
  extern __shared__ int hs[];  // (HIST_F, T_MAX + 1, CP): bucket v at row v + 1, v in [-1, T)
  __shared__ int tbits[HIST_F];
  const int h0 = blockIdx.x * HIST_F, hn = min(HIST_F, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < HIST_F) {  // a warp reads one direction row, lane j entry j
    const uint32_t e = warp < hn ? dir[static_cast<long long>(h0 + warp) * 32 + lane] : 0u;
    const uint32_t any = __reduce_or_sync(0xffffffffu, e);
    if (lane == 0) {
      tbits[warp] = 32 - __clz(any);  // __clz(0) == 32: a zero row has T = 1
      if (any) atomicOr(dir_or, any);
    }
  }
  for (int i = threadIdx.x; i < HIST_F * (T_MAX + 1) * CP; i += HIST_THREADS) hs[i] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += HIST_THREADS) {
    const int lab = __ldg(labels + b);
    if (lab < 0 || lab >= C) continue;  // out-of-range labels count nowhere
    const int* xr = x + static_cast<long long>(b) * H + h0;
    for (int f = 0; f < hn; ++f) {
      const int v = min(max(__ldg(xr + f), -1), (1 << tbits[f]) - 1);
      atomicAdd(&hs[(f * (T_MAX + 1) + v + 1) * CP + lab], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hn * C; i += HIST_THREADS) {
    const int f = i / C, c = i % C;
    const int* cnt = hs + f * (T_MAX + 1) * CP + c;
    int* g = G + static_cast<long long>(h0 + f) * T_MAX * CP + c;
    int run = 0;
    for (int t = (1 << tbits[f]) - 1; t >= 0; --t) {
      run += cnt[(t + 1) * CP];
      g[t * CP] = run;
    }
    if (blockIdx.x == 0 && f == 0) ncls[c] = run + cnt[0];  // every bucket, -1 included
  }
}

template <int CMAX>
__global__ void __launch_bounds__(DT) gather_kernel(
    const uint8_t* __restrict__ dir, const int* __restrict__ G, const int* __restrict__ ncls,
    const unsigned* __restrict__ dir_or, int* __restrict__ sums, int H, int C, int CP, int D,
    int h_per_block, long long skip) {
  extern __shared__ int4 gs4[];  // a chunk of G: (features, T, CP)
  __shared__ uint32_t planes[GATHER_MAX_F][PLANES];
  const int* gs = reinterpret_cast<const int*>(gs4);
  const int col = blockIdx.x * DT + threadIdx.x;
  const int hb0 = blockIdx.y * h_per_block, hb1 = min(H, hb0 + h_per_block);
  const int nb = 32 - __clz(*dir_or);  // threshold bits any row uses, <= 8
  const int T = 1 << nb, row4 = T * CP / 4;  // int4 of one feature's G
  const int fchunk = min(GATHER_MAX_F, GATHER_SMEM_INTS / (T * CP));
  const uint32_t idx = static_cast<uint32_t>(skip + col);  // modulo 2**32
  const uint32_t gray = idx ^ (idx >> 1);
  int acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0;
  for (int f0 = hb0; f0 < hb1; f0 += fchunk) {
    const int fn = min(fchunk, hb1 - f0);
    __syncthreads();  // the previous chunk is consumed
    for (int f = threadIdx.x; f < fn; f += DT) {  // bit m of the 32 entries of a row
      const uint8_t* row = dir + static_cast<long long>(f0 + f) * 32;
      uint32_t p[PLANES] = {};
      for (int j = 0; j < 32; ++j) {
        const uint32_t e = row[j];
#pragma unroll
        for (int m = 0; m < PLANES; ++m) p[m] |= ((e >> m) & 1u) << j;
      }
#pragma unroll
      for (int m = 0; m < PLANES; ++m) planes[f][m] = p[m];
    }
    for (int i = threadIdx.x; i < fn * row4; i += DT) {
      const int f = i / row4;
      gs4[i] = __ldg(reinterpret_cast<const int4*>(G + static_cast<long long>(f0 + f) * T_MAX * CP) +
                     (i - f * row4));
    }
    __syncthreads();
    for (int f = 0; f < fn; ++f) {
      uint32_t s = 0;
#pragma unroll 4
      for (int m = 0; m < nb; ++m) s |= static_cast<uint32_t>(__popc(planes[f][m] & gray) & 1) << m;
      const int4* g = reinterpret_cast<const int4*>(gs + (f * T + static_cast<int>(s)) * CP);
#pragma unroll
      for (int q = 0; q < CMAX / 4; ++q) {
        if (4 * q < C) {  // uniform over the block
          const int4 v = g[q];
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      }
    }
  }
  if (col >= D) return;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c >= C) break;
    const int v = 2 * acc[c] - (blockIdx.y == 0 ? H * __ldg(ncls + c) : 0);
    atomicAdd(sums + static_cast<long long>(c) * D + col, v);
  }
}

template <int CMAX>
int launch_gather(const uint8_t* dir, const int* G, const int* ncls, const unsigned* dir_or,
                  int* sums, int H, int C, int CP, int D, long long skip, cudaStream_t s) {
  const int smem = GATHER_SMEM_INTS * static_cast<int>(sizeof(int));
  const cudaError_t attr = cudaFuncSetAttribute(
      gather_kernel<CMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // split H so the grid holds about GATHER_BLOCKS blocks, at least 8 features a block
  const int col_blocks = (D + DT - 1) / DT;
  int splits = (GATHER_BLOCKS + col_blocks - 1) / col_blocks;
  splits = max(1, min(splits, (H + 7) / 8));
  const int per = (H + splits - 1) / splits;
  splits = (H + per - 1) / per;
  gather_kernel<CMAX><<<dim3(col_blocks, splits), DT, smem, s>>>(dir, G, ncls, dir_or, sums, H,
                                                                 C, CP, D, per, skip);
  return static_cast<int>(cudaGetLastError());
}

int table_vec(const void* tab, int tab_bytes, int D) {
  return (static_cast<long long>(D) * tab_bytes) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(tab) % 16 == 0;
}

}  // namespace

extern "C" {

// x (B, H) int32; tab (H, D) row-major table of tab_bytes-byte signed entries (1: int8,
// 4: int32); out (B, D) int32.  Returns cudaGetLastError().
int uhd_encode_bundle(const int* x, const void* tab, int tab_bytes, int* out, int B, int H, int D,
                      void* stream) {
  const int vec = table_vec(tab, tab_bytes, D);
  if (tab_bytes == 1)
    launch_encode<Table<int8_t>>(x, {static_cast<const int8_t*>(tab), vec}, out, B, H, D, stream);
  else if (tab_bytes == 4)
    launch_encode<Table<int32_t>>(x, {static_cast<const int32_t*>(tab), vec}, out, B, H, D, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus labels (B,) int32; sums (C, D) int32, zeroed by the caller.
int uhd_fit_bundle(const int* x, const void* tab, int tab_bytes, const int* labels, int* sums,
                   int B, int H, int C, int D, void* stream) {
  const int vec = table_vec(tab, tab_bytes, D);
  if (tab_bytes == 1)
    launch_fit<Table<int8_t>>(x, {static_cast<const int8_t*>(tab), vec}, labels, sums, B, H, C, D,
                              stream);
  else if (tab_bytes == 4)
    launch_fit<Table<int32_t>>(x, {static_cast<const int32_t*>(tab), vec}, labels, sums, B, H, C,
                               D, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x (B, H) int32; dir (H, 32) unsigned entries of dir_bytes bytes; out (B, D) int32.
// Returns cudaGetLastError().
int uhd_encode_bundle_dynamic(const int* x, const void* dir, int dir_bytes, int* out,
                              int B, int H, int D, long long skip, void* stream) {
  launch_encode<Generated>(x, {dir, dir_bytes, skip}, out, B, H, D, stream);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus labels (B,) int32; sums (C, D) int32, zeroed by the caller.
int uhd_fit_bundle_dynamic(const int* x, const void* dir, int dir_bytes, const int* labels,
                           int* sums, int B, int H, int C, int D, long long skip,
                           void* stream) {
  launch_fit<Generated>(x, {dir, dir_bytes, skip}, labels, sums, B, H, C, D, stream);
  return static_cast<int>(cudaGetLastError());
}

// The histogram form of uhd_fit_bundle_dynamic, for a uint8 direction matrix and
// C <= HIST_MAX_CP classes: x (B, H) int32, dir (H, 32) uint8, labels (B,) int32,
// sums (C, D) int32 zeroed by the caller; scratch from the caller: G (H, 256, CP) int32
// with CP = C rounded up to 4 (written before it is read), ncls (C,) int32, dir_or one
// uint32 set to 0.  Two launches on `stream`.  Returns cudaGetLastError().
int uhd_fit_bundle_dynamic_hist(const int* x, const void* dir, const int* labels, int* sums,
                                int* G, int* ncls, unsigned* dir_or, int B, int H, int C, int D,
                                long long skip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int CP = (C + 3) / 4 * 4;
  if (C <= 0 || CP > HIST_MAX_CP) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());  // sums stay 0
  const int hsm = hist_smem_bytes(CP);
  const cudaError_t attr =
      cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hsm);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const uint8_t* d8 = static_cast<const uint8_t*>(dir);
  hist_kernel<<<(H + HIST_F - 1) / HIST_F, HIST_THREADS, hsm, s>>>(x, d8, labels, G, ncls, dir_or,
                                                                  B, H, C, CP);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (CP <= 16) return launch_gather<16>(d8, G, ncls, dir_or, sums, H, C, CP, D, skip, s);
  return launch_gather<HIST_MAX_CP>(d8, G, ncls, dir_or, sums, H, C, CP, D, skip, s);
}

}  // extern "C"
