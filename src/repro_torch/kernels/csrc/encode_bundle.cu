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

}  // extern "C"
