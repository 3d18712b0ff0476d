// uHD encode and fused training step for Hopper (sm_90a), over a stored threshold
// table or over thresholds generated from Sobol direction numbers.
//
// Replaces four Pallas TPU kernels of src/repro/kernels/encode_bundle.py:
//   * encode_bundle_pallas (:55, body _encode_bundle_kernel :40)
//     -> uhd_encode_bundle: hv[b, d] = sum_h (2*[x[b,h] >= S[h,d]] - 1), S an (H, D) table
//   * encode_bundle_dynamic_pallas (:121, body _encode_bundle_dyn_kernel :88)
//     -> uhd_encode_bundle_dynamic: the same, S generated
//   * fit_bundle_pallas (:187, body _fit_bundle_kernel :170)
//     -> uhd_fit_bundle(_hist): sums[c, d] = sum over rows labelled c of hv[b, d], S a table
//   * fit_bundle_dynamic_pallas (:261, body _fit_bundle_dyn_kernel :224)
//     -> uhd_fit_bundle_dynamic(_hist): the same, S generated
// A generated S[h, d] is never stored: it is the quantized Sobol integer of point
// skip + d in dimension h, the XOR of the direction entries dir[h, j] selected by the
// set bits of gray(skip + d).  Plain versions: repro_torch/kernels/ref.py.
//
// What bounds the encodes: compare-and-count work on the CUDA cores, B*H*D compares
// (a compare and an add each, 2*B*H*D int32 operations, in the direct form; an add,
// shift, mask and accumulate a word of four rows, B*H*D, in the byte lanes below; no
// tensor-core form is exact and cheap for a >= compare).  The
// bytes are small: x (B, H) int32, the threshold source ((H, D) int8 or int32 table,
// or a (H, 32) direction matrix) and the output.
//
// Threshold sources hand a thread S[h, d] for its column d and the HC features of a
// staged chunk:
//   - Table: the block stages an (HC, DT) tile of the table in shared memory, in its
//     stored width, with the widest coalesced loads the row pitch and base allow (16
//     bytes; int8 rows also 8 or 4: at D = 2040 they take 8), issued before the x
//     staging; element loads where none divides (ragged int8 D, int32 rows not 16-byte
//     aligned: 4-byte loads, coalesced);
//   - Generated: each thread derives gray(skip + d) once and builds S[h, d] for each h
//     from bit planes: bit m of S[h, d] is the parity of (P[h][m] & gray), where P[h][m]
//     packs bit m of the 32 direction entries of row h.  A warp stages a row with one
//     ballot per plane, up to the highest bit set in the HC-row chunk, so a (h, d) costs
//     one popcount per plane the entries use.
//
// Both encodes (uhd_encode_bundle, uhd_encode_bundle_dynamic) run one kernel,
// encode_cluster_kernel, templated over the source.  A block covers 64 rows, so each
// S[h, d] is staged or generated once for all of them, and counts four rows in the
// bytes of one word (one add, shift and mask for four compares where the chunk's
// thresholds lie in [0, 127]).  It splits H over the blocks of a thread-block cluster,
// so B = 64 at D = 2048 still gives 256 blocks (512 at D = 8192).  Each split leaves
// its (64, DT) counts in shared memory; after a cluster barrier each block sums its
// share of the rows over the cluster's shared memory (distributed shared memory: no
// atomics, no memset, no second launch) and writes 2 * count - H once.
//
// The direct training step (fit_kernel over count_tile, one thread per output column,
// 32-row sub-tiles with register counters) takes the same sources.  It folds hv into
// a (C, DT) partial in shared memory, then adds it to sums with int32 atomicAdd
// (exact in any order).
//
// The training step over an int8 table or a uint8 direction matrix, with C <= 48
// classes (every configuration the launchers run), takes the class-histogram form,
// with the same integers:
//     sums[c, d] = sum_h (2 * G[c, h, S[h, d] - lo_h] - n_c),
//     G[c, h, j] = #{b : label b = c, x[b, h] >= lo_h + j},  n_c = #{b : label b = c},
// where every threshold of row h lies in [lo_h, hi_h], hi_h - lo_h < 256.  Its work is
// B*H histogram counts plus C*H*D gather-adds (and H*D threshold generations), none of
// which grows with B (the direct form is 2*B*H*D compares):
//   * hist_kernel: a block finds the range of HIST_F rows (generated: lo = 0 and hi =
//     2^(bits of the row's direction entries) - 1; table: the min and max of the row's
//     D entries, sign-extended), counts each row's x into per-class buckets of
//     clamp(x, lo_h - 1, hi_h), which compares as x >= S does for any int32 x, then
//     takes suffix sums over the buckets to G, stored (H, 256, CP) int32 (CP = C rounded
//     up to 4); labels outside [0, C) count nowhere; block 0 writes n_c.  Each block
//     raises `span` to the largest hi_h - lo_h + 1 (the G rows the gather stages), and
//     for a table writes lo_h;
//   * gather_kernel: one thread per output column, blocks split D and H (about 4 * 132
//     blocks at D = 2048 as at 8192); per chunk of features a block stages `span` rows
//     of G for every class and the features' thresholds (direction bit planes, or the
//     table's bytes of its columns), then each thread adds the C counts of row (h, S -
//     lo_h) into registers, and writes 2 * acc - H * n_c (the H * n_c term once, by the
//     first H-split) with int32 atomics, exact in any order.
// The wrapper allocates G, n_c, lo and span; the kernels allocate nothing.
// Ragged B, H and D are masked in the kernels: no padding, no correction.
// skip is a runtime argument, taken modulo 2**32 as the TPU kernel's uint32 index.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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
constexpr int FILL_BLOCKS = 4 * 132;      // blocks a split grid aims at (4 an SM)
constexpr int LANE_BITS = 7;   // thresholds of at most 7 bits ([0, 127]) take the byte lanes

// ---------------------------------------------------------------------------
// Threshold sources.  Per HC-feature chunk [h0, h0 + hn), count_tile calls
// load (before the barrier that frees the previous chunk's shared memory),
// store (after it), ready (after the barrier that publishes the chunk), then
// at(h) for each h < hn: S[h0 + h, this thread's column] as an int.  The encode
// ANDs lanes_ok() (every threshold of the chunk in [0, 127]) into that barrier.
// ---------------------------------------------------------------------------

// S read from a row-major (H, D) table of T (int8_t or int32_t).  A chunk's (HC, DT)
// tile is staged in shared memory in its stored width, with the widest loads the rows
// allow (Args::width, issued before the x staging): 16 bytes, else for int8 rows 8 or
// 4, else one element a load (ragged int8 D; an int32 element load is already a
// coalesced 4-byte load, and the int32 training step's registers rose with more forms).  lanes_ok() says whether
// every entry this thread staged lies in [0, 127] (the encode's byte lanes); the
// training step never asks, so its code computes none of it.
template <class T>
struct Table {
  struct Args {
    const T* tab;
    int width;  // bytes a load: 16, or for int8 8 or 4 (dividing D * sizeof(T) and the base), else 0
  };
  struct Shared {
    alignas(16) T ts[HC][DT];
  };
  static constexpr int SZ = static_cast<int>(sizeof(T));
  static constexpr int WORDS = HC * DT * SZ / 4 / DT;  // 32-bit words of the tile a thread stages
  static_assert(HC * DT * SZ % (16 * DT) == 0, "a chunk's loads split evenly over the block");

  const Args a;
  Shared& sh;
  const int D, col0;
  uint32_t v[WORDS];
  bool small = true;  // element loads: every entry this thread staged lies in [0, 127]

  __device__ Table(const Args& args, Shared& s, int d, int c0) : a(args), sh(s), D(d), col0(c0) {}

  // pieces of W bytes: piece q of the tile is row q / PPR, bytes (q % PPR) * W of it;
  // with W dividing the row pitch, a piece that starts inside a row ends inside it
  template <int W>
  __device__ __forceinline__ void load_w(int h0, int hn) {
    constexpr int PPR = DT * SZ / W, PER = WORDS * 4 / W, E = W / SZ;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = threadIdx.x + i * DT, r = q / PPR, e = col0 + (q % PPR) * E;
      const bool in = r < hn && e < D;
      const char* src = reinterpret_cast<const char*>(a.tab + static_cast<long long>(h0 + r) * D + e);
      if constexpr (W == 16) {
        const int4 t = in ? __ldg(reinterpret_cast<const int4*>(src)) : make_int4(0, 0, 0, 0);
        v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
      } else if constexpr (W == 8) {
        const uint2 t = in ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0, 0);
        v[2 * i] = t.x, v[2 * i + 1] = t.y;
      } else {
        v[i] = in ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
      }
    }
  }

  template <int W>
  __device__ __forceinline__ void store_w() {
    constexpr int PPR = DT * SZ / W, PER = WORDS * 4 / W;
    char* base = reinterpret_cast<char*>(&sh.ts[0][0]);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = threadIdx.x + i * DT;
      char* dst = base + (q / PPR) * (DT * SZ) + (q % PPR) * W;
      if constexpr (W == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      else if constexpr (W == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(v[2 * i], v[2 * i + 1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = v[i];
    }
  }

  __device__ __forceinline__ void load(int h0, int hn) {
    if (a.width == 16) return load_w<16>(h0, hn);  // uniform over the grid
    if constexpr (SZ == 1) {
      if (a.width == 8) return load_w<8>(h0, hn);
      if (a.width == 4) return load_w<4>(h0, hn);
    }
  }

  __device__ __forceinline__ void store(int h0, int hn) {
    if (a.width == 16) return store_w<16>();
    if constexpr (SZ == 1) {
      if (a.width == 8) return store_w<8>();
      if (a.width == 4) return store_w<4>();
    }
    const int col = col0 + threadIdx.x;
    bool ok = true;
    for (int r = 0; r < HC; ++r) {
      const T s = (r < hn && col < D) ? a.tab[static_cast<long long>(h0 + r) * D + col] : T(0);
      sh.ts[r][threadIdx.x] = s;
      ok &= s >= 0 && s <= 127;
    }
    small = ok;
  }

  __device__ __forceinline__ bool lanes_ok() const {
    if (!a.width) return small;
    uint32_t any = 0;  // the staged words (zero where out of range)
#pragma unroll
    for (int i = 0; i < WORDS; ++i) any |= v[i];
    return (any & (SZ == 1 ? 0x80808080u : 0xffffff80u)) == 0;
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
  int nbw = 0;  // bits this warp's staged rows use

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
    nbw = 32 - __clz(__reduce_or_sync(0xffffffffu, any));  // __clz(0) == 32
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

  // thresholds of at most LANE_BITS bits: every S[h, d] of the chunk lies in [0, 127]
  __device__ __forceinline__ bool lanes_ok() const { return nbw <= LANE_BITS; }

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
// The encode: 64 rows a block, H split over a thread-block cluster.
// ---------------------------------------------------------------------------

constexpr int ERB = 2 * BB;            // rows an encode block covers: 64
constexpr int EXS_PITCH = ERB + 4;     // keeps rows 16-byte aligned
constexpr int ENC_MAX_SPLIT = 16;      // cluster size along H (above 8: non-portable)
constexpr int ENC_MIN_FEATURES = 8;    // features an H split holds at least
constexpr int LANE_MAX_ADDS = 255;     // features a byte lane counts before its flush
constexpr int PART_BYTES = ERB * DT * static_cast<int>(sizeof(int));  // a split's counts

// Whether the block's counts go to dynamic shared memory: only where the static arrays
// would pass the 48 KB static limit (an int32 table's 16 KB tile).  Kept static
// otherwise: the dynamic form measured slower on the generated source.
template <class Src>
__host__ __device__ constexpr bool part_dynamic() {
  return sizeof(int) * (HC * EXS_PITCH + HC * ERB / 4) + sizeof(typename Src::Shared) +
             PART_BYTES > 48 * 1024;
}

// H splits of a launch: doubled while the grid stays within FILL_BLOCKS blocks.  A
// power of two, so it divides the ERB rows a block shares out in the reduction.
int encode_splits(int B, int H, int D) {
  const long long tiles = static_cast<long long>((D + DT - 1) / DT) * ((B + ERB - 1) / ERB);
  int splits = 1;
  while (splits < ENC_MAX_SPLIT && tiles * splits * 2 <= FILL_BLOCKS &&
         2 * splits * ENC_MIN_FEATURES <= H)
    splits *= 2;
  return splits;
}

// acc[q] holds the counts of rows 4q..4q+3 in its bytes; add them to the block's counts
__device__ __forceinline__ void flush_lanes(uint32_t (&acc)[ERB / 4], int (*part)[DT]) {
#pragma unroll
  for (int q = 0; q < ERB / 4; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) part[4 * q + j][threadIdx.x] += (acc[q] >> (8 * j)) & 0xffu;
    acc[q] = 0;
  }
}

// One body for both encodes, templated over the threshold source (Table<T> for
// uhd_encode_bundle, Generated for uhd_encode_bundle_dynamic).  The compare loop
// counts four rows in the bytes of one word.  Where every threshold of the chunk lies
// in [0, 127] (generated: at most LANE_BITS bits; table: checked on the staged tile,
// both decided for the whole block by the barrier's AND), x is staged as the byte
// clamp(x, -1, 127) + 1, which compares with any such s as x does, and one add of
// (127 - s) in each byte sets bit 7 exactly where x >= s: four compares in an add, a
// shift and a mask.  Other thresholds (negative or above 127) compare the int32 x row
// by row into the same bytes.  The bytes are flushed to int32 counts in shared memory
// before they could overflow.  The counts, (ERB, DT) int32, are static shared memory,
// or dynamic (PART_BYTES) where part_dynamic says so.
template <class Src>
__global__ void __launch_bounds__(DT) encode_cluster_kernel(const int* __restrict__ x,
                                                            typename Src::Args args,
                                                            int* __restrict__ out, int B, int H,
                                                            int D) {
  __shared__ __align__(16) int xs[HC][EXS_PITCH];       // x as int32
  __shared__ __align__(16) uint32_t xb[HC][ERB / 4];    // clamp(x, -1, 127) + 1, a byte a row
  __shared__ typename Src::Shared sh;
  int (*part)[DT];  // this split's counts, read by the whole cluster
  if constexpr (part_dynamic<Src>()) {
    extern __shared__ __align__(16) int part_smem[];
    part = reinterpret_cast<int (*)[DT]>(part_smem);
  } else {
    __shared__ __align__(16) int part_static[ERB][DT];
    part = part_static;
  }
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * DT, col = col0 + tid;
  const int b0 = blockIdx.z * ERB;
  const int splits = gridDim.y;  // the cluster spans gridDim.y
  const int per = (H + splits - 1) / splits;
  const int hb0 = min(H, static_cast<int>(blockIdx.y) * per), hb1 = min(H, hb0 + per);
  Src src(args, sh, D, col0);
#pragma unroll
  for (int b = 0; b < ERB; ++b) part[b][tid] = 0;  // each thread owns its column
  uint32_t acc[ERB / 4];
#pragma unroll
  for (int q = 0; q < ERB / 4; ++q) acc[q] = 0;
  int pending = 0;  // features counted in acc since its last flush
  for (int h0 = hb0; h0 < hb1; h0 += HC) {
    const int hn = min(HC, hb1 - h0);
    src.load(h0, hn);  // issued first, so their latency overlaps the x staging below
    __syncthreads();   // the previous chunk is consumed
    for (int t = tid; t < ERB * HC; t += DT) {
      const int b = t / HC, h = t % HC, gb = b0 + b;
      const int v = (gb < B && h < hn) ? x[static_cast<long long>(gb) * H + h0 + h] : INT_MIN;
      xs[h][b] = v;
      reinterpret_cast<uint8_t*>(xb[h])[b] = static_cast<uint8_t>(min(max(v, -1), 127) + 1);
    }
    src.store(h0, hn);
    const bool lanes = __syncthreads_and(src.lanes_ok());  // uniform over the block
    src.ready();
    if (pending + hn > LANE_MAX_ADDS) {
      flush_lanes(acc, part);
      pending = 0;
    }
    pending += hn;
    if (lanes) {
      for (int h = 0; h < hn; ++h) {
        const uint32_t k = static_cast<uint32_t>(127 - src.at(h)) * 0x01010101u;
        const uint4* xr = reinterpret_cast<const uint4*>(xb[h]);
#pragma unroll
        for (int q = 0; q < ERB / 16; ++q) {
          const uint4 v = xr[q];
          acc[4 * q + 0] += ((v.x + k) >> 7) & 0x01010101u;
          acc[4 * q + 1] += ((v.y + k) >> 7) & 0x01010101u;
          acc[4 * q + 2] += ((v.z + k) >> 7) & 0x01010101u;
          acc[4 * q + 3] += ((v.w + k) >> 7) & 0x01010101u;
        }
      }
    } else {
      for (int h = 0; h < hn; ++h) {
        const int si = src.at(h);
        const int4* xr = reinterpret_cast<const int4*>(xs[h]);
#pragma unroll
        for (int q = 0; q < ERB / 4; ++q) {
          const int4 v = xr[q];
          acc[q] += static_cast<uint32_t>(v.x >= si) | static_cast<uint32_t>(v.y >= si) << 8 |
                    static_cast<uint32_t>(v.z >= si) << 16 | static_cast<uint32_t>(v.w >= si) << 24;
        }
      }
    }
  }
  flush_lanes(acc, part);
  if (splits == 1) {  // uniform over the grid
    if (col >= D) return;
    for (int b = 0; b < ERB && b0 + b < B; ++b)
      out[static_cast<long long>(b0 + b) * D + col] = 2 * part[b][tid] - H;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's counts are in its shared memory
  const int rows = ERB / splits, r0 = static_cast<int>(cluster.block_rank()) * rows;
  for (int b = r0; b < r0 + rows; ++b) {
    int v[ENC_MAX_SPLIT];
#pragma unroll
    for (int k = 0; k < ENC_MAX_SPLIT; ++k)  // all of a row's loads in flight together
      v[k] = k < splits ? *cluster.map_shared_rank(&part[b][tid], k) : 0;
    int sum = 0;
#pragma unroll
    for (int k = 0; k < ENC_MAX_SPLIT; ++k) sum += v[k];
    if (col < D && b0 + b < B) out[static_cast<long long>(b0 + b) * D + col] = 2 * sum - H;
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <class Src>
int launch_encode(const int* x, const typename Src::Args& args, int* out, int B, int H, int D,
                  cudaStream_t s) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const int splits = encode_splits(B, H, D);
  const int dyn = part_dynamic<Src>() ? PART_BYTES : 0;
  cudaError_t attr = cudaSuccess;
  if (dyn)
    attr = cudaFuncSetAttribute(encode_cluster_kernel<Src>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (attr == cudaSuccess && splits > 8)
    attr = cudaFuncSetAttribute(encode_cluster_kernel<Src>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + DT - 1) / DT, splits, (B + ERB - 1) / ERB);
  cfg.blockDim = dim3(DT);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = 1;
  la[0].val.clusterDim.y = splits;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, encode_cluster_kernel<Src>, x, args, out, B, H, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The class-histogram form of the training step (int8 tables, uint8 directions).
// ---------------------------------------------------------------------------

constexpr int HIST_F = 4;             // features a histogram block counts
constexpr int HIST_THREADS = 256;
constexpr int T_MAX = 256;            // thresholds a feature's range holds at most
constexpr int HIST_MAX_CP = 48;       // classes (rounded up to 4) the histogram form takes
constexpr int GATHER_SMEM_INTS = 12288;  // a 48 KB tile of G
constexpr int PLANES = 8;             // bit planes of uint8 entries

int hist_smem_bytes(int cp) { return HIST_F * (T_MAX + 1) * cp * static_cast<int>(sizeof(int)); }

// Threshold sources of the histogram form.  In hist_kernel, range() (called by every
// thread of the block) writes [lo, hi] of the block's HIST_F rows to shared memory and
// publish() keeps what the gather needs of a row.  In gather_kernel, stage() brings a
// chunk's thresholds into shared memory (between the block's two barriers) and row(f)
// is this thread's G row, S[h, col] - lo_h, of the chunk's feature f.

// S generated from uint8 direction entries: row h's thresholds lie in [0, 2^bits), bits
// the highest set bit of its 32 entries, so lo_h = 0 and span = 2^nb, nb the bits any
// row uses.
__device__ __forceinline__ int log2_of(int pow2) { return 31 - __clz(pow2); }

struct DirSource {
  struct Args {
    const uint8_t* dir;
    long long skip;
  };
  static constexpr int MAX_F = 128;  // features a gather chunk holds at most
  static constexpr bool LO_IS_ZERO = true;
  struct Shared {
    uint32_t planes[MAX_F][PLANES];
  };

  static __device__ void range(const Args& a, int h0, int hn, int /*D*/, int* lo, int* hi) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp < HIST_F) {  // a warp reads one direction row, lane j entry j
      const uint32_t e = warp < hn ? a.dir[static_cast<long long>(h0 + warp) * 32 + lane] : 0u;
      const uint32_t any = __reduce_or_sync(0xffffffffu, e);
      if (lane == 0) {
        lo[warp] = 0;
        hi[warp] = (1 << (32 - __clz(any))) - 1;  // __clz(0) == 32: a zero row has T = 1
      }
    }
  }
  static __device__ void publish(const Args&, int /*h*/, int /*lo*/) {}

  const Args a;
  Shared& sh;
  const uint32_t gray;
  const int nb;

  __device__ DirSource(const Args& args, Shared& s, int span, int col)
      : a(args), sh(s), gray(Generated::gray_of(args.skip, col)), nb(log2_of(span)) {}

  __device__ __forceinline__ void stage(int f0, int fn, int /*col*/, int /*D*/) {
    for (int f = threadIdx.x; f < fn; f += DT) {  // bit m of the 32 entries of a row
      const uint8_t* row = a.dir + static_cast<long long>(f0 + f) * 32;
      uint32_t p[PLANES] = {};
      for (int j = 0; j < 32; ++j) {
        const uint32_t e = row[j];
#pragma unroll
        for (int m = 0; m < PLANES; ++m) p[m] |= ((e >> m) & 1u) << j;
      }
#pragma unroll
      for (int m = 0; m < PLANES; ++m) sh.planes[f][m] = p[m];
    }
  }

  __device__ __forceinline__ int row(int f) const {
    uint32_t s = 0;
#pragma unroll 4
    for (int m = 0; m < nb; ++m) s |= static_cast<uint32_t>(__popc(sh.planes[f][m] & gray) & 1) << m;
    return static_cast<int>(s);
  }
};

// S read from a row-major (H, D) int8 table: row h's range is the min and max of its D
// entries, sign-extended as the plain version compares them; lo_h goes to (H,) scratch.
struct TableSource {
  struct Args {
    const int8_t* tab;
    int* lo;  // (H,) int32, written by hist_kernel, read by gather_kernel
  };
  static constexpr int MAX_F = 64;
  static constexpr bool LO_IS_ZERO = false;
  struct Shared {
    int8_t ts[MAX_F][DT];  // the chunk's thresholds of the block's columns
    int lo[MAX_F];
  };

  static __device__ void range(const Args& a, int h0, int hn, int D, int* lo, int* hi) {
    if (threadIdx.x < HIST_F) {
      lo[threadIdx.x] = INT_MAX;
      hi[threadIdx.x] = INT_MIN;
    }
    __syncthreads();
    for (int f = 0; f < hn; ++f) {
      const int8_t* row = a.tab + static_cast<long long>(h0 + f) * D;
      int mn = INT_MAX, mx = INT_MIN;
      for (int d = threadIdx.x; d < D; d += HIST_THREADS) {
        const int v = __ldg(row + d);
        mn = min(mn, v);
        mx = max(mx, v);
      }
      mn = __reduce_min_sync(0xffffffffu, mn);
      mx = __reduce_max_sync(0xffffffffu, mx);
      if (threadIdx.x % 32 == 0) {
        atomicMin(&lo[f], mn);
        atomicMax(&hi[f], mx);
      }
    }
  }
  static __device__ void publish(const Args& a, int h, int lo) { a.lo[h] = lo; }

  const Args a;
  Shared& sh;

  __device__ TableSource(const Args& args, Shared& s, int /*span*/, int /*col*/) : a(args), sh(s) {}

  __device__ __forceinline__ void stage(int f0, int fn, int col, int D) {
    for (int f = threadIdx.x; f < fn; f += DT) sh.lo[f] = __ldg(a.lo + f0 + f);
    // each thread reads back only its own column; a column past D takes lo_h, G row 0
#pragma unroll 8
    for (int f = 0; f < fn; ++f)
      sh.ts[f][threadIdx.x] = col < D ? __ldg(a.tab + static_cast<long long>(f0 + f) * D + col)
                                      : static_cast<int8_t>(__ldg(a.lo + f0 + f));
  }

  __device__ __forceinline__ int row(int f) const {
    return static_cast<int>(sh.ts[f][threadIdx.x]) - sh.lo[f];
  }
};

template <class Src>
__global__ void __launch_bounds__(HIST_THREADS) hist_kernel(
    const int* __restrict__ x, typename Src::Args a, const int* __restrict__ labels,
    int* __restrict__ G, int* __restrict__ ncls, int* __restrict__ span, int B, int H, int C,
    int CP, int D) {
  extern __shared__ int hs[];  // (HIST_F, T_MAX + 1, CP): bucket v at row v - lo + 1
  __shared__ int lo[HIST_F], hi[HIST_F];
  const int h0 = blockIdx.x * HIST_F, hn = min(HIST_F, H - h0);
  Src::range(a, h0, hn, D, lo, hi);
  for (int i = threadIdx.x; i < HIST_F * (T_MAX + 1) * CP; i += HIST_THREADS) hs[i] = 0;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < hn) {
    atomicMax(span, hi[threadIdx.x] - lo[threadIdx.x] + 1);
    Src::publish(a, h0 + threadIdx.x, lo[threadIdx.x]);
  }
  for (int b = threadIdx.x; b < B; b += HIST_THREADS) {
    const int lab = __ldg(labels + b);
    if (lab < 0 || lab >= C) continue;  // out-of-range labels count nowhere
    const int* xr = x + static_cast<long long>(b) * H + h0;
    for (int f = 0; f < hn; ++f) {
      // with lo = 0 known at compile time the clamp takes a constant lower bound,
      // which measured faster on the H100 at large B
      const int v = Src::LO_IS_ZERO ? min(max(__ldg(xr + f), -1), hi[f]) + 1
                                    : min(max(__ldg(xr + f), lo[f] - 1), hi[f]) - lo[f] + 1;
      atomicAdd(&hs[(f * (T_MAX + 1) + v) * CP + lab], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hn * C; i += HIST_THREADS) {
    const int f = i / C, c = i % C;
    const int* cnt = hs + f * (T_MAX + 1) * CP + c;
    int* g = G + static_cast<long long>(h0 + f) * T_MAX * CP + c;
    int run = 0;
    for (int t = hi[f] - lo[f]; t >= 0; --t) {
      run += cnt[(t + 1) * CP];
      g[t * CP] = run;
    }
    if (blockIdx.x == 0 && f == 0) ncls[c] = run + cnt[0];  // every bucket, lo - 1 included
  }
}

template <class Src, int CMAX>
__global__ void __launch_bounds__(DT) gather_kernel(
    typename Src::Args a, const int* __restrict__ G, const int* __restrict__ ncls,
    const int* __restrict__ span, int* __restrict__ sums, int H, int C, int CP, int D,
    int h_per_block) {
  extern __shared__ int4 gs4[];  // a chunk of G: (features, span, CP)
  __shared__ typename Src::Shared sh;
  const int* gs = reinterpret_cast<const int*>(gs4);
  const int col = blockIdx.x * DT + threadIdx.x;
  const int hb0 = blockIdx.y * h_per_block, hb1 = min(H, hb0 + h_per_block);
  const int R = __ldg(span);  // G rows any feature uses, <= T_MAX
  const int row4 = R * CP / 4;  // int4 of one feature's G
  const int fchunk = min(Src::MAX_F, GATHER_SMEM_INTS / (R * CP));
  Src src(a, sh, R, col);
  int acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0;
  for (int f0 = hb0; f0 < hb1; f0 += fchunk) {
    const int fn = min(fchunk, hb1 - f0);
    __syncthreads();  // the previous chunk is consumed
    src.stage(f0, fn, col, D);
    for (int i = threadIdx.x; i < fn * row4; i += DT) {
      const int f = i / row4;
      gs4[i] = __ldg(reinterpret_cast<const int4*>(G + static_cast<long long>(f0 + f) * T_MAX * CP) +
                     (i - f * row4));
    }
    __syncthreads();
    for (int f = 0; f < fn; ++f) {
      const int4* g = reinterpret_cast<const int4*>(gs + (f * R + src.row(f)) * CP);
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

template <class Src, int CMAX>
int launch_gather(const typename Src::Args& a, const int* G, const int* ncls, const int* span,
                  int* sums, int H, int C, int CP, int D, cudaStream_t s) {
  const int smem = GATHER_SMEM_INTS * static_cast<int>(sizeof(int));
  const cudaError_t attr = cudaFuncSetAttribute(
      gather_kernel<Src, CMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // split H so the grid holds about FILL_BLOCKS blocks, at least 8 features a block
  const int col_blocks = (D + DT - 1) / DT;
  int splits = (FILL_BLOCKS + col_blocks - 1) / col_blocks;
  splits = max(1, min(splits, (H + 7) / 8));
  const int per = (H + splits - 1) / splits;
  splits = (H + per - 1) / per;
  gather_kernel<Src, CMAX><<<dim3(col_blocks, splits), DT, smem, s>>>(a, G, ncls, span, sums, H,
                                                                      C, CP, D, per);
  return static_cast<int>(cudaGetLastError());
}

// Both passes of the histogram form on `stream`: x (B, H) int32, labels (B,) int32, sums
// (C, D) int32 zeroed by the caller; scratch G (H, 256, CP) int32 (written before it is
// read), ncls (C,) int32, span one int32 set to 0.
template <class Src>
int launch_hist_form(const int* x, const typename Src::Args& a, const int* labels, int* sums,
                     int* G, int* ncls, int* span, int B, int H, int C, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int CP = (C + 3) / 4 * 4;
  if (C <= 0 || CP > HIST_MAX_CP) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());  // sums stay 0
  const int hsm = hist_smem_bytes(CP);
  const cudaError_t attr =
      cudaFuncSetAttribute(hist_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, hsm);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  hist_kernel<Src><<<(H + HIST_F - 1) / HIST_F, HIST_THREADS, hsm, s>>>(x, a, labels, G, ncls,
                                                                       span, B, H, C, CP, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (CP <= 16) return launch_gather<Src, 16>(a, G, ncls, span, sums, H, C, CP, D, s);
  return launch_gather<Src, HIST_MAX_CP>(a, G, ncls, span, sums, H, C, CP, D, s);
}

// The widest load Table<T> takes (16 bytes; for int8 also 8 or 4) that divides both a
// table row's pitch and the table's base address, or 0 (one element a load).
int table_width(const void* tab, int tab_bytes, int D) {
  const long long pitch = static_cast<long long>(D) * tab_bytes;
  const uintptr_t base = reinterpret_cast<uintptr_t>(tab);
  for (int w = 16; w >= (tab_bytes == 1 ? 4 : 16); w /= 2)
    if (pitch % w == 0 && base % w == 0) return w;
  return 0;
}

}  // namespace

extern "C" {

// x (B, H) int32; tab (H, D) row-major table of tab_bytes-byte signed entries (1: int8,
// 4: int32); out (B, D) int32.  Returns cudaGetLastError().
int uhd_encode_bundle(const int* x, const void* tab, int tab_bytes, int* out, int B, int H, int D,
                      void* stream) {
  const int width = table_width(tab, tab_bytes, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tab_bytes == 1)
    return launch_encode<Table<int8_t>>(x, {static_cast<const int8_t*>(tab), width}, out, B, H, D, s);
  if (tab_bytes == 4)
    return launch_encode<Table<int32_t>>(x, {static_cast<const int32_t*>(tab), width}, out, B, H, D,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, plus labels (B,) int32; sums (C, D) int32, zeroed by the caller.  The direct
// form: 2*B*H*D compares.
int uhd_fit_bundle(const int* x, const void* tab, int tab_bytes, const int* labels, int* sums,
                   int B, int H, int C, int D, void* stream) {
  const int width = table_width(tab, tab_bytes, D);
  if (tab_bytes == 1)
    launch_fit<Table<int8_t>>(x, {static_cast<const int8_t*>(tab), width}, labels, sums, B, H, C,
                              D, stream);
  else if (tab_bytes == 4)
    launch_fit<Table<int32_t>>(x, {static_cast<const int32_t*>(tab), width}, labels, sums, B, H,
                               C, D, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The class-histogram form of uhd_fit_bundle, for an int8 table and C <= HIST_MAX_CP
// classes: x (B, H) int32, tab (H, D) int8 row-major, labels (B,) int32, sums (C, D)
// int32 zeroed by the caller; scratch from the caller: G (H, 256, CP) int32 with CP = C
// rounded up to 4, ncls (C,) int32, lo (H,) int32, span one int32 set to 0.  Two
// launches on `stream`.  Returns cudaGetLastError().
int uhd_fit_bundle_hist(const int* x, const void* tab, const int* labels, int* sums, int* G,
                        int* ncls, int* lo, int* span, int B, int H, int C, int D, void* stream) {
  return launch_hist_form<TableSource>(x, {static_cast<const int8_t*>(tab), lo}, labels, sums, G,
                                       ncls, span, B, H, C, D, stream);
}

// x (B, H) int32; dir (H, 32) unsigned entries of dir_bytes bytes; out (B, D) int32.
// Returns cudaGetLastError().
int uhd_encode_bundle_dynamic(const int* x, const void* dir, int dir_bytes, int* out,
                              int B, int H, int D, long long skip, void* stream) {
  return launch_encode<Generated>(x, {dir, dir_bytes, skip}, out, B, H, D,
                                  static_cast<cudaStream_t>(stream));
}

// As above, plus labels (B,) int32; sums (C, D) int32, zeroed by the caller.
int uhd_fit_bundle_dynamic(const int* x, const void* dir, int dir_bytes, const int* labels,
                           int* sums, int B, int H, int C, int D, long long skip,
                           void* stream) {
  launch_fit<Generated>(x, {dir, dir_bytes, skip}, labels, sums, B, H, C, D, stream);
  return static_cast<int>(cudaGetLastError());
}

// The class-histogram form of uhd_fit_bundle_dynamic, for a uint8 direction matrix and
// C <= HIST_MAX_CP classes: x (B, H) int32, dir (H, 32) uint8, labels (B,) int32, sums
// (C, D) int32 zeroed by the caller; scratch from the caller: G (H, 256, CP) int32,
// ncls (C,) int32, span one int32 set to 0.  Two launches on `stream`.  Returns
// cudaGetLastError().
int uhd_fit_bundle_dynamic_hist(const int* x, const void* dir, const int* labels, int* sums,
                                int* G, int* ncls, int* span, int B, int H, int C, int D,
                                long long skip, void* stream) {
  return launch_hist_form<DirSource>(x, {static_cast<const uint8_t*>(dir), skip}, labels, sums,
                                     G, ncls, span, B, H, C, D, stream);
}

}  // extern "C"
