// ELL sparse matrix-vector products for NVIDIA Hopper.
//
// Replaces K3 of fenapack_tpu/ops/pallas_spmv.py: the Pallas body
// _spmv_kernel (:44), launched by _ell_spmv_pallas (:57, pallas_call :60)
// through PallasSpMV.__call__ (:101) and ell_spmv (:109).  Layout: the ELL
// arrays of fenapack_tpu/ops/sparse.py (ELL): vals and cols are (n_rows, K)
// row-major, cols int32; padding slots follow each row's entries and hold
// col 0 and val 0, so they add nothing.  Two products over that layout:
//
//   ell_spmv        y[i, q] = sum_k vals[i, k] * x[cols[i, k], q]
//                   x (n_cols, nrhs) row-major, nrhs in 1..8: one pass over
//                   the matrix serves every right-hand side;
//   ell_block_spmv  y[a, i] = sum_k A1[i, k] * x[a, c] + y0[a, i]
//                             + sum_b sum_k R[a, b, i, k] * x[b, c],
//                   c = cols[i, k], k < row_len[i], a, b < d, d in 1..3: the
//                   velocity block of a d-component field whose 1 + d*d
//                   operators share one column array (the Picard operator
//                   A1 on the diagonal, the Newton reaction blocks R, either
//                   of R and y0 may be absent).  x is (d, n_cols), y and y0
//                   are (d, n_rows); row_len (n_rows) int32 is each row's
//                   entry count, or absent (every row K long).  The
//                   reference composes this from d + d*d single products;
//                   here the columns and every value plane are read once.
//
// Bound: device memory.  A product must read the int32 column and the
// value of each of its planes for every entry once, gather x and write y;
// the operations (2 per entry and component) stay far below the FP64 peak.
//
// The single product.  At the fine level of the level-4 lid-driven cavity,
// (66049, 19) in f64, it moves 10.04 MB + 5.02 MB + ~1.06 MB = 16.1 MB
// (~4.8 us at 3.35 TB/s), padding included.  With one thread per row
// reading device memory directly, neighbouring threads load addresses K
// entries apart and a warp touches 32 cache lines per load; cold, that is
// latency bound (41% of the bound on the card).  Here a block works on
// tiles of R consecutive rows.  In this layout a tile is one contiguous
// stretch of R*K entries of cols and of vals, so the block copies those
// stretches into shared memory with 16-byte coalesced asynchronous copies
// (cp.async.cg), waits for them, and only then walks the rows.  The bytes
// in flight come from the copies of the blocks resident on an SM (four or
// more), not from the number of threads: while one block gathers, the
// others' copies are under way.  (A two- to four-stage ring inside each
// block, with fewer and larger blocks per SM, measured 10-80% slower on
// the card: the gathers of x, not the copies, need the resident threads.)
// A plane's stretch need not start on a 16-byte boundary (n_rows*K may be
// odd), so each plane is staged at the same offset from a 16-byte boundary
// as it has in device memory, its aligned body goes through 16-byte
// cp.async and the few ragged entries at either end through cp.async of
// one entry (a plain load there would stall its warp, and the block behind
// it, for a device-memory latency per plane).  Then each thread walks one
// row out of shared memory in slot order, accumulating in the scalar type:
// neighbouring threads read addresses K entries apart, which is free of
// bank conflicts for odd K (the cavity's operators have K = 19 and K = 7;
// an even K costs a gcd(K, 32)-way conflict on the column plane).  x is
// gathered through the read-only path, ten slots at a time before any of
// them is used, so that every thread keeps ten loads in flight: their
// latency, not the matrix stream, is what the walk waits for (batching
// them took the level-4 block product from 38.8 to 32.0 us on an H100).
// R is chosen per launch: the largest of 128, 64, 32 whose tile fits four
// times on an SM and which still leaves four tiles per SM (small operators
// take smaller tiles to reach every SM), and smaller again where a wide row
// would not fit at all; the grid is as many blocks as are resident at once,
// each walking an equal share of the tiles.
//
// The block product.  What it must move is its entries: at config 4's
// fine velocity level (242,913 rows of the tet P2 pattern, K = 85 slots
// for 27.8 entries on average) 92.6 MB without R (27.65 us at 3.35 TB/s)
// and 578.5 MB with the nine planes of R (172.70 us); with the padded
// slots it would be 259.4 MB and 1,746 MB.  The first design of this product (the
// single product's tiles, every value plane staged, the d lanes of a row
// exchanging their gathers by shuffles) read every padded slot, and with R
// a tile of whole 85-slot rows left one or two blocks on an SM; measured on
// the H100 it took 200.23 us without R and 987.28 us with R there (three
// and twelve cuSPARSE CSR products: 168.76 and 657.82 us), and on the
// cavity's 2D rows 29.14 us for the level-4 Newton operator (66,049 x 19,
// bound 17.11 us padded), 57.68 and 24.96 us for the cylinder's level 2
// with and without R, 5.85 us for config 5's stabilized A1.
//
// Now a row belongs to G lanes of one warp, and a lane loads U slots before it
// uses any.  Lane l reads slots l, l + G, ... below the row's length only: the
// G lanes read neighbouring addresses of the column plane and of each value
// plane, then gather x[b, c] for every component b of their own slots, and
// accumulate one partial sum per operator and output component in registers (d
// + d*d of them).  The geometry follows the row width K and R, one rule in the
// launcher: rows wider than 32 slots (the tet P2 rows, about 0.33 K entries)
// take G = 16 and U = 2, so that one batch of 32 slots covers a mean row, with
// streaming (evict-first) loads that leave x its place in L2; narrower rows
// (the triangle P2 rows, about 0.6 K of K = 19) take G = 8, U = 2 without R
// and, with R, U = 1 and loads through L1 (five or ten short planes a row: on
// the cylinder's and the cavity's Newton operators, in f32 and f64, that
// measured faster on the card than U = 2 with streaming loads).  A fixed
// xor-shuffle tree adds the G partial sums, so repeated runs give the same
// bits; lane a < d then adds A1's sum, y0 and the R[a, b] sums in the
// reference's order and writes y[a, row].  There is no shared memory: the rows
// in flight are set by registers alone (about 32 a thread without R, over 100
// with R at d = 3 in f64; chip_smoke.py's build phase prints them), 256 threads
// a block, one row per G threads; lanes past the last row take part in the
// shuffles with empty sums.  Rows given no length are read whole (the ring and
// GSPMD paths' raw column arrays).  Measured numbers: PERF.md, section 6.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRhs = 8;
constexpr int kMaxDim = 3;
constexpr int kSmemMax = 232448;           // 227 KB a block may use
constexpr int kSmemFourBlocks = 56 * 1024; // four blocks fit on one SM
constexpr int kRowsMax = 128;              // rows of the largest tile
constexpr int kTilesPerSm = 4;             // tiles per SM a large tile leaves

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// One entry of 4 or 8 bytes, for the ragged ends of a plane.
template <int BYTES>
__device__ __forceinline__ void cp_async_entry(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Entries of E in 16 bytes, and the capacity in entries of a staged plane of
// `count` entries: room for the offset from a 16-byte boundary, rounded up
// to whole 16 bytes.  Host and device agree on the layout through these.
template <typename E>
__host__ __device__ constexpr int per16() {
  return 16 / static_cast<int>(sizeof(E));
}

template <typename E>
__host__ __device__ inline int plane_capacity(int count) {
  return (count + 2 * per16<E>() - 1) / per16<E>() * per16<E>();
}

// Offset, in entries, of g from the 16-byte boundary below it.
template <typename E>
__device__ __forceinline__ int shift_of(const E* g) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(E));
}

// Copy `count` entries from g into the plane buffer s (16-byte aligned,
// plane_capacity entries): entry i lands at s[shift_of(g) + i].  The aligned
// body goes through 16-byte cp.async, the ragged entries at either end
// through cp.async of one entry each: nothing here waits for device memory
// (the caller commits the copies and waits for them).
template <typename E>
__device__ __forceinline__ void stage_plane(E* s, const E* g, int count) {
  constexpr int kPer = per16<E>();
  const int shift = shift_of(g);
  int head = (kPer - shift) % kPer;
  if (head > count) head = count;
  const int chunks = (count - head) / kPer;
  const int tail = head + chunks * kPer;
  E* dst = s + shift;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(dst + head + c * kPer, g + head + c * kPer);
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    cp_async_entry<sizeof(E)>(dst + i, g + i);
  for (int i = tail + threadIdx.x; i < count; i += blockDim.x)
    cp_async_entry<sizeof(E)>(dst + i, g + i);
}

// The staged tile in the block's dynamic shared memory `smem`: the column
// plane, then the value plane.
template <typename T>
struct Tile {
  int* cols;
  T* vals;
  __device__ Tile(unsigned char* smem, int rows, int K) {
    cols = reinterpret_cast<int*>(smem);
    vals = reinterpret_cast<T*>(smem + plane_capacity<int>(rows * K) *
                                           sizeof(int));
  }
};

// ---- the single product --------------------------------------------------

template <typename T, int NRHS>
__global__ void ell_spmv_kernel(const int* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n_rows, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = blockDim.x;
  const int n_tiles = (n_rows + R - 1) / R;

  Tile<T> st(smem, R, K);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * R;
    const long long off = static_cast<long long>(row0) * K;
    const int count = min(R, n_rows - row0) * K;
    stage_plane(st.cols, cols + off, count);
    stage_plane(st.vals, vals + off, count);
    cp_async_commit();
    cp_async_wait<0>();          // this thread's copies have landed,
    __syncthreads();             // and every other thread's

    const int row = row0 + threadIdx.x;
    if (row < n_rows) {
      const int* sc = st.cols + shift_of(cols + off) + threadIdx.x * K;
      const T* sv = st.vals + shift_of(vals + off) + threadIdx.x * K;
      T acc[NRHS];
#pragma unroll
      for (int q = 0; q < NRHS; ++q) acc[q] = T(0);
      // kBatch slots at a time: first all their gathers, then the sums, so
      // that a thread keeps kBatch * NRHS loads of x in flight
      constexpr int kBatch = NRHS == 1 ? 10 : (NRHS == 2 ? 5 : 2);
      for (int k0 = 0; k0 < K; k0 += kBatch) {
        T g[kBatch][NRHS];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int c = k0 + u < K ? sc[k0 + u] : 0;
          const T* xp = x + static_cast<long long>(c) * NRHS;
#pragma unroll
          for (int q = 0; q < NRHS; ++q) g[u][q] = __ldg(xp + q);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (k0 + u < K) {
            const T v = sv[k0 + u];
#pragma unroll
            for (int q = 0; q < NRHS; ++q) acc[q] += v * g[u][q];
          }
        }
      }
      T* yp = y + static_cast<long long>(row) * NRHS;
#pragma unroll
      for (int q = 0; q < NRHS; ++q) yp[q] = acc[q];
    }
    __syncthreads();             // the tile may be overwritten now
  }
}

// ---- the block product ---------------------------------------------------

// Threads of a block of the block product.
constexpr int kRowThreads = 256;

// A load of the matrix's columns and values: streaming (evict-first, so
// that x keeps its place in L2) or, with CACHED, through L1.
template <bool CACHED, typename E>
__device__ __forceinline__ E load_entry(const E* p) {
  return CACHED ? __ldg(p) : __ldcs(p);
}

// G lanes of one warp share a row (G a power of two up to 32).  Lane l
// reads the row's slots l, l + G, l + 2G, ... below its length, U of them
// at a time: first their columns and values (G neighbouring lanes on
// neighbouring addresses of each plane), then the gathers of x for every
// component, then the sums; every operator and output component keeps its
// own partial sum.  A fixed xor-shuffle tree adds the G lanes' partial
// sums (every lane ends with the same bits), and lane a < d adds the
// operators in the reference's order and writes y[a, row].
template <typename T, int D, bool HAS_R, int G, int U, bool CACHED>
__global__ void __launch_bounds__(kRowThreads)
    ell_block_spmv_kernel(const int* __restrict__ cols,
                          const T* __restrict__ A1, const T* __restrict__ Rv,
                          const T* __restrict__ x, const T* __restrict__ y0,
                          T* __restrict__ y, const int* __restrict__ row_len,
                          int n_rows, int K, int n_cols) {
  constexpr int P = HAS_R ? D * D : 1;    // reaction planes (1: unused)
  const int lane = threadIdx.x & (G - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x) / G;
  const bool has_row = row < n_rows;
  const int len =
      has_row ? (row_len != nullptr ? __ldg(row_len + row) : K) : 0;
  const long long base = row * K;
  const long long plane_len = static_cast<long long>(n_rows) * K;

  T acc_a[D];
  T acc_r[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    acc_a[a] = T(0);
#pragma unroll
    for (int b = 0; b < D; ++b) acc_r[a][b] = T(0);
  }
  for (int k0 = lane; k0 < len; k0 += G * U) {
    int c[U];
    T va[U];
    T vr[U][P];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * G;
      const bool ok = k < len;
      c[u] = ok ? load_entry<CACHED>(cols + base + k) : 0;
      va[u] = ok ? load_entry<CACHED>(A1 + base + k) : T(0);
      if (HAS_R) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          vr[u][p] =
              ok ? load_entry<CACHED>(Rv + p * plane_len + base + k) : T(0);
      }
    }
    T xs[U][D];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int b = 0; b < D; ++b)
        xs[u][b] = k0 + u * G < len
                       ? __ldg(x + static_cast<long long>(b) * n_cols + c[u])
                       : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * G < len) {
#pragma unroll
        for (int a = 0; a < D; ++a) acc_a[a] += va[u] * xs[u][a];
        if (HAS_R) {
#pragma unroll
          for (int a = 0; a < D; ++a)
#pragma unroll
            for (int b = 0; b < D; ++b)
              acc_r[a][b] += vr[u][HAS_R ? a * D + b : 0] * xs[u][b];
        }
      }
    }
  }
  // every lane of the warp gets here (rows past n_rows with length 0)
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      acc_a[a] += __shfl_xor_sync(0xffffffffu, acc_a[a], off);
      if (HAS_R) {
#pragma unroll
        for (int b = 0; b < D; ++b)
          acc_r[a][b] += __shfl_xor_sync(0xffffffffu, acc_r[a][b], off);
      }
    }
  }
  if (has_row && lane < D) {
    T sum = acc_a[0];
#pragma unroll
    for (int a = 1; a < D; ++a) sum = lane == a ? acc_a[a] : sum;
    const long long out = static_cast<long long>(lane) * n_rows + row;
    if (y0 != nullptr) sum += y0[out];
    if (HAS_R) {
#pragma unroll
      for (int b = 0; b < D; ++b) {
        T r = acc_r[0][b];
#pragma unroll
        for (int a = 1; a < D; ++a) r = lane == a ? acc_r[a][b] : r;
        sum += r;
      }
    }
    y[out] = sum;
  }
}

// ---- launch geometry ------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <typename T>
size_t tile_bytes(int rows, int K) {
  return plane_capacity<int>(rows * K) * sizeof(int) +
         plane_capacity<T>(rows * K) * sizeof(T);
}

struct Geometry {
  int rows;      // rows of a tile, 0 when no tile fits in shared memory
  int grid;      // blocks; each walks tiles blockIdx.x, + grid, ...
  size_t smem;   // dynamic shared memory of a block
};

// Tile height and grid of the single product: see the header.
template <typename T>
Geometry geometry(int n_rows, int K) {
  const int sms = sm_count();
  Geometry g{0, 0, 0};
  for (int rows = kRowsMax; rows >= 4; rows /= 2) {
    const size_t smem = tile_bytes<T>(rows, K);
    const int tiles = (n_rows + rows - 1) / rows;
    const bool roomy = smem <= kSmemFourBlocks && tiles >= kTilesPerSm * sms;
    if (rows > 32 ? !roomy : smem > kSmemMax) continue;
    int per_sm = static_cast<int>((kSmemMax + 1024) / (smem + 1024));
    per_sm = per_sm < 1 ? 1 : per_sm;
    const int by_threads = 2048 / rows;
    if (per_sm > by_threads) per_sm = by_threads < 1 ? 1 : by_threads;
    if (per_sm > 32) per_sm = 32;
    // as few tiles per block as the resident blocks allow, spread evenly
    const int per_block = (tiles + sms * per_sm - 1) / (sms * per_sm);
    g.rows = rows;
    g.grid = (tiles + per_block - 1) / per_block;
    g.smem = smem;
    break;
  }
  return g;
}

// Once per kernel instantiation (`ready` is its flag): allow dynamic shared
// memory above 48 KB, and ask for the largest shared-memory carve-out, so
// that as many blocks are resident on an SM as the geometry counts on.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool* ready) {
  if (*ready) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  *ready = rc == cudaSuccess;
  return rc;
}

template <typename T, int NRHS>
int launch(const int* cols, const T* vals, const T* x, T* y, int n_rows,
           int K, cudaStream_t stream) {
  const Geometry g = geometry<T>(n_rows, K);
  if (g.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ell_spmv_kernel<T, NRHS>;
  static bool ready = false;
  const cudaError_t rc = prepare(kernel, &ready);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<g.grid, g.rows, g.smem, stream>>>(cols, vals, x, y, n_rows, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* cols, const void* vals, const void* x, void* y,
             int n_rows, int K, int nrhs, void* stream) {
  if (n_rows < 0 || K < 1 || nrhs < 1 || nrhs > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nrhs) {
    case 1: return launch<T, 1>(c, v, xx, yy, n_rows, K, s);
    case 2: return launch<T, 2>(c, v, xx, yy, n_rows, K, s);
    case 3: return launch<T, 3>(c, v, xx, yy, n_rows, K, s);
    case 4: return launch<T, 4>(c, v, xx, yy, n_rows, K, s);
    case 5: return launch<T, 5>(c, v, xx, yy, n_rows, K, s);
    case 6: return launch<T, 6>(c, v, xx, yy, n_rows, K, s);
    case 7: return launch<T, 7>(c, v, xx, yy, n_rows, K, s);
    default: return launch<T, 8>(c, v, xx, yy, n_rows, K, s);
  }
}

template <typename T, int D, bool HAS_R, int G, int U, bool CACHED>
int launch_rows(const int* cols, const T* A1, const T* Rv, const T* x,
                const T* y0, T* y, const int* row_len, int n_rows, int K,
                int n_cols, cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_rows) * G;
  const int grid =
      static_cast<int>((threads + kRowThreads - 1) / kRowThreads);
  ell_block_spmv_kernel<T, D, HAS_R, G, U, CACHED>
      <<<grid, kRowThreads, 0, stream>>>(cols, A1, Rv, x, y0, y, row_len,
                                         n_rows, K, n_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool HAS_R>
int launch_block(const int* cols, const T* A1, const T* Rv, const T* x,
                 const T* y0, T* y, const int* row_len, int n_rows, int K,
                 int n_cols, cudaStream_t stream) {
  // the geometry from the row width and R: see the header
  if (K > 32)
    return launch_rows<T, D, HAS_R, 16, 2, false>(
        cols, A1, Rv, x, y0, y, row_len, n_rows, K, n_cols, stream);
  return launch_rows<T, D, HAS_R, 8, HAS_R ? 1 : 2, HAS_R>(
      cols, A1, Rv, x, y0, y, row_len, n_rows, K, n_cols, stream);
}

template <typename T>
int dispatch_block(const void* cols, const void* A1, const void* Rv,
                   const void* x, const void* y0, void* y,
                   const void* row_len, int n_rows, int K, int n_cols, int d,
                   void* stream) {
  if (n_rows < 0 || K < 1 || n_cols < 1 || d < 1 || d > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int* c = static_cast<const int*>(cols);
  const T* a = static_cast<const T*>(A1);
  const T* r = static_cast<const T*>(Rv);
  const T* xx = static_cast<const T*>(x);
  const T* yz = static_cast<const T*>(y0);
  T* yy = static_cast<T*>(y);
  const int* len = static_cast<const int*>(row_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FENAPACK_BLOCK(D)                                                    \
  case D:                                                                    \
    return r != nullptr                                                      \
               ? launch_block<T, D, true>(c, a, r, xx, yz, yy, len, n_rows,  \
                                          K, n_cols, s)                      \
               : launch_block<T, D, false>(c, a, r, xx, yz, yy, len, n_rows, \
                                           K, n_cols, s);
  switch (d) {
    FENAPACK_BLOCK(1)
    FENAPACK_BLOCK(2)
    default:
      FENAPACK_BLOCK(3)
  }
#undef FENAPACK_BLOCK
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the CUDA error
// code of its launch (cudaGetLastError() after it): 0 when the launch was
// accepted.  Rv, y0 and row_len may be null (no row_len: every row is K
// long).
extern "C" int ell_spmv_f32(const void* cols, const void* vals,
                            const void* x, void* y, int n_rows, int K,
                            int nrhs, void* stream) {
  return dispatch<float>(cols, vals, x, y, n_rows, K, nrhs, stream);
}

extern "C" int ell_spmv_f64(const void* cols, const void* vals,
                            const void* x, void* y, int n_rows, int K,
                            int nrhs, void* stream) {
  return dispatch<double>(cols, vals, x, y, n_rows, K, nrhs, stream);
}

extern "C" int ell_block_spmv_f32(const void* cols, const void* A1,
                                  const void* Rv, const void* x,
                                  const void* y0, void* y,
                                  const void* row_len, int n_rows, int K,
                                  int n_cols, int d, void* stream) {
  return dispatch_block<float>(cols, A1, Rv, x, y0, y, row_len, n_rows, K,
                               n_cols, d, stream);
}

extern "C" int ell_block_spmv_f64(const void* cols, const void* A1,
                                  const void* Rv, const void* x,
                                  const void* y0, void* y,
                                  const void* row_len, int n_rows, int K,
                                  int n_cols, int d, void* stream) {
  return dispatch_block<double>(cols, A1, Rv, x, y0, y, row_len, n_rows, K,
                                n_cols, d, stream);
}
