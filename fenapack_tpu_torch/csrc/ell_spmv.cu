// ELL sparse matrix-vector products for NVIDIA Hopper.
//
// Replaces K3 of fenapack_tpu/ops/pallas_spmv.py: the Pallas body
// _spmv_kernel (:44), launched by _ell_spmv_pallas (:57, pallas_call :60)
// through PallasSpMV.__call__ (:101) and ell_spmv (:109).  Layout: the ELL
// arrays of fenapack_tpu/ops/sparse.py (ELL): vals and cols are (n_rows, K)
// row-major, cols int32; padding slots hold col 0 and val 0, so they add
// nothing.  Two products over that layout:
//
//   ell_spmv        y[i, q] = sum_k vals[i, k] * x[cols[i, k], q]
//                   x (n_cols, nrhs) row-major, nrhs in 1..8: one pass over
//                   the matrix serves every right-hand side;
//   ell_block_spmv  y[a, i] = sum_k A1[i, k] * x[a, c] + y0[a, i]
//                             + sum_b sum_k R[a, b, i, k] * x[b, c],
//                   c = cols[i, k], a, b < d, d in 1..3: the velocity block
//                   of a d-component field whose 1 + d*d operators share one
//                   column array (the Picard operator A1 on the diagonal,
//                   the Newton reaction blocks R, either of R and y0 may be
//                   absent).  x is (d, n_cols), y and y0 are (d, n_rows).
//                   The reference composes this from d + d*d single
//                   products; here the columns and every value plane are
//                   read once.
//
// Bound: device memory.  One product reads its value planes and the int32
// columns once, gathers x and writes y.  At the fine level of the level-4
// lid-driven cavity, (66049, 19) in f64, the single product moves 10.04 MB
// + 5.02 MB + ~1.06 MB = 16.1 MB (~4.8 us at 3.35 TB/s) and the Newton
// block product 5 x 10.04 MB + 5.02 MB + ~2.1 MB = 57.3 MB (~17.1 us),
// where six single products move 96.7 MB.  The operations (2 per slot and
// component) stay far below the FP64 peak.
//
// Design.  With one thread per row reading device memory directly,
// neighbouring threads load addresses K entries apart and a warp touches 32
// cache lines per load; cold, that is latency bound (41% of the bound on
// the card).  Here a block works on tiles of R consecutive rows.  In this
// layout a tile is one contiguous stretch of R*K entries of cols and of
// every value plane, so the block copies those stretches into shared memory
// with 16-byte coalesced asynchronous copies (cp.async.cg), waits for them,
// and only then walks the rows.  The bytes in flight come from the copies of
// the blocks resident on an SM (four or more), not from the number of
// threads: while one block gathers, the others' copies are under way.  (A
// two- to four-stage ring inside each block, with fewer and larger blocks
// per SM, measured 10-80% slower on the card: the gathers of x, not the
// copies, need the resident threads.)  A plane's stretch need not start on
// a 16-byte boundary (n_rows*K may be odd, and the planes of R follow each
// other without padding), so each plane is staged at the same offset from a
// 16-byte boundary as it has in device memory, its aligned body goes through
// 16-byte cp.async and the few ragged entries at either end through
// cp.async of one entry (a plain load there would stall its warp, and the
// block behind it, for a device-memory latency per plane).  Then each
// thread walks one row out of shared memory in slot order, accumulating in
// the scalar type: neighbouring threads read addresses K entries apart,
// which is free of bank conflicts for odd K (the cavity's operators have K
// = 19 and K = 7; an even K costs a gcd(K, 32)-way conflict on the column
// plane).  x is gathered through the read-only path, ten slots at a time
// before any of them is used, so that every thread keeps ten loads in
// flight: their latency, not the matrix stream, is what the walk waits for
// (batching them took the level-4 block product from 38.8 to 32.0 us on an
// H100).  In the block product the d lanes (a, r) of a
// row sit side by side in one warp: lane a gathers x[a, c] only and the
// lanes exchange their values by shuffles, so x is gathered once per slot
// and component; lane a owns y[a, row], every product of one operator is
// summed on its own, and the operators are added in the reference's order.
// R is chosen per launch: the largest of 128, 64, 32 whose tile fits four
// times on an SM and which still leaves four tiles per SM (small operators
// take smaller tiles to reach every SM), and smaller again where a wide row
// would not fit at all; the grid is as many blocks as are resident at once,
// each walking an equal share of the tiles.
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
// plane, then the value planes.
template <typename T>
struct Tile {
  int* cols;
  T* vals;
  int val_capacity;
  __device__ Tile(unsigned char* smem, int rows, int K) {
    const int ccap = plane_capacity<int>(rows * K);
    val_capacity = plane_capacity<T>(rows * K);
    cols = reinterpret_cast<int*>(smem);
    vals = reinterpret_cast<T*>(smem + ccap * sizeof(int));
  }
  __device__ T* plane(int p) const {
    return vals + static_cast<size_t>(p) * val_capacity;
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
    stage_plane(st.plane(0), vals + off, count);
    cp_async_commit();
    cp_async_wait<0>();          // this thread's copies have landed,
    __syncthreads();             // and every other thread's

    const int row = row0 + threadIdx.x;
    if (row < n_rows) {
      const int* sc = st.cols + shift_of(cols + off) + threadIdx.x * K;
      const T* sv = st.plane(0) + shift_of(vals + off) + threadIdx.x * K;
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

// Lanes that share one row of a tile: a power of two, so that they sit in
// one warp and exchange their gathers by shuffles (the fourth lane of a
// three-component row idles).
template <int D>
struct RowLanes {
  static constexpr int value = D == 3 ? 4 : D;
};

template <typename T, int D, bool HAS_R>
__global__ void ell_block_spmv_kernel(const int* __restrict__ cols,
                                      const T* __restrict__ A1,
                                      const T* __restrict__ Rv,
                                      const T* __restrict__ x,
                                      const T* __restrict__ y0,
                                      T* __restrict__ y, int n_rows, int K,
                                      int n_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = RowLanes<D>::value;
  const int R = blockDim.x / G;
  const int n_tiles = (n_rows + R - 1) / R;
  const long long plane_len = static_cast<long long>(n_rows) * K;

  const int r = threadIdx.x / G;   // row of the tile
  const int a = threadIdx.x % G;   // component (a >= D: the idle lane)
  const int ga = a < D ? a : 0;    // the component this lane gathers

  Tile<T> st(smem, R, K);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * R;
    const long long off = static_cast<long long>(row0) * K;
    const int count = min(R, n_rows - row0) * K;
    stage_plane(st.cols, cols + off, count);
    stage_plane(st.plane(0), A1 + off, count);
    if (HAS_R) {
#pragma unroll
      for (int p = 0; p < D * D; ++p)
        stage_plane(st.plane(1 + p), Rv + p * plane_len + off, count);
    }
    cp_async_commit();
    cp_async_wait<0>();          // this thread's copies have landed,
    __syncthreads();             // and every other thread's

    // Every lane runs the slot loop, since the lanes of a row exchange
    // their gathers; a lane without a row (ragged last tile) or without a
    // component gathers x[., 0] and adds nothing.
    const unsigned lanes = __activemask();
    const int row = row0 + r;
    const bool has_row = row < n_rows;
    const bool live = has_row && a < D;
    const int* sc = st.cols + shift_of(cols + off) + r * K;
    const T* sa = st.plane(0) + shift_of(A1 + off) + r * K;
    const T* sr[D];
#pragma unroll
    for (int b = 0; b < D; ++b) {
      const int p = HAS_R ? ga * D + b : 0;
      sr[b] = HAS_R ? st.plane(1 + p) +
                          shift_of(Rv + p * plane_len + off) + r * K
                    : sa;
    }
    T acc_a = T(0);
    T acc_r[D];
#pragma unroll
    for (int b = 0; b < D; ++b) acc_r[b] = T(0);
    // kBatch slots at a time: first all their gathers, then the sums, so
    // that a lane keeps kBatch loads of x in flight
    constexpr int kBatch = 10;
    const T* xg = x + static_cast<long long>(ga) * n_cols;
    for (int k0 = 0; k0 < K; k0 += kBatch) {
      T mine[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        mine[u] = __ldg(xg + (has_row && k0 + u < K ? sc[k0 + u] : 0));
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        T xs[D];
#pragma unroll
        for (int b = 0; b < D; ++b)
          xs[b] = D == 1 ? mine[u] : __shfl_sync(lanes, mine[u], b, G);
        if (live && k0 + u < K) {
          const int k = k0 + u;
          T xa = xs[0];
#pragma unroll
          for (int b = 1; b < D; ++b) xa = (a == b) ? xs[b] : xa;
          acc_a += sa[k] * xa;
          if (HAS_R) {
#pragma unroll
            for (int b = 0; b < D; ++b) acc_r[b] += sr[b][k] * xs[b];
          }
        }
      }
    }
    if (live) {
      const long long out = static_cast<long long>(a) * n_rows + row;
      T sum = acc_a;
      if (y0 != nullptr) sum += y0[out];
      if (HAS_R) {
#pragma unroll
        for (int b = 0; b < D; ++b) sum += acc_r[b];
      }
      y[out] = sum;
    }
    __syncthreads();             // the tile may be overwritten now
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
size_t tile_bytes(int rows, int K, int planes) {
  return plane_capacity<int>(rows * K) * sizeof(int) +
         static_cast<size_t>(planes) * plane_capacity<T>(rows * K) *
             sizeof(T);
}

struct Geometry {
  int rows;      // rows of a tile, 0 when no tile fits in shared memory
  int grid;      // blocks; each walks tiles blockIdx.x, + grid, ...
  size_t smem;   // dynamic shared memory of a block
};

// Tile height and grid: see the header.  `tpr` threads work on one row.
template <typename T>
Geometry geometry(int n_rows, int K, int planes, int tpr) {
  const int sms = sm_count();
  Geometry g{0, 0, 0};
  for (int rows = kRowsMax; rows >= 4; rows /= 2) {
    const size_t smem = tile_bytes<T>(rows, K, planes);
    const int tiles = (n_rows + rows - 1) / rows;
    const bool roomy = smem <= kSmemFourBlocks && tiles >= kTilesPerSm * sms;
    if (rows > 32 ? !roomy : smem > kSmemMax) continue;
    int per_sm = static_cast<int>((kSmemMax + 1024) / (smem + 1024));
    per_sm = per_sm < 1 ? 1 : per_sm;
    const int by_threads = 2048 / (rows * tpr);
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
  const Geometry g = geometry<T>(n_rows, K, 1, 1);
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

template <typename T, int D, bool HAS_R>
int launch_block(const int* cols, const T* A1, const T* Rv, const T* x,
                 const T* y0, T* y, int n_rows, int K, int n_cols,
                 cudaStream_t stream) {
  constexpr int G = RowLanes<D>::value;
  const Geometry g = geometry<T>(n_rows, K, HAS_R ? 1 + D * D : 1, G);
  if (g.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ell_block_spmv_kernel<T, D, HAS_R>;
  static bool ready = false;
  const cudaError_t rc = prepare(kernel, &ready);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<g.grid, g.rows * G, g.smem, stream>>>(cols, A1, Rv, x, y0, y,
                                                 n_rows, K, n_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_block(const void* cols, const void* A1, const void* Rv,
                   const void* x, const void* y0, void* y, int n_rows, int K,
                   int n_cols, int d, void* stream) {
  if (n_rows < 0 || K < 1 || n_cols < 1 || d < 1 || d > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int* c = static_cast<const int*>(cols);
  const T* a = static_cast<const T*>(A1);
  const T* r = static_cast<const T*>(Rv);
  const T* xx = static_cast<const T*>(x);
  const T* yz = static_cast<const T*>(y0);
  T* yy = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FENAPACK_BLOCK(D)                                                    \
  case D:                                                                    \
    return r != nullptr                                                      \
               ? launch_block<T, D, true>(c, a, r, xx, yz, yy, n_rows, K,    \
                                          n_cols, s)                         \
               : launch_block<T, D, false>(c, a, r, xx, yz, yy, n_rows, K,   \
                                           n_cols, s);
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
// accepted.  Rv and y0 may be null.
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
                                  const void* y0, void* y, int n_rows, int K,
                                  int n_cols, int d, void* stream) {
  return dispatch_block<float>(cols, A1, Rv, x, y0, y, n_rows, K, n_cols, d,
                               stream);
}

extern "C" int ell_block_spmv_f64(const void* cols, const void* A1,
                                  const void* Rv, const void* x,
                                  const void* y0, void* y, int n_rows, int K,
                                  int n_cols, int d, void* stream) {
  return dispatch_block<double>(cols, A1, Rv, x, y0, y, n_rows, K, n_cols, d,
                                stream);
}
