// Block-sparse-row (BSR) sparse matrix-vector product for NVIDIA Hopper,
// on packed block-row slices.
//
// Replaces the two Pallas TPU kernels of fenapack_tpu/ops/pallas_spmv.py
// that run on the solver's main path:
//   * K1, DF32BlockSpMV.__call__ / _make_bsr_df32_kernel: y = A x for an f64
//     matrix, emulated on the TPU with three f32 tile planes and
//     compensated sums.  The H100 has native FP64, so K1 becomes the double
//     instantiation of this kernel (f64 values in, f64 y out).
//   * K2, PallasBSRSpMV.__call__ / _make_bsr_kernel(_accum): the f32
//     product behind every BlockELL.mv of the preconditioner.  It is the
//     float instantiation.
//
// Layout (fenapack_tpu_torch/ops/bsr_spmv.py): rows in block rows of b
// (<= 32); block row I couples to block columns nbr[I, 0..m-1] as in the
// TPU kernels' layout, but instead of dense b x b tiles it stores one slice
// of L steps x b lanes of the pattern's own entries:
//   vals[I, q, i] = the q-th entry of row I*b + i            (nb, L, b)
// and one int32 index row per block row (W words): the neighbours at
// [0, m), the header idx[I, S-1] = m << 16 | steps (the block row's longest
// row), and from word S (a multiple of 16: 64 B aligned) the 16-bit slot
// ids, slot (q, i) at half-word q*b + i: k = j*32 + c for column
// nbr[I, k >> 5]*b + (k & 31), kNoSlot for padding (value 0, not read
// against x).  x is (n_cols, nrhs) row-major; y (n_rows, nrhs) row-major.
//
// Bound: device memory.  A product streams b * sum(steps) slots of
// (value + 2 B id), each block row's neighbour words and its x blocks (from
// L2), x once and y once: about nnz * padding * (value + 2 B) plus the
// vectors, with padding the slots per nonzero (1.0-2.1 on the step's
// patterns in RCM order, against 15-40 in the dense 32 x 32 tiles that the
// TPU kernels stream).  For the f32 fine velocity operator of the 2D step
// at level 4 that is ~22 MB, 6.7 us at 3.35 TB/s (dense tiles: 225 MB).
//
// Design: one warp per block row, one lane per row.  The warp first copies
// x over its block row's m neighbour blocks into shared memory (m
// coalesced 32-value loads; slot id k is then the offset sx[k]); each
// lane then walks its row's slots in batches of 8 steps: the batch's ids
// and values (per step one coalesced 128 B / 256 B value load and one 64 B
// id load for the warp), then x from shared memory.  The first batch is
// loaded before the header and the copy, which it does not depend on.  A
// lane keeps its row's nrhs sums in registers from the first step to the
// last: no shuffle reduction, and the sums of a row run in the row's entry
// order.  A warp takes its block row's steps (its longest row), not L;
// padding slots read no x.  Where the copy would not fit in 48 KB of
// shared memory for a block (wide neighbour lists, many right-hand sides)
// a step reads the neighbour's block column and x through L1 instead:
// the same sums, one L1 sector per lane.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxRhs = 8;
constexpr unsigned kNoSlot = 0xFFFFu;
constexpr int kAlign = 16;

// dynamic shared memory a block may take without an opt-in
constexpr int kMaxShared = 48 * 1024;

// kStage: x over the block row's neighbour blocks is copied to shared
// memory first (see the design note above).
template <typename T, int NRHS, bool kStage>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bsr_spmv_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int b, int L,
                int W, int n_rows, int n_cols) {
  // steps a lane loads at once, the loads of a batch independent
  constexpr int U = NRHS <= 2 ? 8 : 4;
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int blk = blockIdx.x * kWarpsPerBlock + warp;
  const int lane = threadIdx.x & 31;
  const int row = blk * b + lane;
  if (blk * b >= n_rows) return;  // uniform across the warp
  const bool active = lane < b && row < n_rows;
  const int* irow = idx + static_cast<long long>(blk) * W;
  const int S = W - (L * b + 1) / 2;
  const unsigned short* kid =
      reinterpret_cast<const unsigned short*>(irow + S) + lane;
  const T* v = vals + static_cast<long long>(blk) * L * b + lane;
  T* sx = reinterpret_cast<T*>(smem) +
          static_cast<long long>(warp) * (S - 1) * 32 * NRHS;

  T acc[NRHS];
#pragma unroll
  for (int r = 0; r < NRHS; ++r) acc[r] = T(0);

  // the first batch reads below L without waiting for the header (slots
  // past a block row's steps are padding); later ones below its steps
  const int head = __ldg(irow + S - 1);
  const int steps = head & 0xFFFF;
  int lim = L < U ? L : U;
  for (int q0 = 0; q0 < lim; q0 += U, lim = steps) {
    unsigned k[U];
    T t[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = active && q0 + u < lim;
      k[u] = in ? __ldg(kid + (q0 + u) * b) : kNoSlot;
      t[u] = in ? __ldg(v + (q0 + u) * b) : T(0);
    }
    if (kStage && q0 == 0) {
      const int m = head >> 16;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const int col = __ldg(irow + j) * b + lane;
        const bool in = lane < b && col < n_cols;
#pragma unroll
        for (int r = 0; r < NRHS; ++r)
          sx[(j * 32 + lane) * NRHS + r] =
              in ? __ldg(x + static_cast<long long>(col) * NRHS + r) : T(0);
      }
      __syncwarp();
    }
    T xv[U][NRHS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool real = k[u] != kNoSlot;
      if (kStage) {
        const int o = (real ? static_cast<int>(k[u]) : 0) * NRHS;
#pragma unroll
        for (int r = 0; r < NRHS; ++r) xv[u][r] = real ? sx[o + r] : T(0);
      } else {
        const int col =
            real ? __ldg(irow + (k[u] >> 5)) * b + static_cast<int>(k[u] & 31u)
                 : n_cols;
        const T* xp = x + static_cast<long long>(col) * NRHS;
#pragma unroll
        for (int r = 0; r < NRHS; ++r)
          xv[u][r] = col < n_cols ? __ldg(xp + r) : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < NRHS; ++r) acc[r] += t[u] * xv[u][r];
  }
  if (active) {
    T* yp = y + static_cast<long long>(row) * NRHS;
#pragma unroll
    for (int r = 0; r < NRHS; ++r) yp[r] = acc[r];
  }
}

template <typename T, int NRHS>
void launch(const int* idx, const T* vals, const T* x, T* y, int b, int L,
            int W, int n_rows, int n_cols, cudaStream_t stream) {
  const int nb = (n_rows + b - 1) / b;
  const int grid = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int S = W - (L * b + 1) / 2;
  const long long shared =
      static_cast<long long>(kWarpsPerBlock) * (S - 1) * 32 * NRHS * sizeof(T);
  if (shared <= kMaxShared)
    bsr_spmv_kernel<T, NRHS, true>
        <<<grid, kWarpsPerBlock * 32, shared, stream>>>(idx, vals, x, y, b, L,
                                                        W, n_rows, n_cols);
  else
    bsr_spmv_kernel<T, NRHS, false><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        idx, vals, x, y, b, L, W, n_rows, n_cols);
}

template <typename T>
int dispatch(const void* idx, const void* vals, const void* x, void* y,
             int b, int L, int W, int n_rows, int n_cols, int nrhs,
             void* stream) {
  if (b <= 0 || b > 32 || L <= 0 || n_rows < 0 || n_cols < 0 || nrhs < 1 ||
      nrhs > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = W - (L * b + 1) / 2;
  if (S < kAlign || S % kAlign != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int* n = static_cast<const int*>(idx);
  const T* t = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nrhs) {
    case 1: launch<T, 1>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
    case 2: launch<T, 2>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
    case 3: launch<T, 3>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
    case 4: launch<T, 4>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
    case 5: launch<T, 5>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
    case 6: launch<T, 6>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
    case 7: launch<T, 7>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
    default: launch<T, 8>(n, t, xx, yy, b, L, W, n_rows, n_cols, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the
// cudaGetLastError() code of its launch: 0 when the launch was accepted.
extern "C" int bsr_spmv_f32(const void* idx, const void* vals,
                            const void* x, void* y, int b, int L, int W,
                            int n_rows, int n_cols, int nrhs, void* stream) {
  return dispatch<float>(idx, vals, x, y, b, L, W, n_rows, n_cols, nrhs,
                         stream);
}

extern "C" int bsr_spmv_f64(const void* idx, const void* vals,
                            const void* x, void* y, int b, int L, int W,
                            int n_rows, int n_cols, int nrhs, void* stream) {
  return dispatch<double>(idx, vals, x, y, b, L, W, n_rows, n_cols, nrhs,
                          stream);
}
