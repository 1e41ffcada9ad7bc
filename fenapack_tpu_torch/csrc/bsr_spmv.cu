// Block-sparse-row (BSR) sparse matrix-vector product for NVIDIA Hopper.
//
// Replaces the two Pallas TPU kernels of fenapack_tpu/ops/pallas_spmv.py
// that run on the solver's main path:
//   * K1, DF32BlockSpMV.__call__ / _make_bsr_df32_kernel: y = A x for an f64
//     matrix, emulated on the TPU with three f32 tile planes and
//     compensated sums.  The H100 has native FP64, so K1 becomes the double
//     instantiation of this kernel (f64 tiles in, f64 y out).
//   * K2, PallasBSRSpMV.__call__ / _make_bsr_kernel(_accum): the f32
//     product behind every BlockELL.mv of the preconditioner.  It is the
//     float instantiation.
//
// Layout (fenapack_tpu/ops/sparse.py, BlockELL): block row I couples to
// block columns nbr[I, 0..m-1]; tiles are stored flat as
//   tiles[I, i, j*b + c] = A[I*b + i, nbr[I, j]*b + c],   shape (nb, b, m*b).
// Padding slots repeat a valid block id and hold zero tiles.  x is
// (n_cols, nrhs) row-major; columns >= n_cols read as zero, so the caller
// passes x unpadded.  y is (n_rows, nrhs) row-major; rows >= n_rows are not
// written.
//
// Bound: device memory.  Every tile entry is read once and used for nrhs
// multiply-adds, so the product streams nb*b*m*b scalars (97.6 MB for the
// f64 fine-level velocity operator of the 2D step at level 2, ~29 us at
// 3.35 TB/s) while x (<= 92 KB there) stays in L2.
//
// Design: one warp per output row r = I*b + i.  The lanes stride over the
// flat row k in [0, m*b): lane reads tiles[r, k] (consecutive lanes,
// consecutive addresses: coalesced) and x[nbr[I, k/b]*b + k%b] (for b = 32
// one warp step covers exactly one neighbour block: one coalesced 32-wide
// read of x).  Each lane accumulates in the scalar type, then the warp
// reduces by shuffles.  With nrhs > 1 one pass over the tiles serves all
// right-hand sides.  Shared-memory staging, TMA and tensor-core tiles are
// left for later work: the kernel is already a single stream over the tiles.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxRhs = 8;

template <typename T, int NRHS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bsr_spmv_kernel(const int* __restrict__ nbr, const T* __restrict__ tiles,
                const T* __restrict__ x, T* __restrict__ y, int b, int m,
                int n_rows, int n_cols) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // uniform across the warp
  const int mb = m * b;
  const int* nrow = nbr + static_cast<long long>(row / b) * m;
  const T* trow = tiles + static_cast<long long>(row) * mb;

  T acc[NRHS];
#pragma unroll
  for (int q = 0; q < NRHS; ++q) acc[q] = T(0);

  for (int k = lane; k < mb; k += 32) {
    const int j = k / b;
    const int col = nrow[j] * b + (k - j * b);
    const T t = trow[k];
    if (col < n_cols) {
      const T* xp = x + static_cast<long long>(col) * NRHS;
#pragma unroll
      for (int q = 0; q < NRHS; ++q) acc[q] += t * xp[q];
    }
  }
#pragma unroll
  for (int q = 0; q < NRHS; ++q) {
    T v = acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    acc[q] = v;
  }
  if (lane == 0) {
    T* yp = y + static_cast<long long>(row) * NRHS;
#pragma unroll
    for (int q = 0; q < NRHS; ++q) yp[q] = acc[q];
  }
}

template <typename T, int NRHS>
void launch(const int* nbr, const T* tiles, const T* x, T* y, int b, int m,
            int n_rows, int n_cols, cudaStream_t stream) {
  const int grid = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bsr_spmv_kernel<T, NRHS><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      nbr, tiles, x, y, b, m, n_rows, n_cols);
}

template <typename T>
int dispatch(const void* nbr, const void* tiles, const void* x, void* y,
             int b, int m, int n_rows, int n_cols, int nrhs, void* stream) {
  if (b <= 0 || m <= 0 || n_rows < 0 || n_cols < 0 || nrhs < 1 ||
      nrhs > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int* n = static_cast<const int*>(nbr);
  const T* t = static_cast<const T*>(tiles);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nrhs) {
    case 1: launch<T, 1>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
    case 2: launch<T, 2>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
    case 3: launch<T, 3>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
    case 4: launch<T, 4>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
    case 5: launch<T, 5>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
    case 6: launch<T, 6>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
    case 7: launch<T, 7>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
    default: launch<T, 8>(n, t, xx, yy, b, m, n_rows, n_cols, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the
// cudaGetLastError() code of its launch: 0 when the launch was accepted.
extern "C" int bsr_spmv_f32(const void* nbr, const void* tiles,
                            const void* x, void* y, int b, int m,
                            int n_rows, int n_cols, int nrhs, void* stream) {
  return dispatch<float>(nbr, tiles, x, y, b, m, n_rows, n_cols, nrhs,
                         stream);
}

extern "C" int bsr_spmv_f64(const void* nbr, const void* tiles,
                            const void* x, void* y, int b, int m,
                            int n_rows, int n_cols, int nrhs, void* stream) {
  return dispatch<double>(nbr, tiles, x, y, b, m, n_rows, n_cols, nrhs,
                          stream);
}
