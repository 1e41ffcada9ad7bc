// ELL sparse matrix-vector product for NVIDIA Hopper.
//
// Replaces K3 of fenapack_tpu/ops/pallas_spmv.py: the Pallas body
// _spmv_kernel (:44), launched by _ell_spmv_pallas (:57, pallas_call :60)
// through PallasSpMV.__call__ (:101) and ell_spmv (:109).  It computes
//   y[i, q] = sum_k vals[i, k] * x[cols[i, k], q]
// for the ELL layout of fenapack_tpu/ops/sparse.py (ELL): vals and cols are
// (n_rows, K) row-major, cols int32; padding slots hold col 0 and val 0, so
// they add nothing.  x is (n_cols, nrhs) row-major, y is (n_rows, nrhs),
// nrhs in 1..8: one pass over the matrix serves every right-hand side.
//
// Bound: device memory.  One apply reads n*K values and n*K int32 columns
// once, gathers x and writes y: for the f64 fine velocity operator of the
// level-4 lid-driven cavity, (66049, 19), that is 10.04 MB + 5.02 MB +
// ~1.06 MB = 16.1 MB, ~4.8 us at 3.35 TB/s.  The whole operator fits in the
// 50 MB L2, so back-to-back applies can beat that bound.
//
// Design: one thread per row, reading its K slots in order and accumulating
// in the scalar type.  A warp covers 32 consecutive rows, a contiguous
// 32*K-entry stretch of vals and cols, so the cache lines that one slot's
// load brings in serve the row's next slots from L1.  The TPU kernel held x
// whole in VMEM; here the gather of x goes through L1/L2 (x is at most a
// few MB).  Blocks of 128 threads keep enough blocks in flight to fill the
// 132 SMs at the cavity's row counts.  Slot-major or shared-memory-staged
// layouts, which make every load coalesced, are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRhs = 8;

template <typename T, int NRHS>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int n_rows,
                int K) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const long long base = static_cast<long long>(row) * K;

  T acc[NRHS];
#pragma unroll
  for (int q = 0; q < NRHS; ++q) acc[q] = T(0);

  for (int k = 0; k < K; ++k) {
    const T v = vals[base + k];
    const T* xp = x + static_cast<long long>(cols[base + k]) * NRHS;
#pragma unroll
    for (int q = 0; q < NRHS; ++q) acc[q] += v * xp[q];
  }
  T* yp = y + static_cast<long long>(row) * NRHS;
#pragma unroll
  for (int q = 0; q < NRHS; ++q) yp[q] = acc[q];
}

template <typename T, int NRHS>
void launch(const int* cols, const T* vals, const T* x, T* y, int n_rows,
            int K, cudaStream_t stream) {
  const int grid = (n_rows + kThreads - 1) / kThreads;
  ell_spmv_kernel<T, NRHS><<<grid, kThreads, 0, stream>>>(cols, vals, x, y,
                                                          n_rows, K);
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
    case 1: launch<T, 1>(c, v, xx, yy, n_rows, K, s); break;
    case 2: launch<T, 2>(c, v, xx, yy, n_rows, K, s); break;
    case 3: launch<T, 3>(c, v, xx, yy, n_rows, K, s); break;
    case 4: launch<T, 4>(c, v, xx, yy, n_rows, K, s); break;
    case 5: launch<T, 5>(c, v, xx, yy, n_rows, K, s); break;
    case 6: launch<T, 6>(c, v, xx, yy, n_rows, K, s); break;
    case 7: launch<T, 7>(c, v, xx, yy, n_rows, K, s); break;
    default: launch<T, 8>(c, v, xx, yy, n_rows, K, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the
// cudaGetLastError() code of its launch: 0 when the launch was accepted.
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
