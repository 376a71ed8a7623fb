// Batched small-matrix LU solve (paper §5.1.3), written by hand for Hopper
// (sm_90a): W x = b for N independent systems with partial pivoting, and
// each system's least |pivot|.
//
// Replaces the TPU kernel `lu_solve_pallas` of
// src/repro/kernels/lu/kernel.py (:115, pallas_call at :133, body
// `lu_solve_lanes` via `build_lu_kernel`), which lays the systems out as
// vector lanes of a VMEM tile.  Here each system is one thread: it loads
// its W (n, n) and b (n) from the lane-major (n, n, N) / (n, N) inputs
// (adjacent threads read adjacent addresses, so every load and store
// coalesces), keeps the matrix in registers, factors and solves it with
// the shared body of lu_lanes.cuh, and writes x (n, N) and pivmin (N,).
//
// What bounds it on an H100: bytes.  A system reads n² + n words and writes
// n + 1 for about n³/3 + n² multiply-adds, well under one operation per
// byte at n <= 8, so the kernel can do no better than stream its inputs
// once at the HBM rate; the design keeps every intermediate in registers
// and reads each input exactly once.  Instantiated for n = 1..8, float and
// double, with and without pivoting.

#include <cuda_runtime.h>

#include "lu_lanes.cuh"

namespace repro_lu {

constexpr int kBlock = 128;

template <typename T, int n, bool Pivot>
__global__ void __launch_bounds__(kBlock)
    lu_solve_kernel(const T* __restrict__ W, const T* __restrict__ b, int N,
                    T* __restrict__ x, T* __restrict__ pivmin) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t NN = static_cast<size_t>(N);
  LuFactors<T, n> f;
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) f.r[i][j] = W[(i * n + j) * NN + lane];
  T v[n];
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = b[i * NN + lane];
  lu_factor<T, n, Pivot>(f);
  lu_resolve<T, n, Pivot>(f, v);
#pragma unroll
  for (int i = 0; i < n; ++i) x[i * NN + lane] = v[i];
  pivmin[lane] = f.pivmin;
}

template <typename T, int n>
int launch(int pivot, const void* W, const void* b, int N, void* x,
           void* pivmin, cudaStream_t stream) {
  const int grid = (N + kBlock - 1) / kBlock;
  if (pivot)
    lu_solve_kernel<T, n, true><<<grid, kBlock, 0, stream>>>(
        static_cast<const T*>(W), static_cast<const T*>(b), N,
        static_cast<T*>(x), static_cast<T*>(pivmin));
  else
    lu_solve_kernel<T, n, false><<<grid, kBlock, 0, stream>>>(
        static_cast<const T*>(W), static_cast<const T*>(b), N,
        static_cast<T*>(x), static_cast<T*>(pivmin));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_n(int n, int pivot, const void* W, const void* b, int N, void* x,
         void* pivmin, cudaStream_t s) {
  switch (n) {
    case 1: return launch<T, 1>(pivot, W, b, N, x, pivmin, s);
    case 2: return launch<T, 2>(pivot, W, b, N, x, pivmin, s);
    case 3: return launch<T, 3>(pivot, W, b, N, x, pivmin, s);
    case 4: return launch<T, 4>(pivot, W, b, N, x, pivmin, s);
    case 5: return launch<T, 5>(pivot, W, b, N, x, pivmin, s);
    case 6: return launch<T, 6>(pivot, W, b, N, x, pivmin, s);
    case 7: return launch<T, 7>(pivot, W, b, N, x, pivmin, s);
    case 8: return launch<T, 8>(pivot, W, b, N, x, pivmin, s);
  }
  return -1;
}

}  // namespace repro_lu

// C interface, bound with ctypes by src/repro_torch/kernels/lu/kernel.py.
// dtype_id: 0 float32, 1 float64.  n: 1..8.  W (n, n, N) and b (n, N)
// lane-major; writes x (n, N) and pivmin (N,).  Returns cudaGetLastError()
// after the launch, or -1 for an unknown id.  Launches on `stream` and does
// not synchronise.
extern "C" int lu_solve_launch(int dtype_id, int n, int pivot, const void* W,
                               const void* b, int N, void* x, void* pivmin,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_id) {
    case 0: return repro_lu::by_n<float>(n, pivot, W, b, N, x, pivmin, s);
    case 1: return repro_lu::by_n<double>(n, pivot, W, b, N, x, pivmin, s);
  }
  return -1;
}
