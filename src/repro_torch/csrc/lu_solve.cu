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
//
// A factorization that outlives the launch: where one W is solved against
// several right-hand sides (a Rosenbrock step's stage solves), the two
// halves of the same body run as two kernels.  `lu_factor_kernel` reads W
// (B, n, n) at any strides (the layout the caller built it in, so no
// copy), factors it with lu_lanes.cuh's `lu_factor` and writes the state
// lane-major to HBM: `lu` (n, n, N) holds the eliminated rows on and above
// the diagonal and the multipliers below it, `piv` (n - 1, N) the pivot
// rows as bytes, and pivmin (N,).  `lu_resolve_kernel` reads that state and
// one right-hand side (n, N) and runs `lu_resolve`.  The arithmetic is the
// one-shot kernel's, operation for operation, so x and pivmin are its bits.

#include <cuda_runtime.h>

#include <cstdint>

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

// The factorization alone: W[lane * sb + i * si + j * sj] in, the state
// out (see the head of this file).
template <typename T, int n, bool Pivot>
__global__ void __launch_bounds__(kBlock)
    lu_factor_kernel(const T* __restrict__ W, long long sb, long long si,
                     long long sj, int N, T* __restrict__ lu,
                     uint8_t* __restrict__ piv, T* __restrict__ pivmin) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t NN = static_cast<size_t>(N);
  const T* w = W + static_cast<long long>(lane) * sb;
  LuFactors<T, n> f;
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) f.r[i][j] = w[i * si + j * sj];
  lu_factor<T, n, Pivot>(f);
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j)
      lu[(i * n + j) * NN + lane] = j >= i ? f.r[i][j] : f.mult[i][j];
  if (Pivot) {
#pragma unroll
    for (int k = 0; k < n - 1; ++k)
      piv[k * NN + lane] = static_cast<uint8_t>(f.piv[k]);
  }
  pivmin[lane] = f.pivmin;
}

// One right-hand side b[i * bi + lane * bl] against a stored factorization.
template <typename T, int n, bool Pivot>
__global__ void __launch_bounds__(kBlock)
    lu_resolve_kernel(const T* __restrict__ lu,
                      const uint8_t* __restrict__ piv,
                      const T* __restrict__ b, long long bi, long long bl,
                      int N, T* __restrict__ x) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t NN = static_cast<size_t>(N);
  LuFactors<T, n> f;
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const T v = lu[(i * n + j) * NN + lane];
      if (j >= i)
        f.r[i][j] = v;
      else
        f.mult[i][j] = v;
    }
  if (Pivot) {
#pragma unroll
    for (int k = 0; k < n - 1; ++k) f.piv[k] = piv[k * NN + lane];
  }
  T v[n];
#pragma unroll
  for (int i = 0; i < n; ++i)
    v[i] = b[i * bi + static_cast<long long>(lane) * bl];
  lu_resolve<T, n, Pivot>(f, v);
#pragma unroll
  for (int i = 0; i < n; ++i) x[i * NN + lane] = v[i];
}

struct FactorArgs {
  const void* W;
  long long sb, si, sj;
  int N;
  void* lu;
  void* piv;
  void* pivmin;
};

struct ResolveArgs {
  const void* lu;
  const void* piv;
  const void* b;
  long long bi, bl;
  int N;
  void* x;
};

template <typename T, int n, bool Pivot>
void run(const FactorArgs& a, cudaStream_t s) {
  lu_factor_kernel<T, n, Pivot><<<(a.N + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      static_cast<const T*>(a.W), a.sb, a.si, a.sj, a.N,
      static_cast<T*>(a.lu), static_cast<uint8_t*>(a.piv),
      static_cast<T*>(a.pivmin));
}

template <typename T, int n, bool Pivot>
void run(const ResolveArgs& a, cudaStream_t s) {
  lu_resolve_kernel<T, n, Pivot><<<(a.N + kBlock - 1) / kBlock, kBlock, 0,
                                   s>>>(
      static_cast<const T*>(a.lu), static_cast<const uint8_t*>(a.piv),
      static_cast<const T*>(a.b), a.bi, a.bl, a.N, static_cast<T*>(a.x));
}

// The factor or resolve entry for (T, n, pivot) of one argument block.
template <typename T, int n, class Args>
int run_split(int pivot, const Args& a, cudaStream_t s) {
  if (pivot)
    run<T, n, true>(a, s);
  else
    run<T, n, false>(a, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class Args>
int split_by_n(int n, int pivot, const Args& a, cudaStream_t s) {
  switch (n) {
    case 1: return run_split<T, 1>(pivot, a, s);
    case 2: return run_split<T, 2>(pivot, a, s);
    case 3: return run_split<T, 3>(pivot, a, s);
    case 4: return run_split<T, 4>(pivot, a, s);
    case 5: return run_split<T, 5>(pivot, a, s);
    case 6: return run_split<T, 6>(pivot, a, s);
    case 7: return run_split<T, 7>(pivot, a, s);
    case 8: return run_split<T, 8>(pivot, a, s);
  }
  return -1;
}

template <class Args>
int split(int dtype_id, int n, int pivot, const Args& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_id) {
    case 0: return split_by_n<float>(n, pivot, a, s);
    case 1: return split_by_n<double>(n, pivot, a, s);
  }
  return -1;
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

// The factorization alone.  W (N, n, n) at element strides (sb, si, sj);
// writes lu (n, n, N) and, with pivot, piv (n - 1, N) uint8, lane-major,
// and pivmin (N,).  Return codes and streams as lu_solve_launch.
extern "C" int lu_factor_launch(int dtype_id, int n, int pivot,
                                const void* W, long long sb, long long si,
                                long long sj, int N, void* lu, void* piv,
                                void* pivmin, void* stream) {
  const repro_lu::FactorArgs a{W, sb, si, sj, N, lu, piv, pivmin};
  return repro_lu::split(dtype_id, n, pivot, a, stream);
}

// One right-hand side against lu_factor_launch's state: b (n, N) at
// element strides (bi, bl); writes x (n, N).  Return codes and streams as
// lu_solve_launch.
extern "C" int lu_resolve_launch(int dtype_id, int n, int pivot,
                                 const void* lu, const void* piv,
                                 const void* b, long long bi, long long bl,
                                 int N, void* x, void* stream) {
  const repro_lu::ResolveArgs a{lu, piv, b, bi, bl, N, x};
  return repro_lu::split(dtype_id, n, pivot, a, stream);
}
