// The dataset lookups of interp.cuh on their own, one thread per query:
// the test entry that holds every mode of interp1d and interp2d, in float
// and double, against src/repro_torch/core/interp.py on the card
// (chip_smoke.py's interp-lookup phase; the ensemble kernels run only the
// lookups their data functors use).  Every operation is rounded on its own
// (`Rounded`).  What bounds it: a query reads one or two coordinates and
// writes one value, a few dozen operations in between; the knots come from
// L1/L2.

#include <cuda_runtime.h>

#include "interp.cuh"

namespace repro_data {

constexpr int kBlock = 256;

template <typename T, int Mode, bool TwoD>
__global__ void __launch_bounds__(kBlock)
    lookup_kernel(Leaf leaf, const T* __restrict__ qx,
                  const T* __restrict__ qy, int nq, T* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  using A = repro_arith::Rounded;
  if constexpr (TwoD)
    out[q] = interp2d<Mode, A>(Table2D<T>(leaf), qx[q], qy[q]);
  else
    out[q] = interp1d<Mode, A>(Table1D<T>(leaf), qx[q]);
}

template <typename T, bool TwoD>
int by_mode(int mode, const Leaf& l, const void* qx, const void* qy, int nq,
            void* out, cudaStream_t s) {
  const int grid = (nq + kBlock - 1) / kBlock;
  const T* x = static_cast<const T*>(qx);
  const T* y = static_cast<const T*>(qy);
  T* o = static_cast<T*>(out);
  switch (mode) {
    case kGather:
      lookup_kernel<T, kGather, TwoD><<<grid, kBlock, 0, s>>>(l, x, y, nq, o);
      break;
    case kOneHot:
      lookup_kernel<T, kOneHot, TwoD><<<grid, kBlock, 0, s>>>(l, x, y, nq, o);
      break;
    case kCubic:
      lookup_kernel<T, kCubic, TwoD><<<grid, kBlock, 0, s>>>(l, x, y, nq, o);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_data

// C interface, bound with ctypes by src/repro_torch/kernels/interp.py.
// dtype_id: 0 float32, 1 float64.  mode: 0 gather, 1 onehot, 2 cubic.
// ky = 0 for a 1-D table (qy unused).  Returns cudaGetLastError() after the
// launch, or -1 for an unknown id.  Launches on `stream` and does not
// synchronise.
extern "C" int interp_lookup_launch(int dtype_id, int mode,
                                    const void* data, int kx, int ky,
                                    double x0, double dx, double y0,
                                    double dy, const void* qx,
                                    const void* qy, int nq, void* out,
                                    void* stream) {
  using namespace repro_data;
  const Leaf l{data, kx, ky, x0, dx, y0, dy};
  const auto s = static_cast<cudaStream_t>(stream);
  if (nq < 1) return -1;
  switch (dtype_id) {
    case 0:
      return ky ? by_mode<float, true>(mode, l, qx, qy, nq, out, s)
                : by_mode<float, false>(mode, l, qx, qy, nq, out, s);
    case 1:
      return ky ? by_mode<double, true>(mode, l, qx, qy, nq, out, s)
                : by_mode<double, false>(mode, l, qx, qy, nq, out, s);
  }
  return -1;
}
