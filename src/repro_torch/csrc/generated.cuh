// Helpers of the device functors that `repro_torch.translate` emits
// (`emit.py`) into the generated translation units (`units.py`).  A
// generated functor writes each op as PyTorch's CUDA kernel computes it,
// so that it equals its plain version, `translate.ir.evaluate` on the
// card, bit for bit where both round every operation alone:
//
//   - torch.maximum, torch.minimum and the clamps propagate NaN (`nmax`,
//     `nmin`, as the hand-written functors' helpers);
//   - `x / c` by a Python number c is `x * (1 / c)`, the reciprocal taken
//     in T (PyTorch's CUDA division by a host scalar), given in both
//     precisions by `pick`;
//   - `x ** c` by a Python number takes PyTorch's special paths (a product
//     for 2 and 3, sqrt for 0.5, rsqrt for -0.5, a reciprocal for -1 and
//     -2), else pow.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "arith.cuh"

namespace repro_gen {

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// A constant in T: the float one where T is float, else the double one.
template <typename T>
__host__ __device__ constexpr T pick(float f, double d) {
  if constexpr (std::is_same_v<T, float>)
    return f;
  else
    return d;
}

}  // namespace repro_gen
