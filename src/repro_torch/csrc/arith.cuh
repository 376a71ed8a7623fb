// Arithmetic policies of the CUDA kernels, shared by every source of
// csrc/.  `radd`, `rsub`, `rmul` and `rdiv` round one operation on its own
// (the _rn intrinsics, which nvcc never contracts into a fused
// multiply-add), as a PyTorch tensor operation rounds it.  Code that takes
// a policy `A` writes A::add, A::sub, A::mul and A::div:
//
//   - `Rounded` rounds each of them on its own, so the code computes what
//     the plain PyTorch version computes, bit for bit, where it follows the
//     plain version's operation order.  The Rosenbrock, LU and adaptive SDE
//     kernels and every event form use it.
//   - `Contracting` writes the plain C++ operators and leaves nvcc free to
//     fuse a product into the sum it feeds: the no-event explicit-RK and
//     fixed-dt SDE kernels, whose results tools/parent_check.py holds bit
//     for bit to earlier builds.
//
// pow and sqrt keep nvcc's defaults (a correctly rounded sqrt), as PyTorch
// builds its own.

#pragma once

#include <cuda_runtime.h>

namespace repro_arith {

__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }

struct Rounded {
  template <typename T>
  __device__ __forceinline__ static T add(T a, T b) { return radd(a, b); }
  template <typename T>
  __device__ __forceinline__ static T sub(T a, T b) { return rsub(a, b); }
  template <typename T>
  __device__ __forceinline__ static T mul(T a, T b) { return rmul(a, b); }
  template <typename T>
  __device__ __forceinline__ static T div(T a, T b) { return rdiv(a, b); }
};

struct Contracting {
  template <typename T>
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
  template <typename T>
  __device__ __forceinline__ static T sub(T a, T b) { return a - b; }
  template <typename T>
  __device__ __forceinline__ static T mul(T a, T b) { return a * b; }
  template <typename T>
  __device__ __forceinline__ static T div(T a, T b) { return a / b; }
};

}  // namespace repro_arith
