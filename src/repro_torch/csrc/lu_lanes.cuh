// Per-thread LU factorization and back-substitution of one small system
// W x = b with partial pivoting, shared by the standalone batched LU kernel
// (lu_solve.cu) and the fused Rosenbrock kernel (rosenbrock_ensemble.cu).
//
// This is the body of the TPU kernel's lanes LU,
// src/repro/kernels/lu/kernel.py `lu_factor_lanes` (:28) and
// `lu_resolve_lanes` (:66), for one lane: the same unrolled elimination,
// the same pivot choice and the same operations in the same order.
//  - Pivot: at step k the first row i >= k of largest |W[i][k]|, a NaN
//    counting as largest (`jnp.argmax`): a strict `>` scan from row k.
//  - Swaps are predicated selects over the unrolled rows, as the
//    reference's `jnp.where` swaps are; every index is a compile-time
//    constant, so the matrix stays in registers.
//  - The multiplier is W[i][k] * (1 / W[k][k]) (a reciprocal, then a
//    multiply); back-substitution divides by the diagonal.
//  - pivmin, the least |pivot|, propagates NaN as `jnp.minimum` does, so a
//    NaN-poisoned singular system never reports a positive pivmin.
//  - Every product and difference is rounded on its own (arith.cuh's
//    `rmul`, `rsub`: no fused multiply-add), as the plain version's tensor
//    operations are, so the kernel's LU equals the plain version's bit for
//    bit on the same card.
// Only the columns that later steps read are updated: at step k, columns
// k..n-1 are swapped and columns k+1..n-1 eliminated (the reference also
// rewrites the columns left of the pivot, which nothing reads again).

#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "arith.cuh"

namespace repro_lu {

using repro_arith::rdiv;
using repro_arith::rmul;
using repro_arith::rsub;

// NaN-propagating minimum, as jnp.minimum / torch.minimum.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T, int n>
struct LuFactors {
  T r[n][n];     // the rows after elimination: upper triangle and diagonal
  T mult[n][n];  // mult[i][k], i > k: the multiplier of row i at step k
  int piv[n];    // the pivot row chosen at step k < n - 1
  T pivmin;      // least |pivot|: 0 or NaN on a singular system
};

// Factor f.r (holding W on entry) in place.
template <typename T, int n, bool Pivot>
__device__ __forceinline__ void lu_factor(LuFactors<T, n>& f) {
  f.pivmin = T(INFINITY);
#pragma unroll
  for (int k = 0; k < n; ++k) {
    if (Pivot && k < n - 1) {
      int p = k;
      T best = fabs(f.r[k][k]);
#pragma unroll
      for (int i = k + 1; i < n; ++i) {
        const T v = fabs(f.r[i][k]);
        if (v > best || (v != v && best == best)) {
          best = v;
          p = i;
        }
      }
      f.piv[k] = p;
#pragma unroll
      for (int i = k + 1; i < n; ++i) {
        const bool sel = p == i;
#pragma unroll
        for (int c = k; c < n; ++c) {
          const T rk = f.r[k][c], ri = f.r[i][c];
          f.r[k][c] = sel ? ri : rk;
          f.r[i][c] = sel ? rk : ri;
        }
      }
    }
    f.pivmin = nan_min(f.pivmin, T(fabs(f.r[k][k])));
    const T inv = rdiv(T(1), f.r[k][k]);
#pragma unroll
    for (int i = k + 1; i < n; ++i) {
      const T m = rmul(f.r[i][k], inv);
      f.mult[i][k] = m;
#pragma unroll
      for (int c = k + 1; c < n; ++c)
        f.r[i][c] = rsub(f.r[i][c], rmul(m, f.r[k][c]));
    }
  }
}

// Solve against a factorization: x holds the right-hand side on entry and
// the solution on return.
template <typename T, int n, bool Pivot>
__device__ __forceinline__ void lu_resolve(const LuFactors<T, n>& f, T x[n]) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    if (Pivot && k < n - 1) {
      const int p = f.piv[k];
#pragma unroll
      for (int i = k + 1; i < n; ++i) {
        const bool sel = p == i;
        const T xk = x[k], xi = x[i];
        x[k] = sel ? xi : xk;
        x[i] = sel ? xk : xi;
      }
    }
#pragma unroll
    for (int i = k + 1; i < n; ++i)
      x[i] = rsub(x[i], rmul(f.mult[i][k], x[k]));
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    T acc = x[i];
#pragma unroll
    for (int j = i + 1; j < n; ++j) acc = rsub(acc, rmul(f.r[i][j], x[j]));
    x[i] = rdiv(acc, f.r[i][i]);
  }
}

}  // namespace repro_lu
