// Dataset lookups on the card (paper §6.7, "texture memory"), shared by the
// explicit-RK, Rosenbrock and both SDE kernels and by the lookup test entry
// (interp_lookup.cu): the device form of src/repro_torch/core/interp.py.
//
// Replaces what the TPU kernel does with its "table" extras
// (src/repro/kernels/ensemble_kernel.py:240-249, rebound at :438-458): a
// dataset leaf there is a VMEM-resident block broadcast to every lane tile,
// and the body interpolates it with `repro.core.interp`.  Here a leaf stays
// in device memory and each thread reads the two (linear) or four (cubic)
// knots it needs through the read-only data path (`__ldg`); a table of a
// few hundred words stays in L1/L2 for the whole run.  Hardware texture
// filtering is not used: it weighs the knots in 9-bit fixed point, and the
// port holds its lookups to the plain version bit for bit.
//
// Every lookup follows the plain version operation by operation under an
// arithmetic policy `A` of arith.cuh (the data forms pass `Rounded`), with
// clamped ends: s = (x - x0) / dx clamped to [0, K - 1], the cell
// i = clamp(floor(s), 0, K - 2), the weight w = s - i.  "onehot" is the
// TPU's matmul form of the same function; here it sums the contraction's
// two terms that are not zero, in the order the row of weights holds them,
// which equals "gather" (the plain version's matmul may fuse, so onehot is
// held within 1e-12, not bitwise).
//
// The forward tangent d/dx of the gather lookup (the Rosenbrock stages'
// ∂f/∂t) comes with the value from one location of x
// (`interp1d_and_tangent`) and follows the order in which torch.func.jvp
// evaluates it in the plain version, with JAX's tie rule at the clamp:
// half the tangent where s sits exactly on 0 or K - 1 (`_Clip` in
// core/interp.py).  `interp1d_tangent` and `interp2d_tangent` give the
// tangent of a lookup in every mode along the queries' own tangents, for
// the functors that `repro_torch.translate` generates (∂f/∂t, and a
// Jacobian where a query depends on u): each follows PyTorch's forward-AD
// formulas through core/interp.py term by term, so that it equals
// torch.func.jvp of the plain version bit for bit on the card in gather
// and cubic mode (onehot sums the contraction's two terms that are not
// zero, as its value does).

#pragma once

#include <cuda_runtime.h>

#include "arith.cuh"

namespace repro_data {

constexpr int kMaxLeaves = 4;
constexpr int kGather = 0, kOneHot = 1, kCubic = 2;

// One dataset leaf as the wrapper passes it: the values on the card
// (row-major, contiguous), the shape (ky = 0 for a 1-D table) and the grid.
struct Leaf {
  const void* values;
  int kx, ky;
  double x0, dx, y0, dy;
};

// The no-data form: `enabled` is false and nothing is read.
struct NoData {
  static constexpr bool enabled = false;
};

// The data form's kernel argument: the leaves in data_flatten's order.
struct Tables {
  static constexpr bool enabled = true;
  Leaf leaf[kMaxLeaves];
  int count;
};

// The Tables of a data entry's arguments: `count` leaves, their device
// pointers, (kx, ky) shapes and (x0, dx, y0, dy) grids.  False for a count
// out of range.
inline bool make_tables(int count, const void* const* values,
                        const int* shape, const double* grid, Tables& out) {
  if (count < 1 || count > kMaxLeaves) return false;
  out.count = count;
  for (int l = 0; l < count; ++l)
    out.leaf[l] = Leaf{values[l],       shape[2 * l],     shape[2 * l + 1],
                       grid[4 * l],     grid[4 * l + 1],  grid[4 * l + 2],
                       grid[4 * l + 3]};
  return true;
}

// A functor of a data form is built from the Tables; a no-data functor is
// stateless.
template <class F, class D>
__device__ __forceinline__ F bind(const D& d) {
  if constexpr (D::enabled)
    return F(d);
  else
    return F{};
}

template <typename T>
__device__ __forceinline__ T load(const T* v, int i) {
  return __ldg(v + i);
}

// torch.clamp(s, 0, hi): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_s(T s, T hi) {
  return s < T(0) ? T(0) : (s > hi ? hi : s);
}

// The clamped cell and weight of the grid coordinate s = (x - x0) / dx on
// a K-knot axis.  A NaN s converts to cell 0, as torch's int cast clamps.
template <class A, typename T>
__device__ __forceinline__ void cell(T s_raw, int K, int& i, T& w) {
  const T s = clamp_s(s_raw, T(K - 1));
  int c = s == s ? static_cast<int>(floor(s)) : 0;
  c = c < 0 ? 0 : (c > K - 2 ? K - 2 : c);
  i = c;
  w = A::sub(s, T(c));
}

// The clamped cell and weight of x (core/interp.py `_locate`).
template <class A, typename T>
__device__ __forceinline__ void locate(T x, T x0, T dx, int K, int& i, T& w) {
  cell<A>(A::div(A::sub(x, x0), dx), K, i, w);
}

// Keys cubic-convolution weights (a = -1/2), `_catmull_rom_weights`.
template <class A, typename T>
__device__ __forceinline__ void catmull_rom(T w, T (&c)[4]) {
  const T w2 = A::mul(w, w);
  const T w3 = A::mul(w2, w);
  c[0] = A::mul(T(0.5), A::sub(A::add(-w3, A::mul(T(2.0), w2)), w));
  c[1] = A::mul(T(0.5),
                A::add(A::sub(A::mul(T(3.0), w3), A::mul(T(5.0), w2)),
                       T(2.0)));
  c[2] = A::mul(T(0.5),
                A::add(A::add(A::mul(T(-3.0), w3), A::mul(T(4.0), w2)), w));
  c[3] = A::mul(T(0.5), A::sub(w3, w2));
}

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// A 1-D table in the working type.
template <typename T>
struct Table1D {
  const T* v;
  int K;
  T x0, dx;
  __device__ __forceinline__ explicit Table1D(const Leaf& l)
      : v(static_cast<const T*>(l.values)), K(l.kx), x0(T(l.x0)),
        dx(T(l.dx)) {}
};

// A 2-D table in the working type, values[i * Ky + j].
template <typename T>
struct Table2D {
  const T* v;
  int Kx, Ky;
  T x0, dx, y0, dy;
  __device__ __forceinline__ explicit Table2D(const Leaf& l)
      : v(static_cast<const T*>(l.values)), Kx(l.kx), Ky(l.ky),
        x0(T(l.x0)), dx(T(l.dx)), y0(T(l.y0)), dy(T(l.dy)) {}
};

// interp1d(table, x, mode).
template <int Mode, class A, typename T>
__device__ __forceinline__ T interp1d(const Table1D<T>& tb, T x) {
  int i;
  T w;
  locate<A>(x, tb.x0, tb.dx, tb.K, i, w);
  if constexpr (Mode == kCubic) {
    T c[4];
    catmull_rom<A>(w, c);
    T out = A::mul(c[0], load(tb.v, clampi(i - 1, 0, tb.K - 1)));
#pragma unroll
    for (int k = 1; k < 4; ++k)
      out = A::add(out, A::mul(c[k], load(tb.v, clampi(i - 1 + k, 0,
                                                        tb.K - 1))));
    return out;
  } else {
    // gather: v0 (1 - w) + v1 w; onehot: the row (.., 1 - w, w, ..) times
    // the table, of which these are the two terms that are not zero
    const T v0 = load(tb.v, i), v1 = load(tb.v, i + 1);
    return A::add(A::mul(v0, A::sub(T(1), w)), A::mul(v1, w));
  }
}

// interp1d(table, x, "gather") and its tangent d/dx from one location of
// x (the value's cell and weight, the tangent's clamp factors, the same
// two knots).  The tangent follows the order in which torch.func.jvp
// evaluates it in the plain version, with the JAX tie rule:
// (-w') v0 + w' v1 with w' = (1 / dx) f_lo f_hi; `inv_dx` is 1 / dx, formed
// by the caller once.
template <class A, typename T>
__device__ __forceinline__ void interp1d_and_tangent(const Table1D<T>& tb,
                                                     T inv_dx, T x, T& value,
                                                     T& tangent) {
  const T hi = T(tb.K - 1);
  const T s = A::div(A::sub(x, tb.x0), tb.dx);
  int i;
  T w;
  cell<A>(s, tb.K, i, w);
  const T v0 = load(tb.v, i), v1 = load(tb.v, i + 1);
  value = A::add(A::mul(v0, A::sub(T(1), w)), A::mul(v1, w));
  const T f_lo = s > T(0) ? T(1) : (s == T(0) ? T(0.5) : T(0));
  const T m = s < T(0) ? T(0) : s;
  const T f_hi = m < hi ? T(1) : (m == hi ? T(0.5) : T(0));
  const T wt = A::mul(A::mul(inv_dx, f_lo), f_hi);
  tangent = A::add(A::mul(-wt, v0), A::mul(wt, v1));
}

// interp2d(table, x, y, mode).
template <int Mode, class A, typename T>
__device__ __forceinline__ T interp2d(const Table2D<T>& tb, T x, T y) {
  int i, j;
  T wx, wy;
  locate<A>(x, tb.x0, tb.dx, tb.Kx, i, wx);
  locate<A>(y, tb.y0, tb.dy, tb.Ky, j, wy);
  const int Ky = tb.Ky;
  if constexpr (Mode == kGather) {
    const int idx = i * Ky + j;
    const T ox = A::sub(T(1), wx), oy = A::sub(T(1), wy);
    const T t00 = A::mul(A::mul(load(tb.v, idx), ox), oy);
    const T t01 = A::mul(A::mul(load(tb.v, idx + 1), ox), wy);
    const T t10 = A::mul(A::mul(load(tb.v, idx + Ky), wx), oy);
    const T t11 = A::mul(A::mul(load(tb.v, idx + Ky + 1), wx), wy);
    return A::add(A::add(A::add(t00, t01), t10), t11);
  } else if constexpr (Mode == kOneHot) {
    // rows = wmx @ values at columns j and j + 1, then rows . wmy
    const T ox = A::sub(T(1), wx), oy = A::sub(T(1), wy);
    const int idx = i * Ky + j;
    const T r0 = A::add(A::mul(ox, load(tb.v, idx)),
                        A::mul(wx, load(tb.v, idx + Ky)));
    const T r1 = A::add(A::mul(ox, load(tb.v, idx + 1)),
                        A::mul(wx, load(tb.v, idx + Ky + 1)));
    return A::add(A::mul(r0, oy), A::mul(r1, wy));
  } else {
    T cx[4], cy[4];
    catmull_rom<A>(wx, cx);
    catmull_rom<A>(wy, cy);
    T out = T(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ii = clampi(i - 1 + a, 0, tb.Kx - 1);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jj = clampi(j - 1 + b, 0, Ky - 1);
        const T term = A::mul(A::mul(cx[a], cy[b]), load(tb.v, ii * Ky + jj));
        out = (a == 0 && b == 0) ? term : A::add(out, term);
      }
    }
    return out;
  }
}

// The tangent of the clamped grid coordinate clip((x - x0) / dx, 0, hi)
// along the query's tangent xt, as torch.func.jvp forms it through
// core/interp.py `_locate`: the quotient's tangent xt / dx, then `_Clip`'s
// factors (1 inside, 1/2 on a bound, 0 outside or NaN), left to right.
template <class A, typename T>
__device__ __forceinline__ T coord_tangent(T s, T hi, T dx, T xt) {
  const T f_lo = s > T(0) ? T(1) : (s == T(0) ? T(0.5) : T(0));
  const T m = s < T(0) ? T(0) : s;
  const T f_hi = m < hi ? T(1) : (m == hi ? T(0.5) : T(0));
  return A::mul(A::mul(A::div(xt, dx), f_lo), f_hi);
}

// The tangents of the Keys weights along the weight's tangent wt, in the
// order PyTorch's forward AD takes `_catmull_rom_weights` (w2 = w w,
// w3 = w2 w; a product's tangent other_t self + self_t other; a product by
// a Python number the tangent times the number).
template <class A, typename T>
__device__ __forceinline__ void catmull_rom_tangent(T w, T wt, T (&ct)[4]) {
  const T w2 = A::mul(w, w);
  const T w2t = A::add(A::mul(wt, w), A::mul(wt, w));
  const T w3t = A::add(A::mul(wt, w2), A::mul(w2t, w));
  ct[0] = A::mul(A::sub(A::add(-w3t, A::mul(w2t, T(2.0))), wt), T(0.5));
  ct[1] = A::mul(A::sub(A::mul(w3t, T(3.0)), A::mul(w2t, T(5.0))), T(0.5));
  ct[2] = A::mul(A::add(A::add(A::mul(w3t, T(-3.0)), A::mul(w2t, T(4.0))),
                        wt),
                 T(0.5));
  ct[3] = A::mul(A::sub(w3t, w2t), T(0.5));
}

// The tangent of interp1d(table, x, mode) along xt.
template <int Mode, class A, typename T>
__device__ __forceinline__ T interp1d_tangent(const Table1D<T>& tb, T x,
                                              T xt) {
  const T s = A::div(A::sub(x, tb.x0), tb.dx);
  int i;
  T w;
  cell<A>(s, tb.K, i, w);
  const T wt = coord_tangent<A>(s, T(tb.K - 1), tb.dx, xt);
  if constexpr (Mode == kCubic) {
    T ct[4];
    catmull_rom_tangent<A>(w, wt, ct);
    T out = A::mul(ct[0], load(tb.v, clampi(i - 1, 0, tb.K - 1)));
#pragma unroll
    for (int k = 1; k < 4; ++k)
      out = A::add(out, A::mul(ct[k], load(tb.v, clampi(i - 1 + k, 0,
                                                         tb.K - 1))));
    return out;
  } else {
    const T v0 = load(tb.v, i), v1 = load(tb.v, i + 1);
    return A::add(A::mul(-wt, v0), A::mul(wt, v1));
  }
}

// The tangent of interp2d(table, x, y, mode) along xt (where HasX) and yt
// (where HasY); a query without a tangent contributes no term, as PyTorch
// drops an undefined tangent.
template <int Mode, class A, bool HasX, bool HasY, typename T>
__device__ __forceinline__ T interp2d_tangent(const Table2D<T>& tb, T x, T y,
                                              T xt, T yt) {
  static_assert(HasX || HasY, "a tangent along x, y or both");
  const T sx = A::div(A::sub(x, tb.x0), tb.dx);
  const T sy = A::div(A::sub(y, tb.y0), tb.dy);
  int i, j;
  T wx, wy;
  cell<A>(sx, tb.Kx, i, wx);
  cell<A>(sy, tb.Ky, j, wy);
  const T a = HasX ? coord_tangent<A>(sx, T(tb.Kx - 1), tb.dx, xt) : T(0);
  const T b = HasY ? coord_tangent<A>(sy, T(tb.Ky - 1), tb.dy, yt) : T(0);
  const int Ky = tb.Ky;
  // (P q)' = q' P + P' q, a term dropped where its tangent is
  auto prod = [&](T p, T pt, bool has_p, T q, T qt, bool has_q) {
    if (has_p && has_q) return A::add(A::mul(qt, p), A::mul(pt, q));
    return has_q ? A::mul(qt, p) : A::mul(pt, q);
  };
  if constexpr (Mode == kGather) {
    const int idx = i * Ky + j;
    const T ox = A::sub(T(1), wx), oy = A::sub(T(1), wy);
    const T v00 = load(tb.v, idx), v01 = load(tb.v, idx + 1);
    const T v10 = load(tb.v, idx + Ky), v11 = load(tb.v, idx + Ky + 1);
    // t = (v wx-factor) wy-factor; the first product's tangent is the
    // factor's times v
    const T t00 = prod(A::mul(v00, ox), A::mul(-a, v00), HasX, oy, -b, HasY);
    const T t01 = prod(A::mul(v01, ox), A::mul(-a, v01), HasX, wy, b, HasY);
    const T t10 = prod(A::mul(v10, wx), A::mul(a, v10), HasX, oy, -b, HasY);
    const T t11 = prod(A::mul(v11, wx), A::mul(a, v11), HasX, wy, b, HasY);
    return A::add(A::add(A::add(t00, t01), t10), t11);
  } else if constexpr (Mode == kOneHot) {
    // rows = wmx @ values at columns j and j + 1, then sum(rows wmy): a
    // column's term (rows wmy)' = wmy' rows + rows' wmy
    const T ox = A::sub(T(1), wx), oy = A::sub(T(1), wy);
    const int idx = i * Ky + j;
    const T r0 = A::add(A::mul(ox, load(tb.v, idx)),
                        A::mul(wx, load(tb.v, idx + Ky)));
    const T r1 = A::add(A::mul(ox, load(tb.v, idx + 1)),
                        A::mul(wx, load(tb.v, idx + Ky + 1)));
    const T r0t = A::add(A::mul(-a, load(tb.v, idx)),
                         A::mul(a, load(tb.v, idx + Ky)));
    const T r1t = A::add(A::mul(-a, load(tb.v, idx + 1)),
                         A::mul(a, load(tb.v, idx + Ky + 1)));
    return A::add(prod(r0, r0t, HasX, oy, -b, HasY),
                  prod(r1, r1t, HasX, wy, b, HasY));
  } else {
    T cx[4], cy[4], cxt[4], cyt[4];
    catmull_rom<A>(wx, cx);
    catmull_rom<A>(wy, cy);
    catmull_rom_tangent<A>(wx, a, cxt);
    catmull_rom_tangent<A>(wy, b, cyt);
    T out = T(0);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int ii = clampi(i - 1 + p, 0, tb.Kx - 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jj = clampi(j - 1 + q, 0, Ky - 1);
        const T term = A::mul(prod(cx[p], cxt[p], HasX, cy[q], cyt[q], HasY),
                              load(tb.v, ii * Ky + jj));
        out = (p == 0 && q == 0) ? term : A::add(out, term);
      }
    }
    return out;
  }
}

}  // namespace repro_data
