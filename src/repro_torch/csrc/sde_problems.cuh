// Device drift/diffusion functors of the SDE kernels (sde_ensemble.cu and
// sde_adaptive_ensemble.cu): the problems of
// src/repro_torch/configs/de_problems.py, in the Python functions'
// operation order.  n states, k parameters, m Wiener processes.  Diagonal
// problems give `diffusion` (the stepper multiplies by dW); general
// problems give `noise`, which returns g(u)·dW directly, so a 4 x 8 noise
// matrix is never held whole in registers.
//
// A data functor (the rate-table GBM) is built from the dataset's tables
// (interp.cuh `Tables`) and reads them on the card; the others are
// stateless.  The kernels call every member through a functor object.
//
// A problem whose drift and noise share a sub-expression (CRN's Hill term)
// also gives `drift_and_noise`, both at one point, the shared term computed
// once; `kSharedDriftNoise` marks it, and the fixed-dt kernel's steppers
// call it where they evaluate both at the same (u, t).  Its outputs are the
// two members' bit for bit: the shared term is the same expression on the
// same inputs, and it feeds no product that could contract differently.
//
// Every member takes an arithmetic policy `A` of arith.cuh as its first
// template argument: `Rounded` in the adaptive kernel and the event forms,
// so a functor computes what the plain PyTorch version computes, bit for
// bit; `Contracting` in the fixed-dt kernel's no-event form.

#pragma once

#include <cuda_runtime.h>

#include "arith.cuh"
#include "interp.cuh"

namespace repro_sde {

using repro_arith::Contracting;
using repro_arith::radd;
using repro_arith::rdiv;
using repro_arith::rmul;
using repro_arith::Rounded;
using repro_arith::rsub;

// NaN-propagating max and min, as torch.maximum / jnp.maximum.
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// A.2.1 geometric Brownian motion: f = r u, g = v u (diagonal).
struct Gbm {
  static constexpr int n = 3, k = 2, m = 3;
  static constexpr bool diagonal = true;
  static constexpr bool has_gdg = true, has_ddb = true;
  template <class A, typename T>
  __device__ __forceinline__ static void drift(const T* u, const T* p, T t,
                                               T* du) {
#pragma unroll
    for (int c = 0; c < n; ++c) du[c] = A::mul(p[0], u[c]);
  }
  template <class A, typename T>
  __device__ __forceinline__ static void diffusion(const T* u, const T* p,
                                                   T t, T* g) {
#pragma unroll
    for (int c = 0; c < n; ++c) g[c] = A::mul(p[1], u[c]);
  }
  // Milstein's (∂g/∂u)·g, by hand: the JVP of v u along g = v u.
  template <class A, typename T>
  __device__ __forceinline__ static void gdg(const T* u, const T* p, T t,
                                             T* out) {
#pragma unroll
    for (int c = 0; c < n; ++c) out[c] = A::mul(p[1], A::mul(p[1], u[c]));
  }
  // The Milstein pair's ∂((∂g)·g)·g, by hand: the JVP of v (v u) along
  // g = v u, as the nested JVP of `milstein_embedded_step` computes it.
  template <class A, typename T>
  __device__ __forceinline__ static void ddb(const T* u, const T* p, T t,
                                             T* out) {
#pragma unroll
    for (int c = 0; c < n; ++c)
      out[c] = A::mul(p[1], A::mul(p[1], A::mul(p[1], u[c])));
  }
};

// A constant-drift ramp with negligible noise, the event-resume probe:
// f = p[0] (ones_like(u) * p[0]), g = p[1] u (diagonal), with GBM's
// hand-written gdg and ddb (the same diffusion).
struct Ramp {
  static constexpr int n = 1, k = 2, m = 1;
  static constexpr bool diagonal = true;
  static constexpr bool has_gdg = true, has_ddb = true;
  template <class A, typename T>
  __device__ __forceinline__ static void drift(const T* u, const T* p, T t,
                                               T* du) {
    du[0] = p[0];
  }
  template <class A, typename T>
  __device__ __forceinline__ static void diffusion(const T* u, const T* p,
                                                   T t, T* g) {
    g[0] = A::mul(p[1], u[0]);
  }
  template <class A, typename T>
  __device__ __forceinline__ static void gdg(const T* u, const T* p, T t,
                                             T* out) {
    out[0] = A::mul(p[1], A::mul(p[1], u[0]));
  }
  template <class A, typename T>
  __device__ __forceinline__ static void ddb(const T* u, const T* p, T t,
                                             T* out) {
    out[0] = A::mul(p[1], A::mul(p[1], A::mul(p[1], u[0])));
  }
};

// A.2.2 sigma-factor stress-response network: 4 states, 8 Wiener processes
// (general noise, chemical-Langevin birth/death terms), 6 parameters
// (S, D, tau, v0, n, eta).  pow keeps its NaN for a negative base and a
// non-integer exponent, as torch's ** does.
struct Crn {
  static constexpr int n = 4, k = 6, m = 8;
  static constexpr bool diagonal = false;
  static constexpr bool has_gdg = false, has_ddb = false;
  template <class A, typename T>
  __device__ __forceinline__ static T hill(const T* u, const T* p) {
    const T sn = pow(A::mul(p[0], u[0]), p[4]);
    return A::div(sn, A::add(A::add(sn, pow(A::mul(p[1], u[3]), p[4])),
                             T(1)));
  }
  template <class A, typename T>
  __device__ __forceinline__ static void drift(const T* u, const T* p, T t,
                                               T* du) {
    drift_at<A>(u, p, hill<A>(u, p), du);
  }
  template <typename T>
  __device__ __forceinline__ static T pos(T x) {
    return sqrt(nmax(x, T(0)));
  }
  // g(u)·dW: each row of the 4 x 8 matrix has two non-zero entries; the
  // plain version sums the row left to right, where the zero terms add
  // nothing.
  template <class A, typename T>
  __device__ __forceinline__ static void noise(const T* u, const T* p, T t,
                                               const T* dW, T* out) {
    noise_at<A>(u, p, hill<A>(u, p), dW, out);
  }
  // drift and g(u)·dW at one point, the Hill term (2 pows, a division)
  // computed once
  static constexpr bool kSharedDriftNoise = true;
  template <class A, typename T>
  __device__ __forceinline__ static void drift_and_noise(const T* u,
                                                         const T* p, T t,
                                                         const T* dW, T* du,
                                                         T* out) {
    const T hl = hill<A>(u, p);
    drift_at<A>(u, p, hl, du);
    noise_at<A>(u, p, hl, dW, out);
  }
  template <class A, typename T>
  __device__ __forceinline__ static void drift_at(const T* u, const T* p,
                                                  T hl, T* du) {
    const T tau = p[2];
    du[0] = A::sub(A::add(p[3], hl), u[0]);
    du[1] = A::div(A::sub(u[0], u[1]), tau);
    du[2] = A::div(A::sub(u[1], u[2]), tau);
    du[3] = A::div(A::sub(u[2], u[3]), tau);
  }
  template <class A, typename T>
  __device__ __forceinline__ static void noise_at(const T* u, const T* p,
                                                  T hl, const T* dW, T* out) {
    const T tau = p[2], eta = p[5];
    out[0] = A::add(A::mul(A::mul(eta, pos(A::add(p[3], hl))), dW[0]),
                    A::mul(A::mul(-eta, pos(u[0])), dW[1]));
    out[1] = A::add(A::mul(A::mul(eta, pos(A::div(u[0], tau))), dW[2]),
                    A::mul(A::mul(-eta, pos(A::div(u[1], tau))), dW[3]));
    out[2] = A::add(A::mul(A::mul(eta, pos(A::div(u[1], tau))), dW[4]),
                    A::mul(A::mul(-eta, pos(A::div(u[2], tau))), dW[5]));
    out[3] = A::add(A::mul(A::mul(eta, pos(A::div(u[2], tau))), dW[6]),
                    A::mul(A::mul(-eta, pos(A::div(u[3], tau))), dW[7]));
  }
};

// The rate-table GBM (paper §6.7 on the SDE family): f = r(t) u with the
// rate r read from the table data["rate"] (gather), g = s u (diagonal),
// p = (s,), and GBM's hand-written gdg and ddb in s.
struct GbmRate {
  static constexpr int n = 1, k = 1, m = 1;
  static constexpr bool diagonal = true;
  static constexpr bool has_gdg = true, has_ddb = true;
  repro_data::Leaf rate;
  __device__ __forceinline__ explicit GbmRate(const repro_data::Tables& d)
      : rate(d.leaf[0]) {}
  template <class A, typename T>
  __device__ __forceinline__ void drift(const T* u, const T* p, T t,
                                        T* du) const {
    const T r = repro_data::interp1d<repro_data::kGather, A>(
        repro_data::Table1D<T>(rate), t);
    du[0] = A::mul(r, u[0]);
  }
  template <class A, typename T>
  __device__ __forceinline__ void diffusion(const T* u, const T* p, T t,
                                            T* g) const {
    g[0] = A::mul(p[0], u[0]);
  }
  template <class A, typename T>
  __device__ __forceinline__ void gdg(const T* u, const T* p, T t,
                                      T* out) const {
    out[0] = A::mul(p[0], A::mul(p[0], u[0]));
  }
  template <class A, typename T>
  __device__ __forceinline__ void ddb(const T* u, const T* p, T t,
                                      T* out) const {
    out[0] = A::mul(p[0], A::mul(p[0], A::mul(p[0], u[0])));
  }
};

}  // namespace repro_sde
