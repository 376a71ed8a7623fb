// The body of the fused whole-integration ensemble kernel for explicit
// Runge-Kutta pairs (the paper's EnsembleGPUKernel, §5.2), written by hand
// for Hopper (sm_90a), shared by its two translation units:
// `erk_ensemble.cu` (tsit5 and dopri5, with every event and data form) and
// `erk_tableaus.cu` (rkck54, bs3, rkf45, rk4, vern7 and gbs10, the no-event,
// no-data form), so that nvcc builds them in parallel.
//
// Replaces the TPU kernel `run_ensemble_kernel` + `erk_body` of
// src/repro/kernels/ensemble_kernel.py (pallas_call at :282, body at :461):
// adaptive embedded-RK integration of every trajectory from t0 to tf with
// FSAL where the tableau has it, per-trajectory PI step control, a finite
// check on every candidate, STATUS_DTMIN_EXHAUSTED detection, dense output
// onto a `saveat` grid (the tableau's free interpolant, or cubic Hermite
// when it has none), and the 6-row stats block (naccept, nreject, status,
// nf, njac, nfact).  With
// adaptive == 0 the same kernel is the fixed-dt form: error norm 0, every
// step accepted, dt unchanged.
//
// Design: one trajectory per thread, the paper's design.  A thread loads
// its u0 and p columns from the lane-major (n, N) / (m, N) inputs (adjacent
// threads read adjacent addresses), keeps the state, the stages, t, dt,
// the controller memory and the counters in registers, runs its own
// `while (!done && iters < max_iters)` loop and retires on its own.  Save
// points are written lane-major (S, n, N) when they are crossed, so the
// stores coalesce.  The tableau and the right-hand side are template
// parameters: the coefficients are compile-time constants, zero
// coefficients vanish at compile time and the stage loop is unrolled.
// Where a tableau streams its sums (`stream_sums`: every tableau but tsit5,
// whose free interpolant reads every stage, and dopri5, kept as it was
// measured), the b and btilde sums take each stage's term as soon as the
// stage is evaluated, in the same order, so a stage lives in registers only
// until the last stage that reads it: gbs10's 26 stages of Lorenz in f64
// would be 156 registers at once.  Without FSAL (rkck54, rkf45, rk4, vern7,
// gbs10) an accepted step evaluates f(u_new) once, for Hermite's dense
// output and as the next step's k1, and nf counts every stage, as the
// plain version does.
//
// What bounds it on an H100: arithmetic, not bytes.  Only u0, p, the saves
// and the final values touch HBM (about 124 bytes per trajectory for Lorenz
// in float32 with 5 saves), while every attempted step costs a few hundred
// FP32/FP64 operations plus two pow calls, all in registers.  The design
// answers this by keeping everything per-step in registers and by letting
// no thread wait on another's step control.  Counted in the card's
// instructions (chip_smoke.py `k1_work`: each division, sqrt and pow at its
// fast path in the build's SASS, the lookups, the saves, the events'
// bisection), the million-trajectory rows run at 1.2x to 2.2x of that
// bound, with a warp SIMT efficiency of 0.90 to 1.00 from the rows' own
// attempt counts (PERF.md §6): divergence (a warp runs until its slowest
// trajectory retires) costs at most a tenth there, so the kernel keeps one
// trajectory a thread rather than K5's work queue.
//
// Semantics follow the reference loop body
// (src/repro/core/solvers.py `_make_adaptive_body`) exactly: constants are
// rounded to T before use, zero coefficients are skipped, dt_step =
// min(dt, tf - t), accept needs enorm <= 1 and a finite candidate, a
// non-finite enorm counts as 1e10, save point s is written when
// t_old < s <= t_new + 1e-7*max(|t_new|, 1) on an accepted step, and save
// points at or before t0 hold u0.  The wrapper guarantees an ascending
// save grid, which lets each thread keep a cursor instead of scanning it.
//
// Events (the event template parameter, events.cuh): on an accepted step
// the condition is checked over the step and, on a hit, the event time is
// bisected on the same dense output the saves use (the tableau's free
// interpolant, or Hermite), the affect applied and the step truncated at
// the event: saves stop at the truncated time, FSAL is off (k1 is
// re-evaluated at the new point, and nf counts every stage, as the plain
// version does), and a terminal hit ends the trajectory.  The event and
// data forms are compiled for tsit5 and dopri5 only.
//
// Data (the data template parameter, interp.cuh): a data form's RHS is a
// functor built from the dataset's tables (`repro_data::Tables`, the
// kernel argument `dat`), which it reads on the card with interp.cuh's
// lookups: the forced oscillator of the paper's §6.7 in the gather, onehot
// and cubic modes, and with the level event.  The no-data form
// (repro_data::NoData) builds a stateless functor and reads nothing.
//
// Arithmetic (arith.cuh): the event form rounds every operation on its own
// (`Rounded`), in the plain version's order, as the Rosenbrock and SDE
// event forms do: a located event time follows the step grid, and on a
// problem the pair integrates exactly (the ball's parabolas) the error
// estimate, and so the grid, is made of rounding alone.  The no-event form
// (repro_ev::NoEvent) leaves nvcc free to contract products into fused
// multiply-adds (`Contracting`) and compiles to the code it had before
// events; tools/parent_check.py holds its results bit for bit to earlier
// builds.  The data forms round every operation on their own as well.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "events.cuh"
#include "interp.cuh"

namespace repro_erk {

constexpr int kBlock = 128;

template <int I>
using ic = std::integral_constant<int, I>;

// Compile-time loop: f(ic<B>{}), ..., f(ic<E-1>{}).
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(ic<B>{});
    static_for<B + 1, E>(f);
  }
}

// NaN-propagating max/min, as jnp.maximum / jnp.minimum.
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return nmin(nmax(x, lo), hi);
}

// Tsitouras' free interpolant weights b_i(theta), in the reference's
// operation order (src/repro_torch/core/tableaus.py `_tsit5_bpoly`), under
// the policy A: `Tsit5::bpoly`.
template <class A, typename T>
__device__ __forceinline__ void tsit5_bpoly(T t, T w[7]) {
  // c t t (t t - a t + b), left to right
  auto quad = [&](double c, double a, double b) {
    return A::mul(A::mul(A::mul(T(c), t), t),
                  A::add(A::sub(A::mul(t, t), A::mul(T(a), t)), T(b)));
  };
  // c (t - a) (t - b) t t, left to right
  auto roots = [&](double c, double a, double b) {
    return A::mul(A::mul(A::mul(A::mul(T(c), A::sub(t, T(a))),
                                A::sub(t, T(b))), t), t);
  };
  w[0] = A::mul(A::mul(A::mul(T(-1.0530884977290216), t),
                       A::sub(t, T(1.3299890189751412))),
                A::add(A::sub(A::mul(t, t), A::mul(T(1.4364028541716351), t)),
                       T(0.7139816917074209)));
  w[1] = quad(0.1017, 2.1966568338249754, 1.2949852507374631);
  w[2] = quad(2.490627285651252793, 2.38535645472061657,
              1.57803468208092486);
  w[3] = roots(-16.54810288924490272, 1.21712927295533244,
               0.61620406037800089);
  w[4] = roots(47.37952196281928122, 1.203071208372362603,
               0.658047292653547382);
  w[5] = roots(-34.87065786149660974, 1.2, 2.0 / 3.0);
  w[6] = roots(2.5, 1.0, 0.6);
}

// The index of the first nonzero weight of b (B) or btilde (!B).
template <class Tab, bool B>
__host__ __device__ constexpr int first_weight() {
  for (int j = 0; j < Tab::stages; ++j)
    if ((B ? Tab::b(j) : Tab::btilde(j)) != 0.0) return j;
  return Tab::stages;
}

// One term of a sum: from 0 under `Contracting` (nvcc may fuse the term's
// product into the add, as the no-event kernel always has), from its first
// term under `Rounded`, as the plain version sums.
template <class A, typename T>
__device__ __forceinline__ T accumulate(T acc, T term, bool first) {
  if constexpr (std::is_same_v<A, repro_arith::Rounded>)
    return first ? term : A::add(acc, term);
  else
    return A::add(acc, term);
}

// Stage j's terms of the b and btilde sums, taken as soon as the stage is
// evaluated (`stream_sums`), in the order of the sums at the end of a step.
template <class A, class Tab, int j, int n, typename T>
__device__ __forceinline__ void add_weights(T (&bsum)[n], T (&esum)[n],
                                            const T (&kj)[n]) {
  constexpr double bj = Tab::b(j), ej = Tab::btilde(j);
#pragma unroll
  for (int c = 0; c < n; ++c) {
    if constexpr (bj != 0.0)
      bsum[c] = accumulate<A>(bsum[c], A::mul(T(bj), kj[c]),
                              j == first_weight<Tab, true>());
    if constexpr (ej != 0.0)
      esum[c] = accumulate<A>(esum[c], A::mul(T(ej), kj[c]),
                              j == first_weight<Tab, false>());
  }
}

// The dense output at theta of the step from u (stages k) to ucand: the
// tableau's free interpolant, u + dt_step * sum_q w_q(theta) k_q with the
// weights from the tableau's `bpoly` (tsit5's is `tsit5_bpoly`; a user
// tableau's is emitted from its Python interpolant), or cubic Hermite on
// (u, k1, ucand, fend = f(ucand): the last stage by FSAL, else evaluated
// once for the step).
template <class A, class Tab, int n, int s, typename T>
__device__ __forceinline__ void dense_output(T th, const T* u, const T* ucand,
                                             const T (&k)[s][n],
                                             const T* fend, T dt_step,
                                             T* v) {
  if constexpr (Tab::free_interp) {
    T w[s];
    Tab::template bpoly<A>(th, w);
#pragma unroll
    for (int c = 0; c < n; ++c) {
      T incr = T(0);
#pragma unroll
      for (int q = 0; q < s; ++q)
        incr = accumulate<A>(incr, A::mul(w[q], k[q][c]), q == 0);
      v[c] = A::add(u[c], A::mul(dt_step, incr));
    }
  } else {
    const T om = A::sub(T(1), th);
    const T h00 = A::mul(A::add(T(1), A::mul(T(2), th)), A::mul(om, om));
    const T h10 = A::mul(th, A::mul(om, om));
    const T h01 = A::mul(A::mul(th, th), A::sub(T(3), A::mul(T(2), th)));
    const T h11 = A::mul(A::mul(th, th), A::sub(th, T(1)));
#pragma unroll
    for (int c = 0; c < n; ++c)
      v[c] = A::add(A::add(A::add(A::mul(h00, u[c]),
                                  A::mul(A::mul(h10, dt_step), k[0][c])),
                           A::mul(h01, ucand[c])),
                    A::mul(A::mul(h11, dt_step), fend[c]));
  }
}

// ---------------------------------------------------------------------------
// Device right-hand sides (src/repro_torch/configs/de_problems.py), in the
// Python functions' operation order, under the kernel's policy A (only
// Lorenz has a product that may fuse into a sum).
// ---------------------------------------------------------------------------

struct Lorenz {
  static constexpr int n = 3, m = 3;
  template <class A, typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T t,
                                              T* du) {
    const T sigma = p[0], rho = p[1], beta = p[2];
    const T x = u[0], y = u[1], z = u[2];
    du[0] = A::mul(sigma, A::sub(y, x));
    du[1] = A::sub(A::sub(A::mul(rho, x), y), A::mul(x, z));
    du[2] = A::sub(A::mul(x, y), A::mul(beta, z));
  }
};

struct Sho {
  static constexpr int n = 2, m = 1;
  template <class A, typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T t,
                                              T* du) {
    du[0] = u[1];
    du[1] = -(p[0] * p[0]) * u[0];
  }
};

// The bouncing ball, u = (x, v), p = (g, e): (v, -g).
struct Ball {
  static constexpr int n = 2, m = 2;
  template <class A, typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T t,
                                              T* du) {
    du[0] = u[1];
    du[1] = -p[0];
  }
};

// Linear decay: -lam u (one multiply, rounded alike in both kernels).
struct Decay {
  static constexpr int n = 1, m = 1;
  template <class A, typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T t,
                                              T* du) {
    du[0] = -p[0] * u[0];
  }
};

// The forced oscillator, the data-driven demo problem (paper §6.7):
// u = (x, v), p = (k, c), (v, -k x - c v + F(t)) with the drive F read from
// the table data["force"] in mode `Mode` (interp.cuh), every operation
// rounded on its own.
template <int Mode>
struct ForcedOsc {
  static constexpr int n = 2, m = 2;
  repro_data::Leaf force;
  __device__ __forceinline__ explicit ForcedOsc(const repro_data::Tables& d)
      : force(d.leaf[0]) {}
  template <class A, typename T>
  __device__ __forceinline__ void eval(const T* u, const T* p, T t,
                                       T* du) const {
    using namespace repro_arith;
    const T F = repro_data::interp1d<Mode, Rounded>(
        repro_data::Table1D<T>(force), t);
    du[0] = u[1];
    du[1] = radd(rsub(rmul(-p[0], u[0]), rmul(p[1], u[1])), F);
  }
};

// PI controller constants: `PIController.for_order(embedded_order)`.
struct Ctrl {
  static constexpr double safety = 0.9, qmin = 0.2, qmax = 10.0,
                          dtmin = 1e-12;
};

template <typename T, class Tab, class Rhs, class Ev,
          class Dat = repro_data::NoData>
__global__ void __launch_bounds__(kBlock)
    erk_ensemble_kernel(const T* __restrict__ u0, const T* __restrict__ p,
                        const T* __restrict__ saveat, int S, int N, T t0, T tf,
                        T dt0, T rtol, T atol, int adaptive,
                        long long max_iters, repro_ev::Config evc, Dat dat,
                        T* __restrict__ us, T* __restrict__ u_final,
                        T* __restrict__ t_final, int* __restrict__ stats) {
  constexpr int n = Rhs::n, m = Rhs::m, s = Tab::stages;
  constexpr double k_ord = Tab::embedded_order + 1.0;
  constexpr double beta1 = 0.7 / k_ord, beta2 = 0.4 / k_ord;
  using A = std::conditional_t<Ev::enabled || Dat::enabled || Tab::rounded,
                               repro_arith::Rounded, repro_arith::Contracting>;
  const Rhs rhs = repro_data::bind<Rhs>(dat);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t NN = static_cast<size_t>(N);

  T u[n], pp[m];
#pragma unroll
  for (int c = 0; c < n; ++c) u[c] = u0[c * NN + lane];
#pragma unroll
  for (int j = 0; j < m; ++j) pp[j] = p[j * NN + lane];

  auto store_save = [&](int j, const T* v) {
#pragma unroll
    for (int c = 0; c < n; ++c) us[(static_cast<size_t>(j) * n + c) * NN + lane] = v[c];
  };

  T k[s][n];
  T t = t0, dt = dt0, enorm_prev = T(1);
  rhs.template eval<A>(u, pp, t, k[0]);
  int naccept = 0, nreject = 0, nf = 1, status = 0;
  bool done = false;

  // save points at or before t0 hold u0; `cur` is the first save > t
  int cur = 0;
  while (cur < S && saveat[cur] <= t0) store_save(cur++, u);
  int hi = cur;  // saves [0, hi) have been written

  const T eps_end = A::mul(T(1e-7), nmax(fabs(tf), T(1)));
  const T dtmin = T(Ctrl::dtmin);

  for (long long it = 0; !done && it < max_iters; ++it) {
    const T dt_step = nmin(dt, A::sub(tf, t));

    // ---- one embedded step: stages 1..s-1, then b and btilde sums --------
    T bsum[n], esum[n];  // the streamed sums
    if constexpr (Tab::stream_sums) {
#pragma unroll
      for (int c = 0; c < n; ++c) bsum[c] = esum[c] = T(0);
      add_weights<A, Tab, 0>(bsum, esum, k[0]);
    }
    static_for<1, s>([&](auto ii) {
      constexpr int i = decltype(ii)::value;
      T ui[n];
#pragma unroll
      for (int c = 0; c < n; ++c) {
        T acc = T(0);
        bool first = true;
        static_for<0, i>([&](auto jj) {
          constexpr int j = decltype(jj)::value;
          constexpr double aij = Tab::a(i, j);
          if constexpr (aij != 0.0) {
            acc = accumulate<A>(acc, A::mul(T(aij), k[j][c]), first);
            first = false;
          }
        });
        ui[c] = A::add(u[c], A::mul(dt_step, acc));
      }
      constexpr double ci = Tab::c(i);
      rhs.template eval<A>(ui, pp, A::add(t, A::mul(T(ci), dt_step)),
                           k[i]);
      if constexpr (Tab::stream_sums)
        add_weights<A, Tab, i>(bsum, esum, k[i]);
    });
    T ucand[n], err[n];
    if constexpr (Tab::stream_sums) {
#pragma unroll
      for (int c = 0; c < n; ++c) {
        ucand[c] = A::add(u[c], A::mul(dt_step, bsum[c]));
        err[c] = A::mul(dt_step, esum[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < n; ++c) {
        T bacc = T(0), eacc = T(0);
        bool bfirst = true, efirst = true;
        static_for<0, s>([&](auto jj) {
          constexpr int j = decltype(jj)::value;
          constexpr double bj = Tab::b(j), ej = Tab::btilde(j);
          if constexpr (bj != 0.0) {
            bacc = accumulate<A>(bacc, A::mul(T(bj), k[j][c]), bfirst);
            bfirst = false;
          }
          if constexpr (ej != 0.0) {
            eacc = accumulate<A>(eacc, A::mul(T(ej), k[j][c]), efirst);
            efirst = false;
          }
        });
        ucand[c] = A::add(u[c], A::mul(dt_step, bacc));
        err[c] = A::mul(dt_step, eacc);
      }
    }

    // ---- error control ---------------------------------------------------
    bool accept = true;
    T dt_next = dt, ep_next = enorm_prev;
    if (adaptive) {
      T sum = T(0);
      bool finite = true;
#pragma unroll
      for (int c = 0; c < n; ++c) {
        const T sc = A::add(atol, A::mul(nmax(fabs(u[c]), fabs(ucand[c])),
                                         rtol));
        const T r = A::div(err[c], sc);
        sum = accumulate<A>(sum, A::mul(r, r), c == 0);
        finite = finite && isfinite(ucand[c]);
      }
      const T enorm = sqrt(A::div(sum, T(n)));
      accept = (enorm <= T(1)) && finite;
      const T e = isfinite(enorm) ? nmax(enorm, T(1e-10)) : T(1e10);
      const T ep = nmax(enorm_prev, T(1e-10));
      const T pe = A::mul(T(Ctrl::safety), T(pow(e, T(-beta1))));
      const T fac = accept ? clip(A::mul(pe, T(pow(ep, T(beta2)))),
                                  T(Ctrl::qmin), T(Ctrl::qmax))
                           : clip(pe, T(Ctrl::qmin), T(1));
      dt_next = nmax(A::mul(dt, fac), dtmin);
      ep_next = accept ? e : enorm_prev;
    }
    const T t_end = A::add(t, dt_step);
    T t_new = accept ? t_end : t;
    bool stop = false;  // a terminal event

    if (accept) {
      // f(u_new): the last stage by FSAL, else evaluated once, for
      // Hermite's dense output and as the next step's k1
      T fnew[n];
      if constexpr (!Tab::fsal) rhs.template eval<A>(ucand, pp, t_end, fnew);
      auto interp = [&](T th, T* v) {
        if constexpr (Tab::fsal)
          dense_output<A, Tab, n, s>(th, u, ucand, k, k[s - 1], dt_step, v);
        else
          dense_output<A, Tab, n, s>(th, u, ucand, k, fnew, dt_step, v);
      };
      T unext[n];
      if constexpr (Ev::enabled) {
        // ---- the event: a hit truncates the step at the located time ---
        T t_ev;
        const bool hit = repro_ev::handle_event<Ev, A, n>(
            evc, interp, u, ucand, pp, t, dt_step, t_new, unext, t_ev);
        t_new = t_ev;
        stop = hit && evc.terminal;
      }

      // ---- dense output onto every save point this step crossed ----------
      const T eps = A::mul(T(1e-7), nmax(fabs(t_new), T(1)));
      const T step = dt_step == T(0) ? T(1) : dt_step;
      int j = cur;
      for (; j < S && saveat[j] <= A::add(t_new, eps); ++j) {
        T v[n];
        interp(clip(A::div(A::sub(saveat[j], t), step), T(0), T(1)), v);
        store_save(j, v);
      }
      hi = j > hi ? j : hi;
      while (cur < S && saveat[cur] <= t_new) ++cur;

      if constexpr (Ev::enabled) {
        // FSAL is off: the event may have moved the state
#pragma unroll
        for (int c = 0; c < n; ++c) u[c] = unext[c];
        rhs.template eval<A>(u, pp, t_new, k[0]);
      } else if constexpr (Tab::fsal) {
#pragma unroll
        for (int c = 0; c < n; ++c) {
          u[c] = ucand[c];
          k[0][c] = k[s - 1][c];  // FSAL
        }
      } else {
#pragma unroll
        for (int c = 0; c < n; ++c) {
          u[c] = ucand[c];
          k[0][c] = fnew[c];
        }
      }
      ++naccept;
    } else {
      ++nreject;
    }
    nf += (Ev::enabled || !Tab::fsal) ? s : s - 1;

    // dt pinned at the controller floor and still rejecting: the retry is a
    // deterministic live-lock, so the trajectory ends with status 2
    const bool hopeless = adaptive && !accept && !(dt_step > dtmin);
    if (hopeless) status = 2;
    done = stop || (t_new >= A::sub(tf, eps_end)) || hopeless;
    t = t_new;
    dt = dt_next;
    enorm_prev = ep_next;
  }

  const T zero[n] = {};
  for (int j = hi; j < S; ++j) store_save(j, zero);
#pragma unroll
  for (int c = 0; c < n; ++c) u_final[c * NN + lane] = u[c];
  t_final[lane] = t;
  stats[0 * NN + lane] = naccept;
  stats[1 * NN + lane] = nreject;
  stats[2 * NN + lane] = status > 0 ? status : (done ? 0 : 1);
  stats[3 * NN + lane] = nf;
  stats[4 * NN + lane] = 0;
  stats[5 * NN + lane] = 0;
}

struct LaunchArgs {
  const void* u0;
  const void* p;
  const void* saveat;
  int S;
  int N;
  double t0, tf, dt0, rtol, atol;
  int adaptive;
  long long max_iters;
  repro_ev::Config ev;
  void* us;
  void* u_final;
  void* t_final;
  void* stats;
  cudaStream_t stream;
  repro_data::Tables data;  // the data forms' tables
};

template <typename T, class Tab, class Rhs, class Ev,
          class Dat = repro_data::NoData>
int launch(const LaunchArgs& a) {
  const int grid = (a.N + kBlock - 1) / kBlock;
  Dat dat{};
  if constexpr (Dat::enabled) dat = a.data;
  erk_ensemble_kernel<T, Tab, Rhs, Ev, Dat><<<grid, kBlock, 0, a.stream>>>(
      static_cast<const T*>(a.u0), static_cast<const T*>(a.p),
      static_cast<const T*>(a.saveat), a.S, a.N, T(a.t0), T(a.tf), T(a.dt0),
      T(a.rtol), T(a.atol), a.adaptive, a.max_iters, a.ev, dat,
      static_cast<T*>(a.us), static_cast<T*>(a.u_final),
      static_cast<T*>(a.t_final), static_cast<int*>(a.stats));
  return static_cast<int>(cudaGetLastError());
}

// K2 (the staged driver, kernels/ensemble_kernel.py
// `run_ensemble_kernel_staged`): k launches in one call, so the host pays
// for one.  Segment i integrates from t0s[i] to tfs[i] and saves on
// saveat[starts[i], starts[i + 1]) into its slice of `us` (S, n, N); it
// writes its stats into block i of `stats` (k, 6, N) and its final state
// into the next segment's initial one (u_mid[0] and u_mid[1] in turns; the
// last into `u_final`).  `a` holds what every segment shares; `one`
// launches a segment's form.
template <class One>
int launch_segments(const LaunchArgs& a, int n, int item, int k,
                    const double* t0s, const double* tfs, const int* starts,
                    void* u_mid0, void* u_mid1, One&& one) {
  const size_t N = static_cast<size_t>(a.N);
  void* mids[2] = {u_mid0, u_mid1};
  for (int i = 0; i < k; ++i) {
    LaunchArgs s = a;
    s.t0 = t0s[i];
    s.tf = tfs[i];
    s.S = starts[i + 1] - starts[i];
    s.saveat = static_cast<const char*>(a.saveat) +
               static_cast<size_t>(starts[i]) * item;
    s.us = static_cast<char*>(a.us) +
           static_cast<size_t>(starts[i]) * n * N * item;
    s.stats = static_cast<int*>(a.stats) + static_cast<size_t>(i) * 6 * N;
    if (i) s.u0 = mids[(i - 1) % 2];
    if (i < k - 1) s.u_final = mids[i % 2];
    const int rc = one(s);
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename T, class Tab>
int by_rhs(int rhs_id, const LaunchArgs& a) {
  switch (rhs_id) {
    case 0: return launch<T, Tab, Lorenz, repro_ev::NoEvent>(a);
    case 1: return launch<T, Tab, Sho, repro_ev::NoEvent>(a);
    case 2: return launch<T, Tab, Ball, repro_ev::NoEvent>(a);
    case 3: return launch<T, Tab, Decay, repro_ev::NoEvent>(a);
  }
  return -1;
}

}  // namespace repro_erk
