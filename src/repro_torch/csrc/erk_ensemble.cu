// Fused whole-integration ensemble kernel for explicit Runge-Kutta pairs
// (the paper's EnsembleGPUKernel, §5.2), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `run_ensemble_kernel` + `erk_body` of
// src/repro/kernels/ensemble_kernel.py (pallas_call at :282, body at :461):
// adaptive embedded-RK integration of every trajectory from t0 to tf with
// FSAL, per-trajectory PI step control, a finite check on every candidate,
// STATUS_DTMIN_EXHAUSTED detection, dense output onto a `saveat` grid (the
// tableau's free interpolant, or cubic Hermite when it has none), and the
// 6-row stats block (naccept, nreject, status, nf, njac, nfact).  With
// adaptive == 0 the same kernel is the fixed-dt form: error norm 0, every
// step accepted, dt unchanged.
//
// Design: one trajectory per thread, the paper's design.  A thread loads
// its u0 and p columns from the lane-major (n, N) / (m, N) inputs (adjacent
// threads read adjacent addresses), keeps the state, the 7 stages, t, dt,
// the controller memory and the counters in registers, runs its own
// `while (!done && iters < max_iters)` loop and retires on its own.  Save
// points are written lane-major (S, n, N) when they are crossed, so the
// stores coalesce.  The tableau and the right-hand side are template
// parameters: the coefficients are compile-time constants, zero
// coefficients vanish at compile time and the stage loop is unrolled.
//
// What bounds it on an H100: arithmetic, not bytes.  Only u0, p, the saves
// and the final values touch HBM (about 124 bytes per trajectory for Lorenz
// in float32 with 5 saves), while every attempted step costs a few hundred
// FP32/FP64 operations plus two pow calls, all in registers.  The design
// answers this by keeping everything per-step in registers and by letting
// no thread wait on another's step control; what it does not yet address
// is warp divergence (a warp runs until its slowest trajectory retires),
// which a later PR can attack by sorting or regrouping trajectories.
//
// Semantics follow the reference loop body
// (src/repro/core/solvers.py `_make_adaptive_body`) exactly: constants are
// rounded to T before use, zero coefficients are skipped, dt_step =
// min(dt, tf - t), accept needs enorm <= 1 and a finite candidate, a
// non-finite enorm counts as 1e10, save point s is written when
// t_old < s <= t_new + 1e-7*max(|t_new|, 1) on an accepted step, and save
// points at or before t0 hold u0.  The wrapper guarantees an ascending
// save grid, which lets each thread keep a cursor instead of scanning it.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// Tableaus (src/repro_torch/core/tableaus.py; a test holds these equal).
// The arrays are locals of constexpr functions so that device code may read
// them in constant expressions.
// ---------------------------------------------------------------------------

struct Tsit5 {
  static constexpr int stages = 7;
  static constexpr bool free_interp = true;
  static constexpr int embedded_order = 4;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[7][7] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.161, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-0.008480655492356989, 0.335480655492357, 0.0, 0.0, 0.0, 0.0, 0.0},
        {2.8971530571054935, -6.359448489975075, 4.3622954328695815, 0.0, 0.0,
         0.0, 0.0},
        {5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525, 0.0, 0.0, 0.0},
        {5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.07158497328140101, -0.028269050394068383, 0.0, 0.0},
        {0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[7] = {0.09646076681806523, 0.01, 0.4798896504144996,
                             1.379008574103742,   -3.290069515436081,
                             2.324710524099774,   0.0};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[7] = {-0.001780011052225777, -0.0008164344596567469,
                              0.007880878010261995,  -0.1447110071732629,
                              0.5823571654525552,    -0.45808210592918697,
                              0.015151515151515152};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[7] = {0.0, 0.161, 0.327, 0.9, 0.9800255409045097,
                             1.0, 1.0};
    return C[i];
  }
};

struct Dopri5 {
  static constexpr int stages = 7;
  static constexpr bool free_interp = false;
  static constexpr int embedded_order = 4;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[7][7] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.075, 0.225, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.9777777777777777, -3.7333333333333334, 3.5555555555555554, 0.0, 0.0,
         0.0, 0.0},
        {2.9525986892242035, -11.595793324188385, 9.822892851699436,
         -0.2908093278463649, 0.0, 0.0, 0.0},
        {2.8462752525252526, -10.757575757575758, 8.906422717743473,
         0.2784090909090909, -0.2735313036020583, 0.0, 0.0},
        {0.09114583333333333, 0.0, 0.44923629829290207, 0.6510416666666666,
         -0.322376179245283, 0.13095238095238096, 0.0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[7] = {0.09114583333333333, 0.0, 0.44923629829290207,
                             0.6510416666666666,  -0.322376179245283,
                             0.13095238095238096, 0.0};
    return B[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double BT[7] = {0.0012326388888888873, 0.0,
                              -0.004252770290506136, 0.036979166666666674,
                              -0.05086379716981132,  0.04190476190476192,
                              -0.025};
    return BT[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[7] = {0.0, 0.2, 0.3, 0.8, 0.8888888888888888, 1.0, 1.0};
    return C[i];
  }
};

// Tsitouras' free interpolant weights b_i(theta), in the reference's
// operation order (src/repro_torch/core/tableaus.py `_tsit5_bpoly`).
template <typename T>
__device__ __forceinline__ void tsit5_bpoly(T t, T w[7]) {
  w[0] = T(-1.0530884977290216) * t * (t - T(1.3299890189751412)) *
         (t * t - T(1.4364028541716351) * t + T(0.7139816917074209));
  w[1] = T(0.1017) * t * t *
         (t * t - T(2.1966568338249754) * t + T(1.2949852507374631));
  w[2] = T(2.490627285651252793) * t * t *
         (t * t - T(2.38535645472061657) * t + T(1.57803468208092486));
  w[3] = T(-16.54810288924490272) * (t - T(1.21712927295533244)) *
         (t - T(0.61620406037800089)) * t * t;
  w[4] = T(47.37952196281928122) * (t - T(1.203071208372362603)) *
         (t - T(0.658047292653547382)) * t * t;
  w[5] = T(-34.87065786149660974) * (t - T(1.2)) * (t - T(2.0 / 3.0)) * t * t;
  w[6] = T(2.5) * (t - T(1.0)) * (t - T(0.6)) * t * t;
}

// ---------------------------------------------------------------------------
// Device right-hand sides (src/repro_torch/configs/de_problems.py), in the
// Python functions' operation order.
// ---------------------------------------------------------------------------

struct Lorenz {
  static constexpr int n = 3, m = 3;
  template <typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T t,
                                              T* du) {
    const T sigma = p[0], rho = p[1], beta = p[2];
    const T x = u[0], y = u[1], z = u[2];
    du[0] = sigma * (y - x);
    du[1] = rho * x - y - x * z;
    du[2] = x * y - beta * z;
  }
};

struct Sho {
  static constexpr int n = 2, m = 1;
  template <typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T t,
                                              T* du) {
    du[0] = u[1];
    du[1] = -(p[0] * p[0]) * u[0];
  }
};

// PI controller constants: `PIController.for_order(embedded_order)`.
struct Ctrl {
  static constexpr double safety = 0.9, qmin = 0.2, qmax = 10.0,
                          dtmin = 1e-12;
};

template <typename T, class Tab, class Rhs>
__global__ void __launch_bounds__(kBlock)
    erk_ensemble_kernel(const T* __restrict__ u0, const T* __restrict__ p,
                        const T* __restrict__ saveat, int S, int N, T t0, T tf,
                        T dt0, T rtol, T atol, int adaptive,
                        long long max_iters, T* __restrict__ us,
                        T* __restrict__ u_final, T* __restrict__ t_final,
                        int* __restrict__ stats) {
  static_assert(Tab::stages == 7, "tsit5 and dopri5 have 7 stages");
  constexpr int n = Rhs::n, m = Rhs::m, s = Tab::stages;
  constexpr double k_ord = Tab::embedded_order + 1.0;
  constexpr double beta1 = 0.7 / k_ord, beta2 = 0.4 / k_ord;

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
  Rhs::eval(u, pp, t, k[0]);
  int naccept = 0, nreject = 0, nf = 1, status = 0;
  bool done = false;

  // save points at or before t0 hold u0; `cur` is the first save > t
  int cur = 0;
  while (cur < S && saveat[cur] <= t0) store_save(cur++, u);
  int hi = cur;  // saves [0, hi) have been written

  const T eps_end = T(1e-7) * nmax(fabs(tf), T(1));
  const T dtmin = T(Ctrl::dtmin);

  for (long long it = 0; !done && it < max_iters; ++it) {
    const T dt_step = nmin(dt, tf - t);

    // ---- one embedded step: stages 1..s-1, then b and btilde sums --------
    static_for<1, s>([&](auto ii) {
      constexpr int i = decltype(ii)::value;
      T ui[n];
#pragma unroll
      for (int c = 0; c < n; ++c) {
        T acc = T(0);
        static_for<0, i>([&](auto jj) {
          constexpr int j = decltype(jj)::value;
          constexpr double aij = Tab::a(i, j);
          if constexpr (aij != 0.0) acc = acc + T(aij) * k[j][c];
        });
        ui[c] = u[c] + dt_step * acc;
      }
      constexpr double ci = Tab::c(i);
      Rhs::eval(ui, pp, t + T(ci) * dt_step, k[i]);
    });
    T ucand[n], err[n];
#pragma unroll
    for (int c = 0; c < n; ++c) {
      T bacc = T(0), eacc = T(0);
      static_for<0, s>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        constexpr double bj = Tab::b(j), ej = Tab::btilde(j);
        if constexpr (bj != 0.0) bacc = bacc + T(bj) * k[j][c];
        if constexpr (ej != 0.0) eacc = eacc + T(ej) * k[j][c];
      });
      ucand[c] = u[c] + dt_step * bacc;
      err[c] = dt_step * eacc;
    }

    // ---- error control ---------------------------------------------------
    bool accept = true;
    T dt_next = dt, ep_next = enorm_prev;
    if (adaptive) {
      T sum = T(0);
      bool finite = true;
#pragma unroll
      for (int c = 0; c < n; ++c) {
        const T sc = atol + nmax(fabs(u[c]), fabs(ucand[c])) * rtol;
        const T r = err[c] / sc;
        sum = sum + r * r;
        finite = finite && isfinite(ucand[c]);
      }
      const T enorm = sqrt(sum / T(n));
      accept = (enorm <= T(1)) && finite;
      const T e = isfinite(enorm) ? nmax(enorm, T(1e-10)) : T(1e10);
      const T ep = nmax(enorm_prev, T(1e-10));
      const T pe = T(Ctrl::safety) * pow(e, T(-beta1));
      const T fac = accept ? clip(pe * pow(ep, T(beta2)), T(Ctrl::qmin),
                                  T(Ctrl::qmax))
                           : clip(pe, T(Ctrl::qmin), T(1));
      dt_next = nmax(dt * fac, dtmin);
      ep_next = accept ? e : enorm_prev;
    }
    const T t_new = accept ? t + dt_step : t;

    if (accept) {
      // ---- dense output onto every save point this step crossed ----------
      const T eps = T(1e-7) * nmax(fabs(t_new), T(1));
      const T step = dt_step == T(0) ? T(1) : dt_step;
      int j = cur;
      for (; j < S && saveat[j] <= t_new + eps; ++j) {
        const T th = clip((saveat[j] - t) / step, T(0), T(1));
        T v[n];
        if constexpr (Tab::free_interp) {
          T w[7];
          tsit5_bpoly(th, w);
#pragma unroll
          for (int c = 0; c < n; ++c) {
            T incr = T(0);
#pragma unroll
            for (int q = 0; q < s; ++q) incr = incr + w[q] * k[q][c];
            v[c] = u[c] + dt_step * incr;
          }
        } else {
          // cubic Hermite on (u, k1, u_cand, f(u_cand) = k[s-1] by FSAL)
          const T om = T(1) - th;
          const T h00 = (T(1) + T(2) * th) * (om * om);
          const T h10 = th * (om * om);
          const T h01 = (th * th) * (T(3) - T(2) * th);
          const T h11 = (th * th) * (th - T(1));
#pragma unroll
          for (int c = 0; c < n; ++c)
            v[c] = h00 * u[c] + h10 * dt_step * k[0][c] + h01 * ucand[c] +
                   h11 * dt_step * k[s - 1][c];
        }
        store_save(j, v);
      }
      hi = j > hi ? j : hi;
      while (cur < S && saveat[cur] <= t_new) ++cur;

#pragma unroll
      for (int c = 0; c < n; ++c) {
        u[c] = ucand[c];
        k[0][c] = k[s - 1][c];  // FSAL
      }
      ++naccept;
    } else {
      ++nreject;
    }
    nf += s - 1;

    // dt pinned at the controller floor and still rejecting: the retry is a
    // deterministic live-lock, so the trajectory ends with status 2
    const bool hopeless = adaptive && !accept && !(dt_step > dtmin);
    if (hopeless) status = 2;
    done = (t_new >= tf - eps_end) || hopeless;
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
  void* us;
  void* u_final;
  void* t_final;
  void* stats;
  cudaStream_t stream;
};

template <typename T, class Tab, class Rhs>
int launch(const LaunchArgs& a) {
  const int grid = (a.N + kBlock - 1) / kBlock;
  erk_ensemble_kernel<T, Tab, Rhs><<<grid, kBlock, 0, a.stream>>>(
      static_cast<const T*>(a.u0), static_cast<const T*>(a.p),
      static_cast<const T*>(a.saveat), a.S, a.N, T(a.t0), T(a.tf), T(a.dt0),
      T(a.rtol), T(a.atol), a.adaptive, a.max_iters, static_cast<T*>(a.us),
      static_cast<T*>(a.u_final), static_cast<T*>(a.t_final),
      static_cast<int*>(a.stats));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class Tab>
int by_rhs(int rhs_id, const LaunchArgs& a) {
  switch (rhs_id) {
    case 0: return launch<T, Tab, Lorenz>(a);
    case 1: return launch<T, Tab, Sho>(a);
  }
  return -1;
}

template <typename T>
int by_tableau(int tab_id, int rhs_id, const LaunchArgs& a) {
  switch (tab_id) {
    case 0: return by_rhs<T, Tsit5>(rhs_id, a);
    case 1: return by_rhs<T, Dopri5>(rhs_id, a);
  }
  return -1;
}

}  // namespace repro_erk

// C interface, bound with ctypes by src/repro_torch/kernels/tsit5/kernel.py.
// dtype_id: 0 float32, 1 float64.  tab_id: 0 tsit5, 1 dopri5.  rhs_id: 0
// lorenz, 1 sho.  Returns cudaGetLastError() after the launch, or -1 for an
// unknown id.  Launches on `stream` and does not synchronise.
extern "C" int erk_ensemble_launch(int dtype_id, int tab_id, int rhs_id,
                                   const void* u0, const void* p,
                                   const void* saveat, int S, int N, double t0,
                                   double tf, double dt0, double rtol,
                                   double atol, int adaptive,
                                   long long max_iters, void* us,
                                   void* u_final, void* t_final, void* stats,
                                   void* stream) {
  const repro_erk::LaunchArgs a{u0,   p,         saveat,  S,       N,
                     t0,   tf,        dt0,     rtol,    atol,
                     adaptive, max_iters, us,  u_final, t_final,
                     stats, static_cast<cudaStream_t>(stream)};
  switch (dtype_id) {
    case 0: return repro_erk::by_tableau<float>(tab_id, rhs_id, a);
    case 1: return repro_erk::by_tableau<double>(tab_id, rhs_id, a);
  }
  return -1;
}
