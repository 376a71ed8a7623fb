// The body of the fused Rosenbrock stiff ensemble kernel (K3): its
// helpers, the Rosenbrock tableaus, the step controller's constants, the
// kernel and its launch, moved unchanged out of `rosenbrock_ensemble.cu`
// (which says what the kernel replaces, what bounds it and how it is
// built) so that a translation unit generated by `repro_torch.translate`
// (`units.py`) instantiates the same kernel with a generated right-hand
// side.  A right-hand side functor `Rhs` gives n, m and the members
// `eval(u, p, t, du)`, `jac(u, p, t, J)` and `eval_dfdt(u, p, t, du, d)`.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "events.cuh"
#include "interp.cuh"
#include "lu_lanes.cuh"

namespace repro_rb {

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
// Rosenbrock tableaus in implementation form
// (src/repro_torch/core/tableaus.py; a test parses these literals and holds
// them bitwise equal): gamma, a, C, b, btilde, c, d, interp_h as `h`, and
// the folded products gC = γ·C and gd = γ·d.  17 significant digits, so
// every literal round-trips.
// ---------------------------------------------------------------------------

struct Ros23w {
  static constexpr int stages = 3;
  static constexpr int n_interp = 0;  // rows of interp_h (0: Hermite)
  static constexpr bool fnew_from_last_stage = true;
  static constexpr double gamma = 0.29289321881345248;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double M[3][3] = {
        {0.0, 0.0, 0.0},
        {1.7071067811865477, 4.9617637573953109e-17, 0.0},
        {3.4142135623730954, 3.4142135623730954, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double C(int i, int j) {
    constexpr double M[3][3] = {
        {-4.4408920985006262e-16, -9.9235275147906217e-17, 0.0},
        {-3.4142135623730954, -4.4408920985006262e-16, 0.0},
        {-6.828427124746189, -25.313708498984759, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double gC(int i, int j) {
    constexpr double M[3][3] = {
        {-1.3007071811330761e-16, -2.906533915790886e-17, 0.0},
        {-1.0000000000000002, -1.3007071811330761e-16, 0.0},
        {-1.9999999999999998, -7.4142135623730949, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double V[3] = {3.4142135623730954, 3.4142135623730954, 0.0};
    return V[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double V[3] = {-0.56903559372884882, -3.0808802290397614, -0.56903559372884915};
    return V[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double V[3] = {0.0, 0.5, 1.0};
    return V[i];
  }
  __host__ __device__ static constexpr double d(int i) {
    constexpr double V[3] = {0.29289321881345248, 0.0, -0.29289321881345237};
    return V[i];
  }
  __host__ __device__ static constexpr double gd(int i) {
    constexpr double V[3] = {0.085786437626904952, 0.0, -0.085786437626904924};
    return V[i];
  }
  __host__ __device__ static constexpr double h(int, int) { return 0.0; }
};

struct Rodas4 {
  static constexpr int stages = 6;
  static constexpr int n_interp = 2;  // rows of interp_h (0: Hermite)
  static constexpr bool fnew_from_last_stage = false;
  static constexpr double gamma = 0.25;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double M[6][6] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {1.544, 0.0, 0.0, 0.0, 0.0, 0.0},
        {0.94667852808158259, 0.25570116989832842, 0.0, 0.0, 0.0, 0.0},
        {3.314825187068521, 2.8961240159722008, 0.99864191399778168, 0.0, 0.0, 0.0},
        {1.2212245092266409, 6.0191344812886287, 12.53708332932087, -0.68788603610589505, 0.0, 0.0},
        {1.2212245092266409, 6.0191344812886287, 12.53708332932087, -0.68788603610589505, 1.0, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double C(int i, int j) {
    constexpr double M[6][6] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-5.6688000000000001, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-2.4300933568338752, -0.20635991570919149, 0.0, 0.0, 0.0, 0.0},
        {-0.1073529058151375, -9.5945622510233548, -20.470286148096161, 0.0, 0.0, 0.0},
        {7.4964433139676467, -10.246804314643519, -33.999903528199049, 11.7089089320616, 0.0, 0.0},
        {8.0832467959215215, -7.9811329880648927, -31.52159432874371, 16.31930543123136, -6.0588182388340543, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double gC(int i, int j) {
    constexpr double M[6][6] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-1.4172, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-0.60752333920846879, -0.051589978927297872, 0.0, 0.0, 0.0, 0.0},
        {-0.026838226453784374, -2.3986405627558387, -5.1175715370240402, 0.0, 0.0, 0.0},
        {1.8741108284919117, -2.5617010786608798, -8.4999758820497622, 2.9272272330154001, 0.0, 0.0},
        {2.0208116989803804, -1.9952832470162232, -7.8803985821859275, 4.07982635780784, -1.5147045597085136, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double V[6] = {1.2212245092266409, 6.0191344812886287, 12.53708332932087, -0.68788603610589505, 1.0, 1.0};
    return V[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double V[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 1.0};
    return V[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double V[6] = {0.0, 0.38600000000000001, 0.20999999999999999, 0.63, 1.0, 1.0};
    return V[i];
  }
  __host__ __device__ static constexpr double d(int i) {
    constexpr double V[6] = {0.25, -0.1043, 0.10349999999999999, -0.036200000000000232, 0.0, 0.0};
    return V[i];
  }
  __host__ __device__ static constexpr double gd(int i) {
    constexpr double V[6] = {0.0625, -0.026075000000000001, 0.025874999999999999, -0.009050000000000058, 0.0, 0.0};
    return V[i];
  }
  __host__ __device__ static constexpr double h(int i, int j) {
    constexpr double M[2][6] = {
        {10.126235083445859, -7.4879958776101674, -34.800918615557471, -7.9927717075688234, 1.025137723295662, 0.0},
        {-0.67628033928012532, 6.0877146516800149, 16.430843208924781, 24.767225114183859, -6.5943891257168721, 0.0}};
    return M[i][j];
  }
};

struct Rodas5p {
  static constexpr int stages = 8;
  static constexpr int n_interp = 0;  // rows of interp_h (0: Hermite)
  static constexpr bool fnew_from_last_stage = false;
  static constexpr double gamma = 0.21193756319429014;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double M[8][8] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {3.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {2.8493943797479391, 0.45842242204463923, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-6.9540285098091008, 2.489845061869568, -10.358996098473584, 0.0, 0.0, 0.0, 0.0, 0.0},
        {2.8029986275628964, 0.5072464736228206, -0.3988312541770524, -0.047211872304046408, 0.0, 0.0, 0.0, 0.0},
        {-7.5028463993061214, 2.5618461448039191, -11.627539656261098, -0.18268767659942256, 0.030198172008377946, 0.0, 0.0, 0.0},
        {-7.5028463993061214, 2.5618461448039191, -11.627539656261098, -0.18268767659942256, 0.030198172008377946, 1.0, 0.0, 0.0},
        {-7.5028463993061214, 2.5618461448039191, -11.627539656261098, -0.18268767659942256, 0.030198172008377946, 1.0, 1.0, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double C(int i, int j) {
    constexpr double M[8][8] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-14.155112264123755, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-17.97296035885952, -2.8596932954512941, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {147.12150275711716, -1.41221402718213, 71.68940251302358, 0.0, 0.0, 0.0, 0.0, 0.0},
        {165.43517024871676, -0.45928234564911258, 42.909383369586031, -5.9619867215733056, 0.0, 0.0, 0.0, 0.0},
        {24.854864614690072, -3.0009227002832186, 47.493111002076802, 5.5814197821558125, -0.66106918252494706, 0.0, 0.0, 0.0},
        {30.912732140285989, -3.1208243349937974, 77.799546460708925, 34.286460282947829, -19.097331116725623, -28.087943162872662, 0.0, 0.0},
        {37.802771233905631, -3.2571969029072276, 112.26918849496327, 66.934723124404698, -40.066189370910017, -54.667802628779683, -9.4886165230962707, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double gC(int i, int j) {
    constexpr double M[8][8] = {
        {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-2.9999999999999996, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {-3.8091454218442613, -0.60607642852099641, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
        {31.180572787825447, -0.29930119962977564, 15.193677275464838, 0.0, 0.0, 0.0, 0.0, 0.0},
        {35.061926849145557, -0.097339181155030596, 9.0941101495196612, -1.2635689375669612, 0.0, 0.0, 0.0, 0.0},
        {5.2676794399614026, -0.63600824443245441, 10.065574214296088, 1.1829125077945086, -0.1401053916471787, 0.0, 0.0, 0.0},
        {6.5515691214900258, -0.66141990471602641, 16.48864629450361, 7.2665888429257741, -4.0474418203933205, -5.952890229078954, 0.0, 0.0},
        {8.0118272173051679, -0.69032237444614664, 23.794058231422948, 14.185982112070834, -8.4915305417516382, -11.586160874329975, -2.0109942639901015, 0.0}};
    return M[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double V[8] = {-7.5028463993061214, 2.5618461448039191, -11.627539656261098, -0.18268767659942256, 0.030198172008377946, 1.0, 1.0, 1.0};
    return V[i];
  }
  __host__ __device__ static constexpr double btilde(int i) {
    constexpr double V[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0};
    return V[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double V[8] = {0.0, 0.63581268958287041, 0.4095798393397535, 0.97693067250607157, 0.42884036095586642, 1.0, 1.0, 1.0};
    return V[i];
  }
  __host__ __device__ static constexpr double d(int i) {
    constexpr double V[8] = {0.21193756319429014, -0.42387512638858027, -0.3384627126235924, 1.8046452872882734, 2.325825639765069, 0.0, 0.0, 0.0};
    return V[i];
  }
  __host__ __device__ static constexpr double gd(int i) {
    constexpr double V[8] = {0.044917530692733722, -0.089835061385467443, -0.071732962545573473, 0.38247212461793634, 0.49292981850660961, 0.0, 0.0, 0.0};
    return V[i];
  }
  __host__ __device__ static constexpr double h(int, int) { return 0.0; }
};

// ---------------------------------------------------------------------------
// Arithmetic.  Every add, subtract, multiply and divide of this kernel is
// rounded on its own (arith.cuh's `radd` and kin, which nvcc never fuses
// into a multiply-add), as the plain version's tensor operations round
// them; the only library call of a step, pow, is left to nvcc's default
// build, as PyTorch's own pow is.  Kernel and plain version then agree bit
// for bit.
// ---------------------------------------------------------------------------

using repro_arith::radd;
using repro_arith::rdiv;
using repro_arith::rmul;
using repro_arith::rsub;

// The step controller's and the lazy-W policy's numbers, from the wrapper
// (`controller_constants` in src/repro_torch/kernels/rosenbrock/kernel.py).
struct Control {
  double beta1, beta2, safety, qmin, qmax, dtmin, dtmax;
  double dt_rtol, growth, enorm_limit, max_age, secant;
};

// W = I − (dt·γ)·J into f.r, then factor it.
template <typename T, int n>
__device__ __forceinline__ void factor_w(repro_lu::LuFactors<T, n>& f,
                                         const T J[n][n], T gdt) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j)
      f.r[i][j] = rsub(T(i == j ? 1 : 0), rmul(gdt, J[i][j]));
  repro_lu::lu_factor<T, n, true>(f);
}

// Extrapolated-secant (Broyden) touch-up of the cached Jacobian,
// J ← J + gain·(ΔF − J·Δu)·Δuᵀ/(Δuᵀ·Δu), skipped where Δu = 0 or the
// correction is not finite (src/repro/core/rosenbrock.py `_secant_update`);
// the dot products are summed left to right.
template <typename T, int n>
__device__ __forceinline__ void secant_update(T J[n][n], const T* u,
                                              const T* u_prev, const T* F0,
                                              const T* F_prev, T gain) {
  T du[n], r[n];
#pragma unroll
  for (int c = 0; c < n; ++c) du[c] = rsub(u[c], u_prev[c]);
  T nn = rmul(du[0], du[0]);
#pragma unroll
  for (int c = 1; c < n; ++c) nn = radd(nn, rmul(du[c], du[c]));
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T jdu = rmul(J[i][0], du[0]);
#pragma unroll
    for (int j = 1; j < n; ++j) jdu = radd(jdu, rmul(J[i][j], du[j]));
    r[i] = rsub(rsub(F0[i], F_prev[i]), jdu);
  }
  const T den = nn > T(0) ? nn : T(1);
  T corr[n][n];
  bool ok = nn > T(0);
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) {
      corr[i][j] = rdiv(rmul(r[i], du[j]), den);
      ok = ok && isfinite(corr[i][j]);
    }
  if (ok) {
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j)
        J[i][j] = radd(J[i][j], rmul(gain, corr[i][j]));
  }
}

// The event form's dense output of a step: the tableau's interpolant rows
// kd (rodas4), else Hermite's f(u1) (the last stage's, or evaluated), made
// on first use, then u(θ) as the saves compute it.
template <class Tab, class Rhs, int n, int s, typename T>
struct DenseOutput {
  static constexpr int L = Tab::n_interp;
  const Rhs& rhs;
  const T (&U)[s][n];
  const T *u, *ucand, *F0, *Fi, *pp;
  T t, dt_step;
  T kd[L > 0 ? L : 1][n], Fn[n];
  bool ready = false;

  __device__ __forceinline__ void operator()(T th, T* v) {
    if (!ready) {
      ready = true;
      if constexpr (L > 0) {
        static_for<0, L>([&](auto ll) {
          constexpr int l = decltype(ll)::value;
#pragma unroll
          for (int c = 0; c < n; ++c) {
            T acc = T(0);
            static_for<0, s>([&](auto jj) {
              constexpr int j = decltype(jj)::value;
              if constexpr (Tab::h(l, j) != 0.0)
                acc = radd(acc, rmul(T(Tab::h(l, j)), U[j][c]));
            });
            kd[l][c] = acc;
          }
        });
      } else if constexpr (Tab::fnew_from_last_stage) {
#pragma unroll
        for (int c = 0; c < n; ++c) Fn[c] = Fi[c];
      } else {
        rhs.eval(ucand, pp, radd(t, dt_step), Fn);
      }
    }
    const T om = rsub(T(1), th);
    if constexpr (L > 0) {
      const T w = rmul(th, om);
#pragma unroll
      for (int c = 0; c < n; ++c) {
        T inner = kd[L - 1][c];
#pragma unroll
        for (int l = L - 2; l >= 0; --l)
          inner = radd(kd[l][c], rmul(th, inner));
        v[c] = radd(radd(rmul(om, u[c]), rmul(th, ucand[c])),
                    rmul(w, inner));
      }
    } else {
      const T om2 = rmul(om, om), th2 = rmul(th, th);
      const T h00 = rmul(radd(T(1), rmul(T(2), th)), om2);
      const T h10 = rmul(th, om2);
      const T h01 = rmul(th2, rsub(T(3), rmul(T(2), th)));
      const T h11 = rmul(th2, rsub(th, T(1)));
      const T h10dt = rmul(h10, dt_step), h11dt = rmul(h11, dt_step);
#pragma unroll
      for (int c = 0; c < n; ++c)
        v[c] = radd(radd(radd(rmul(h00, u[c]), rmul(h10dt, F0[c])),
                         rmul(h01, ucand[c])),
                    rmul(h11dt, Fn[c]));
    }
  }
};

template <typename T, class Tab, class Rhs, bool WReuse, class Ev,
          class Dat = repro_data::NoData>
__global__ void __launch_bounds__(kBlock)
    rosenbrock_kernel(const T* __restrict__ u0, const T* __restrict__ p,
                      const T* __restrict__ saveat, int S, int N, T t0, T tf,
                      T dt0, T rtol, T atol, long long max_iters,
                      int nf_per_step, Control k, repro_ev::Config evc,
                      Dat dat, T* __restrict__ us,
                      T* __restrict__ u_final, T* __restrict__ t_final,
                      int* __restrict__ stats) {
  constexpr int n = Rhs::n, m = Rhs::m, s = Tab::stages;
  constexpr int L = Tab::n_interp;
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
    for (int c = 0; c < n; ++c)
      us[(static_cast<size_t>(j) * n + c) * NN + lane] = v[c];
  };

  const T gam = T(Tab::gamma);
  const T dtmin = T(k.dtmin), dtmax = T(k.dtmax);
  const T tf_end = rsub(tf, rmul(T(1e-7), nmax(T(fabs(tf)), T(1))));
  T t = t0, dt = dt0, enorm_prev = T(1);
  int naccept = 0, nreject = 0, status = 0, njac = 0, nfact = 0;
  bool done = false;

  // save points at or before t0 hold u0; `cur` is the first save > t
  int cur = 0;
  while (cur < S && saveat[cur] <= t0) store_save(cur++, u);
  int hi = cur;  // saves [0, hi) have been written

  T J[n][n];
  repro_lu::LuFactors<T, n> fac;
  // lazy-W state, carried across steps
  T dt_fact = dt, u_prev[n], F_prev[n];
  int age = 0;
  bool jac_stale = false, was_accept = false;
  if constexpr (WReuse) {
    rhs.jac(u, pp, t, J);
    factor_w<T, n>(fac, J, rmul(dt, gam));
#pragma unroll
    for (int c = 0; c < n; ++c) {
      u_prev[c] = u[c];
      F_prev[c] = T(0);
    }
    njac = nfact = 1;
  }

  for (long long it = 0; !done && it < max_iters; ++it) {
    T dt_step = nmin(dt, rsub(tf, t));
    T F0[n], Td[n];
    rhs.eval_dfdt(u, pp, t, F0, Td);
    bool need_jac = true, need_fact = true;
    if constexpr (WReuse) {
      // w_refresh, then the secant touch-up and the dt freeze
      need_jac = jac_stale;
      const bool drift = rmul(gam, T(fabs(rsub(dt_step, dt_fact)))) >
                         rmul(T(k.dt_rtol), dt_fact);
      bool upd = false;
      if (k.secant != 0.0) {
        upd = was_accept && !need_jac;
        if (upd) secant_update<T, n>(J, u, u_prev, F0, F_prev, T(k.secant));
      }
      need_fact = jac_stale || drift || upd;
      if (need_fact) {
        if (need_jac) rhs.jac(u, pp, t, J);
        factor_w<T, n>(fac, J, rmul(dt_step, gam));
        dt_fact = dt_step;
      } else {
        dt_step = nmin(dt_fact, rsub(tf, t));
      }
    } else {
      rhs.jac(u, pp, t, J);
      factor_w<T, n>(fac, J, rmul(dt_step, gam));
    }

    // ---- the s stage solves ------------------------------------------------
    T U[s][n], Fi[n];
    const T gdt = rmul(gam, dt_step);
    static_for<0, s>([&](auto ii) {
      constexpr int i = decltype(ii)::value;
      if constexpr (i == 0) {
#pragma unroll
        for (int c = 0; c < n; ++c) Fi[c] = F0[c];
      } else {
        T g[n];
#pragma unroll
        for (int c = 0; c < n; ++c) {
          T acc = u[c];
          static_for<0, i>([&](auto jj) {
            constexpr int j = decltype(jj)::value;
            if constexpr (Tab::a(i, j) != 0.0)
              acc = radd(acc, rmul(T(Tab::a(i, j)), U[j][c]));
          });
          g[c] = acc;
        }
        rhs.eval(g, pp, radd(t, rmul(T(Tab::c(i)), dt_step)), Fi);
      }
      T x[n];
#pragma unroll
      for (int c = 0; c < n; ++c) {
        T r = rmul(gdt, Fi[c]);
        static_for<0, i>([&](auto jj) {
          constexpr int j = decltype(jj)::value;
          if constexpr (Tab::C(i, j) != 0.0)
            r = radd(r, rmul(T(Tab::gC(i, j)), U[j][c]));
        });
        if constexpr (Tab::d(i) != 0.0)
          r = radd(r, rmul(rmul(rmul(T(Tab::gd(i)), dt_step), dt_step),
                           Td[c]));
        x[c] = r;
      }
      repro_lu::lu_resolve<T, n, true>(fac, x);
#pragma unroll
      for (int c = 0; c < n; ++c) U[i][c] = x[c];
    });
    T ucand[n], err[n];
#pragma unroll
    for (int c = 0; c < n; ++c) {
      T un = u[c], e = T(0);
      static_for<0, s>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        if constexpr (Tab::b(j) != 0.0)
          un = radd(un, rmul(T(Tab::b(j)), U[j][c]));
        if constexpr (Tab::btilde(j) != 0.0)
          e = radd(e, rmul(T(Tab::btilde(j)), U[j][c]));
      });
      ucand[c] = un;
      err[c] = e;
    }

    // ---- error control -----------------------------------------------------
    T sum = T(0);
    bool finite = true;
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const T sc = radd(atol, rmul(nmax(T(fabs(u[c])), T(fabs(ucand[c]))),
                                   rtol));
      const T r = rdiv(err[c], sc);
      sum = radd(sum, rmul(r, r));
      finite = finite && isfinite(ucand[c]);
    }
    const T enorm = sqrt(rdiv(sum, T(n)));
    const bool accept = (enorm <= T(1)) && finite;
    const T e = isfinite(enorm) ? nmax(enorm, T(1e-10)) : T(1e10);
    const T ep = nmax(enorm_prev, T(1e-10));
    const T pe = rmul(T(k.safety), T(pow(e, T(-k.beta1))));
    const T fac_c = accept ? clip(rmul(pe, T(pow(ep, T(k.beta2)))),
                                  T(k.qmin), T(k.qmax))
                           : clip(pe, T(k.qmin), T(1));
    T dt_next = clip(rmul(dt, fac_c), dtmin, dtmax);
    if constexpr (WReuse) {
      // w_dt_blame: with the secant off, a rejection on a reused J retries
      // at the same dt with a fresh J
      if (k.secant == 0.0 && !accept && !need_jac) dt_next = dt_step;
    }
    T t_new = accept ? radd(t, dt_step) : t;

    T unext[n];
    bool term = false;
    if constexpr (Ev::enabled) {
      if (accept) {
        // ---- the event: a hit truncates the step at the located time ---
        DenseOutput<Tab, Rhs, n, s, T> dense{rhs, U,  u,  ucand, F0,
                                             Fi,  pp, t, dt_step};
        T t_ev;
        const bool hit = repro_ev::handle_event<Ev, repro_arith::Rounded, n>(
            evc, dense, u, ucand, pp, t, dt_step, t_new, unext, t_ev);
        t_new = t_ev;
        term = hit && evc.terminal;
        // ---- dense output onto every save point up to the truncated time
        const T t_eps =
            radd(t_new, rmul(T(1e-7), nmax(T(fabs(t_new)), T(1))));
        const T step = dt_step == T(0) ? T(1) : dt_step;
        int j = cur;
        for (; j < S && saveat[j] <= t_eps; ++j) {
          T v[n];
          dense(clip(rdiv(rsub(saveat[j], t), step), T(0), T(1)), v);
          store_save(j, v);
        }
        hi = j > hi ? j : hi;
        while (cur < S && saveat[cur] <= t_new) ++cur;
      }
    } else if (accept) {
      // ---- dense output onto every save point this step crossed ----------
      const T t_eps = radd(t_new, rmul(T(1e-7), nmax(T(fabs(t_new)), T(1))));
      if (cur < S && saveat[cur] <= t_eps) {
        const T step = dt_step == T(0) ? T(1) : dt_step;
        T kd[L > 0 ? L : 1][n], Fn[n];
        if constexpr (L > 0) {
          static_for<0, L>([&](auto ll) {
            constexpr int l = decltype(ll)::value;
#pragma unroll
            for (int c = 0; c < n; ++c) {
              T acc = T(0);
              static_for<0, s>([&](auto jj) {
                constexpr int j = decltype(jj)::value;
                if constexpr (Tab::h(l, j) != 0.0)
                  acc = radd(acc, rmul(T(Tab::h(l, j)), U[j][c]));
              });
              kd[l][c] = acc;
            }
          });
        } else if constexpr (Tab::fnew_from_last_stage) {
#pragma unroll
          for (int c = 0; c < n; ++c) Fn[c] = Fi[c];
        } else {
          rhs.eval(ucand, pp, radd(t, dt_step), Fn);
        }
        int j = cur;
        for (; j < S && saveat[j] <= t_eps; ++j) {
          const T th = clip(rdiv(rsub(saveat[j], t), step), T(0), T(1));
          const T om = rsub(T(1), th);
          T v[n];
          if constexpr (L > 0) {
            // (1 - θ) u0 + θ u1 + θ (1 - θ) (kd1 + θ kd2 + ...)
            const T w = rmul(th, om);
#pragma unroll
            for (int c = 0; c < n; ++c) {
              T inner = kd[L - 1][c];
#pragma unroll
              for (int l = L - 2; l >= 0; --l)
                inner = radd(kd[l][c], rmul(th, inner));
              v[c] = radd(radd(rmul(om, u[c]), rmul(th, ucand[c])),
                          rmul(w, inner));
            }
          } else {
            // cubic Hermite on (u0, F0, u1, F1)
            const T om2 = rmul(om, om), th2 = rmul(th, th);
            const T h00 = rmul(radd(T(1), rmul(T(2), th)), om2);
            const T h10 = rmul(th, om2);
            const T h01 = rmul(th2, rsub(T(3), rmul(T(2), th)));
            const T h11 = rmul(th2, rsub(th, T(1)));
            const T h10dt = rmul(h10, dt_step), h11dt = rmul(h11, dt_step);
#pragma unroll
            for (int c = 0; c < n; ++c)
              v[c] = radd(radd(radd(rmul(h00, u[c]), rmul(h10dt, F0[c])),
                               rmul(h01, ucand[c])),
                          rmul(h11dt, Fn[c]));
          }
          store_save(j, v);
        }
        hi = j > hi ? j : hi;
      }
      while (cur < S && saveat[cur] <= t_new) ++cur;
    }

    if constexpr (WReuse) {
      // w_mark_stale for the next attempt, with this attempt's enorm and
      // the previous accepted one
      age = (need_jac ? 0 : age) + (accept ? 1 : 0);
      const bool grew = accept && (enorm > rmul(T(k.growth), enorm_prev) ||
                                   enorm > T(k.enorm_limit));
      jac_stale = (!accept && !need_jac) || grew ||
                  age >= static_cast<int>(k.max_age);
      if (accept) {
#pragma unroll
        for (int c = 0; c < n; ++c) {
          u_prev[c] = u[c];
          F_prev[c] = F0[c];
        }
      }
      was_accept = accept;
      njac += need_jac;
      nfact += need_fact;
    }
    if (accept) {
      if constexpr (Ev::enabled) {
#pragma unroll
        for (int c = 0; c < n; ++c) u[c] = unext[c];
      } else {
#pragma unroll
        for (int c = 0; c < n; ++c) u[c] = ucand[c];
      }
      ++naccept;
      enorm_prev = e;
    } else {
      ++nreject;
    }

    // dt pinned at the controller floor and still rejecting: the retry is
    // a deterministic live-lock, so the trajectory ends with status 2 (on
    // the lazy path only when J was fresh: a reused J's retry refreshes it)
    const bool hopeless = !accept && !(dt_step > dtmin) && need_jac;
    if (hopeless) status = 2;
    done = (t_new >= tf_end) || hopeless;
    if constexpr (Ev::enabled) done = done || term;
    t = t_new;
    dt = dt_next;
  }

  if constexpr (!WReuse) njac = nfact = naccept + nreject;
  const T zero[n] = {};
  for (int j = hi; j < S; ++j) store_save(j, zero);
#pragma unroll
  for (int c = 0; c < n; ++c) u_final[c * NN + lane] = u[c];
  t_final[lane] = t;
  stats[0 * NN + lane] = naccept;
  stats[1 * NN + lane] = nreject;
  stats[2 * NN + lane] = status > 0 ? status : (done ? 0 : 1);
  stats[3 * NN + lane] = (naccept + nreject) * nf_per_step;
  stats[4 * NN + lane] = njac;
  stats[5 * NN + lane] = nfact;
}

struct LaunchArgs {
  const void* u0;
  const void* p;
  const void* saveat;
  int S;
  int N;
  double t0, tf, dt0, rtol, atol;
  long long max_iters;
  int nf_per_step;
  Control k;
  repro_ev::Config ev;
  void* us;
  void* u_final;
  void* t_final;
  void* stats;
  cudaStream_t stream;
  repro_data::Tables data;  // the data forms' tables
};

template <typename T, class Tab, class Rhs, bool WReuse, class Ev,
          class Dat = repro_data::NoData>
int launch(const LaunchArgs& a) {
  const int grid = (a.N + kBlock - 1) / kBlock;
  Dat dat{};
  if constexpr (Dat::enabled) dat = a.data;
  rosenbrock_kernel<T, Tab, Rhs, WReuse, Ev, Dat>
      <<<grid, kBlock, 0, a.stream>>>(
          static_cast<const T*>(a.u0), static_cast<const T*>(a.p),
          static_cast<const T*>(a.saveat), a.S, a.N, T(a.t0), T(a.tf),
          T(a.dt0), T(a.rtol), T(a.atol), a.max_iters, a.nf_per_step, a.k,
          a.ev, dat, static_cast<T*>(a.us), static_cast<T*>(a.u_final),
          static_cast<T*>(a.t_final), static_cast<int*>(a.stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_rb
