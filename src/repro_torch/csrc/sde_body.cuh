// The body of the fixed-dt SDE ensemble kernel (K4): the noise helpers,
// the steppers, the kernel, its launch arguments and its launch, moved
// unchanged out of `sde_ensemble.cu` (which says what the kernel replaces,
// what bounds it and how it is built) so that a translation unit
// generated by `repro_torch.translate` (`units.py`) instantiates the same
// kernel with a generated drift and noise functor (the members of
// `sde_problems.cuh`'s functors).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "events.cuh"
#include "sde_problems.cuh"
#include "threefry.cuh"

namespace repro_sde {

constexpr int kBlock = 128;
using repro_rng::box_muller;
using repro_rng::counter_normal;
using repro_rng::threefry2x32;

// g(u)·dW for either noise structure, under the policy A.
template <class A, class P, typename T>
__device__ __forceinline__ void apply_noise(const P& prob, const T* u,
                                            const T* p, T t, const T* dW,
                                            T* out) {
  if constexpr (P::diagonal) {
    T g[P::n];
    prob.template diffusion<A>(u, p, t, g);
#pragma unroll
    for (int c = 0; c < P::n; ++c) out[c] = A::mul(g[c], dW[c]);
  } else {
    prob.template noise<A>(u, p, t, dW, out);
  }
}

// Whether P computes its drift and noise together (sde_problems.cuh).
template <class P, class = void>
struct SharesDriftNoise : std::false_type {};
template <class P>
struct SharesDriftNoise<P, std::void_t<decltype(P::kSharedDriftNoise)>>
    : std::bool_constant<P::kSharedDriftNoise> {};

// f(u) and g(u)·dW at one point: through the problem's `drift_and_noise`
// where it shares terms between them, else the two calls.
template <class A, class P, typename T>
__device__ __forceinline__ void drift_noise(const P& prob, const T* u,
                                            const T* p, T t, const T* dW,
                                            T* a, T* gw) {
  if constexpr (SharesDriftNoise<P>::value) {
    prob.template drift_and_noise<A>(u, p, t, dW, a, gw);
  } else {
    prob.template drift<A>(u, p, t, a);
    apply_noise<A>(prob, u, p, t, dW, gw);
  }
}

// ---------------------------------------------------------------------------
// Steppers (src/repro_torch/core/sde.py), one step u -> out, in the plain
// version's operation order under the policy A.
// ---------------------------------------------------------------------------

struct Em {
  static constexpr int nf = 1;
  template <class A, class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t, T dt, T sdt,
                                              const T* dW, T* out) {
    T a[P::n], gw[P::n];
    drift_noise<A>(prob, u, p, t, dW, a, gw);
#pragma unroll
    for (int c = 0; c < P::n; ++c)
      out[c] = A::add(A::add(u[c], A::mul(a[c], dt)), gw[c]);
  }
};

struct HeunStrat {
  static constexpr int nf = 2;
  template <class A, class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t, T dt, T sdt,
                                              const T* dW, T* out) {
    T a[P::n], gw[P::n], du1[P::n], ub[P::n];
    drift_noise<A>(prob, u, p, t, dW, a, gw);
#pragma unroll
    for (int c = 0; c < P::n; ++c) {
      du1[c] = A::add(A::mul(a[c], dt), gw[c]);
      ub[c] = A::add(u[c], du1[c]);
    }
    const T t1 = radd(t, dt);
    drift_noise<A>(prob, ub, p, t1, dW, a, gw);
#pragma unroll
    for (int c = 0; c < P::n; ++c)
      out[c] = A::add(u[c], A::mul(T(0.5), A::add(du1[c],
                                                  A::add(A::mul(a[c], dt),
                                                         gw[c]))));
  }
};

struct PlatenW2 {
  static constexpr int nf = 2;
  template <class A, class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t, T dt, T sdt,
                                              const T* dW, T* out) {
    static_assert(P::diagonal, "platen_w2 supports diagonal noise only");
    T a0[P::n], b0[P::n], ubar[P::n], up[P::n], um[P::n];
    prob.template drift<A>(u, p, t, a0);
    prob.template diffusion<A>(u, p, t, b0);
#pragma unroll
    for (int c = 0; c < P::n; ++c) {
      const T drift = A::add(u[c], A::mul(a0[c], dt));
      ubar[c] = A::add(drift, A::mul(b0[c], dW[c]));
      up[c] = A::add(drift, A::mul(b0[c], sdt));
      um[c] = A::sub(drift, A::mul(b0[c], sdt));
    }
    const T t1 = radd(t, dt);
    T a1[P::n], bp[P::n], bm[P::n];
    prob.template drift<A>(ubar, p, t1, a1);
    prob.template diffusion<A>(up, p, t1, bp);
    prob.template diffusion<A>(um, p, t1, bm);
#pragma unroll
    for (int c = 0; c < P::n; ++c)
      out[c] = A::add(
          A::add(A::add(u[c], A::mul(A::mul(T(0.5), dt),
                                     A::add(a1[c], a0[c]))),
                 A::mul(A::mul(T(0.25), dW[c]),
                        A::add(A::add(bp[c], bm[c]), A::mul(T(2), b0[c])))),
          A::mul(A::div(A::mul(T(0.25), A::sub(A::mul(dW[c], dW[c]), dt)),
                        sdt),
                 A::sub(bp[c], bm[c])));
  }
};

struct Milstein {
  static constexpr int nf = 1;
  template <class A, class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t, T dt, T sdt,
                                              const T* dW, T* out) {
    static_assert(P::diagonal, "milstein supports diagonal noise only");
    T a0[P::n], b0[P::n], db[P::n];
    prob.template drift<A>(u, p, t, a0);
    prob.template diffusion<A>(u, p, t, b0);
    prob.template gdg<A>(u, p, t, db);
#pragma unroll
    for (int c = 0; c < P::n; ++c)
      out[c] = A::add(A::add(A::add(u[c], A::mul(a0[c], dt)),
                             A::mul(b0[c], dW[c])),
                      A::mul(A::mul(T(0.5), db[c]),
                             A::sub(A::mul(dW[c], dW[c]), dt)));
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The m counter normals of one step, rows 0..m-1.
template <int m>
__device__ __forceinline__ void draw_normals(uint32_t seed, uint32_t step,
                                             uint32_t gl, float* z) {
#pragma unroll
  for (int j = 0; j < m; ++j)
    z[j] = counter_normal(seed, step, static_cast<uint32_t>(j), gl);
}

template <typename T, class P, class St, bool kTable, class Ev,
          class Dat = repro_data::NoData>
__global__ void __launch_bounds__(kBlock)
    sde_ensemble_kernel(const T* __restrict__ u0, const T* __restrict__ p,
                        const T* __restrict__ table, int N, int n_steps,
                        int save_every, double t0d, double dtd, double t_end,
                        uint32_t seed, uint32_t lane_offset,
                        repro_ev::Config evc, Dat dat, T* __restrict__ us,
                        T* __restrict__ u_final, T* __restrict__ t_final,
                        int* __restrict__ stats) {
  constexpr int n = P::n, m = P::m;
  const P prob = repro_data::bind<P>(dat);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t NN = static_cast<size_t>(N);

  T u[n], pp[P::k];
#pragma unroll
  for (int c = 0; c < n; ++c) u[c] = u0[c * NN + lane];
#pragma unroll
  for (int j = 0; j < P::k; ++j) pp[j] = p[j * NN + lane];

  const T t0 = T(t0d), dt = T(dtd);
  const T sdt = sqrt(dt);
  const uint32_t gl = lane_offset + static_cast<uint32_t>(lane);
  int since = 0;
  size_t slot = 0;
  // the event form's state: terminated, reported time, steps taken
  bool done = false;
  T t_out = t0;
  int nacc = 0;

  // the event and data forms round every operation on their own, the
  // no-event form leaves nvcc free to contract
  using A = std::conditional_t<Ev::enabled || Dat::enabled, Rounded,
                               Contracting>;
  // The counter stream is drawn one step ahead: step k + 1's normals do not
  // depend on u, so they are drawn right after step k's stepper, where
  // their Threefry rounds (ALU pipe) can issue beside the end of step k's
  // float work (FMA pipe).  Drawn before the stepper instead, they held
  // more registers across it and gained less (tools/k46_probe.py --ab;
  // PERF.md).  The stream is keyed by step, so every normal is the one
  // the step would draw itself; a lane frozen by a terminal event has
  // drawn one step ahead and draws nothing more.
  float z_next[kTable ? 1 : m];
  if constexpr (!kTable) {
    if (n_steps > 0) draw_normals<m>(seed, 0u, gl, z_next);
  }
  for (int k = 0; k < n_steps; ++k) {
    if (!Ev::enabled || !done) {
      T dW[m];
      if constexpr (kTable) {
        const T* zk = table + static_cast<size_t>(k) * m * NN + lane;
#pragma unroll
        for (int j = 0; j < m; ++j) dW[j] = A::mul(zk[j * NN], sdt);
      } else {
#pragma unroll
        for (int j = 0; j < m; ++j) dW[j] = A::mul(T(z_next[j]), sdt);
      }
      const T t = radd(t0, rmul(T(k), dt));
      T un[n];
      St::template step<A>(prob, u, pp, t, dt, sdt, dW, un);
      if constexpr (!kTable) {
        if (k + 1 < n_steps)
          draw_normals<m>(seed, static_cast<uint32_t>(k + 1), gl, z_next);
      }
      if constexpr (Ev::enabled) {
        auto interp = [&](T th, T* v) {
#pragma unroll
          for (int c = 0; c < n; ++c)
            v[c] = A::add(u[c], A::mul(th, A::sub(un[c], u[c])));
        };
        const T t_grid = radd(t, dt);
        T unext[n], t_ev;
        const bool hit = repro_ev::handle_event<Ev, A, n>(
            evc, interp, u, un, pp, t, dt, t_grid, unext, t_ev);
        done = hit && evc.terminal;
        t_out = done ? t_ev : t_grid;
        ++nacc;
#pragma unroll
        for (int c = 0; c < n; ++c) u[c] = unext[c];
      } else {
#pragma unroll
        for (int c = 0; c < n; ++c) u[c] = un[c];
      }
    }
    if (++since == save_every) {
      since = 0;
#pragma unroll
      for (int c = 0; c < n; ++c) us[(slot * n + c) * NN + lane] = u[c];
      ++slot;
    }
  }

#pragma unroll
  for (int c = 0; c < n; ++c) u_final[c * NN + lane] = u[c];
  t_final[lane] = Ev::enabled ? t_out : T(t_end);
  stats[0 * NN + lane] = Ev::enabled ? nacc : n_steps;
  stats[1 * NN + lane] = 0;
  stats[2 * NN + lane] = 0;
  stats[3 * NN + lane] = n_steps * St::nf;
  stats[4 * NN + lane] = 0;
  stats[5 * NN + lane] = 0;
}

struct LaunchArgs {
  const void* u0;
  const void* p;
  const void* table;
  int N, n_steps, save_every;
  double t0, dt, t_end;
  uint32_t seed, lane_offset;
  repro_ev::Config ev;
  void* us;
  void* u_final;
  void* t_final;
  void* stats;
  cudaStream_t stream;
  repro_data::Tables data;  // the data forms' tables
};

template <typename T, class P, class St, bool kTable, class Ev,
          class Dat = repro_data::NoData>
int launch(const LaunchArgs& a) {
  const int grid = (a.N + kBlock - 1) / kBlock;
  Dat dat{};
  if constexpr (Dat::enabled) dat = a.data;
  sde_ensemble_kernel<T, P, St, kTable, Ev, Dat>
      <<<grid, kBlock, 0, a.stream>>>(
          static_cast<const T*>(a.u0), static_cast<const T*>(a.p),
          static_cast<const T*>(a.table), a.N, a.n_steps, a.save_every, a.t0,
          a.dt, a.t_end, a.seed, a.lane_offset, a.ev, dat,
          static_cast<T*>(a.us), static_cast<T*>(a.u_final),
          static_cast<T*>(a.t_final), static_cast<int*>(a.stats));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class P, class St, class Ev,
          class Dat = repro_data::NoData>
int by_table(int use_table, const LaunchArgs& a) {
  return use_table ? launch<T, P, St, true, Ev, Dat>(a)
                   : launch<T, P, St, false, Ev, Dat>(a);
}

}  // namespace repro_sde
