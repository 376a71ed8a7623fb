// The body of the adaptive SDE ensemble kernel (K5): its helpers, the
// virtual Brownian tree, the steppers, the embedded pairs, the step
// controller's constants, the kernel, its launch arguments and its launch,
// moved unchanged out of `sde_adaptive_ensemble.cu` (which says what the
// kernel replaces, what bounds it and how it is built) so that a
// translation unit generated by `repro_torch.translate` (`units.py`)
// instantiates the same kernel with a generated drift and noise functor
// (the members of `sde_problems.cuh`'s functors) and a generated event.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "events.cuh"
#include "sde_problems.cuh"
#include "threefry.cuh"
#include "trajectory_queue.cuh"

namespace repro_sde_adaptive {

using namespace repro_sde;

constexpr int kBlock = 128;
// The functors' arithmetic: every operation rounded on its own.
using Arith = Rounded;

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return nmin(nmax(x, lo), hi);
}

// g(u)·dW, every operation rounded on its own.
template <class P, typename T>
__device__ __forceinline__ void noise_rn(const P& prob, const T* u,
                                         const T* p, T t, const T* dW,
                                         T* out) {
  if constexpr (P::diagonal) {
    T g[P::n];
    prob.template diffusion<Arith>(u, p, t, g);
#pragma unroll
    for (int c = 0; c < P::n; ++c) out[c] = rmul(g[c], dW[c]);
  } else {
    prob.template noise<Arith>(u, p, t, dW, out);
  }
}

// ---------------------------------------------------------------------------
// The virtual Brownian tree: W(idx · t_total / 2^depth) of every noise row
// of one lane, from W(T) of each row (`w_end`, node 0 of the tree, drawn
// once a trajectory).  w_mid = 0.5 (w_l + w_r) + (0.5 sqrt(h)) z; go left
// where idx <= mid; the heap id gains a 1 bit on a step right.
// ---------------------------------------------------------------------------

template <typename T, int m>
__device__ __forceinline__ void bridge_points(uint32_t seed, uint32_t idx,
                                              uint32_t lane, int depth,
                                              uint32_t n_total,
                                              const T* w_end, T h_res,
                                              T* w) {
  T w_l[m], w_r[m];
#pragma unroll
  for (int j = 0; j < m; ++j) {
    w_l[j] = T(0);
    w_r[j] = w_end[j];
  }
  uint32_t l = 0, r = n_total, nid = 1;
  for (int d = 0; d < depth; ++d) {
    const uint32_t mid = (l + r) >> 1;
    const T half_sd = rmul(T(0.5), sqrt(rmul(T(r - l), h_res)));
    const bool go_left = idx <= mid;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const T z = T(repro_rng::bridge_normal(seed, nid, uint32_t(j), lane));
      const T w_mid = radd(rmul(T(0.5), radd(w_l[j], w_r[j])),
                           rmul(half_sd, z));
      w_r[j] = go_left ? w_mid : w_r[j];
      w_l[j] = go_left ? w_l[j] : w_mid;
    }
    r = go_left ? mid : r;
    l = go_left ? l : mid;
    nid = 2u * nid + (go_left ? 0u : 1u);
  }
#pragma unroll
  for (int j = 0; j < m; ++j) w[j] = idx == l ? w_l[j] : w_r[j];
}

// ---------------------------------------------------------------------------
// Steppers for step doubling (src/repro_torch/core/sde.py), one step
// u -> out, in the plain version's operation order.
// ---------------------------------------------------------------------------

struct Em {
  template <class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t,
                                              T dt, const T* dW, T* out) {
    T a[P::n], gw[P::n];
    prob.template drift<Arith>(u, p, t, a);
    noise_rn(prob, u, p, t, dW, gw);
#pragma unroll
    for (int c = 0; c < P::n; ++c)
      out[c] = radd(radd(u[c], rmul(a[c], dt)), gw[c]);
  }
};

struct HeunStrat {
  template <class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t,
                                              T dt, const T* dW, T* out) {
    T a[P::n], gw[P::n], du1[P::n], ub[P::n];
    prob.template drift<Arith>(u, p, t, a);
    noise_rn(prob, u, p, t, dW, gw);
#pragma unroll
    for (int c = 0; c < P::n; ++c) {
      du1[c] = radd(rmul(a[c], dt), gw[c]);
      ub[c] = radd(u[c], du1[c]);
    }
    const T t1 = radd(t, dt);
    prob.template drift<Arith>(ub, p, t1, a);
    noise_rn(prob, ub, p, t1, dW, gw);
#pragma unroll
    for (int c = 0; c < P::n; ++c)
      out[c] = radd(u[c], rmul(T(0.5), radd(du1[c],
                                            radd(rmul(a[c], dt), gw[c]))));
  }
};

struct PlatenW2 {
  template <class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t,
                                              T dt, const T* dW, T* out) {
    static_assert(P::diagonal, "platen_w2 supports diagonal noise only");
    T a0[P::n], b0[P::n], ubar[P::n], up[P::n], um[P::n];
    const T sdt = sqrt(dt);
    prob.template drift<Arith>(u, p, t, a0);
    prob.template diffusion<Arith>(u, p, t, b0);
#pragma unroll
    for (int c = 0; c < P::n; ++c) {
      const T drift = radd(u[c], rmul(a0[c], dt));
      ubar[c] = radd(drift, rmul(b0[c], dW[c]));
      up[c] = radd(drift, rmul(b0[c], sdt));
      um[c] = rsub(drift, rmul(b0[c], sdt));
    }
    const T t1 = radd(t, dt);
    T a1[P::n], bp[P::n], bm[P::n];
    prob.template drift<Arith>(ubar, p, t1, a1);
    prob.template diffusion<Arith>(up, p, t1, bp);
    prob.template diffusion<Arith>(um, p, t1, bm);
    const T half_dt = rmul(T(0.5), dt);
#pragma unroll
    for (int c = 0; c < P::n; ++c) {
      const T x = radd(u[c], rmul(half_dt, radd(a1[c], a0[c])));
      const T y = rmul(rmul(T(0.25), dW[c]),
                       radd(radd(bp[c], bm[c]), rmul(T(2), b0[c])));
      const T z = rmul(rdiv(rmul(T(0.25), rsub(rmul(dW[c], dW[c]), dt)),
                            sdt),
                       rsub(bp[c], bm[c]));
      out[c] = radd(radd(x, y), z);
    }
  }
};

struct Milstein {
  template <class P, typename T>
  __device__ __forceinline__ static void step(const P& prob, const T* u,
                                              const T* p, T t,
                                              T dt, const T* dW, T* out) {
    static_assert(P::diagonal && P::has_gdg,
                  "milstein needs diagonal noise and the functor's gdg");
    T a0[P::n], b0[P::n], db[P::n];
    prob.template drift<Arith>(u, p, t, a0);
    prob.template diffusion<Arith>(u, p, t, b0);
    prob.template gdg<Arith>(u, p, t, db);
#pragma unroll
    for (int c = 0; c < P::n; ++c)
      out[c] = radd(radd(radd(u[c], rmul(a0[c], dt)), rmul(b0[c], dW[c])),
                    rmul(rmul(T(0.5), db[c]),
                         rsub(rmul(dW[c], dW[c]), dt)));
  }
};

// ---------------------------------------------------------------------------
// Embedded pairs: (u_prop, err) from one pass.
// ---------------------------------------------------------------------------

// (a - a / (1 + dt |a|)) dt: the drift-taming difference both pairs carry.
template <typename T>
__device__ __forceinline__ T taming(T a, T dt) {
  return rmul(rsub(a, rdiv(a, radd(T(1), rmul(dt, T(fabs(a)))))), dt);
}

// Euler-Maruyama with the tamed-Milstein-difference error
// 1/2 ((∂b)·b) (dW² - dt) + (a - a/(1 + dt|a|)) dt.
struct EmPair {
  template <class P, typename T>
  __device__ __forceinline__ static void pair(const P& prob, const T* u,
                                              const T* p, T t,
                                              T dt, const T* dW, T* out,
                                              T* err) {
    static_assert(P::diagonal && P::has_gdg,
                  "the em pair needs diagonal noise and the functor's gdg");
    T a0[P::n], b0[P::n], db[P::n];
    prob.template drift<Arith>(u, p, t, a0);
    prob.template diffusion<Arith>(u, p, t, b0);
    prob.template gdg<Arith>(u, p, t, db);
#pragma unroll
    for (int c = 0; c < P::n; ++c) {
      err[c] = radd(rmul(rmul(T(0.5), db[c]), rsub(rmul(dW[c], dW[c]), dt)),
                    taming(a0[c], dt));
      out[c] = radd(radd(u[c], rmul(a0[c], dt)), rmul(b0[c], dW[c]));
    }
  }
};

// Milstein with the deterministic companion error
// (a - a/(1 + dt|a|)) dt + |∂((∂b)·b)·b| dt^1.5 / sqrt(6).
struct MilsteinPair {
  template <class P, typename T>
  __device__ __forceinline__ static void pair(const P& prob, const T* u,
                                              const T* p, T t,
                                              T dt, const T* dW, T* out,
                                              T* err) {
    static_assert(P::diagonal && P::has_gdg && P::has_ddb,
                  "the milstein pair needs diagonal noise, gdg and ddb");
    T a0[P::n], b0[P::n], db[P::n], ddb[P::n];
    prob.template drift<Arith>(u, p, t, a0);
    prob.template diffusion<Arith>(u, p, t, b0);
    prob.template gdg<Arith>(u, p, t, db);
    prob.template ddb<Arith>(u, p, t, ddb);
    const T dt15 = rmul(dt, sqrt(dt));
    const T sqrt6 = sqrt(T(6));
#pragma unroll
    for (int c = 0; c < P::n; ++c) {
      out[c] = radd(radd(radd(u[c], rmul(a0[c], dt)), rmul(b0[c], dW[c])),
                    rmul(rmul(T(0.5), db[c]),
                         rsub(rmul(dW[c], dW[c]), dt)));
      err[c] = radd(taming(a0[c], dt),
                    rdiv(rmul(T(fabs(ddb[c])), dt15), sqrt6));
    }
  }
};

// The PI controller's numbers and the Richardson factor, from the wrapper
// (`controller_constants` in src/repro_torch/kernels/em/adaptive.py), so
// kernel and plain version share them.
struct Control {
  double beta1, beta2, safety, qmin, qmax, dtmin, dtmax, richardson;
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename T, class P, class St, bool kPair, class Ev,
          class Dat = repro_data::NoData>
__global__ void __launch_bounds__(kBlock)
    sde_adaptive_kernel(const T* __restrict__ u0, const T* __restrict__ p,
                        const T* __restrict__ saveat, int S, int N, T t0,
                        T tf, T dt0, T rtol, T atol, long long max_iters,
                        uint32_t seed, uint32_t lane_offset, int depth,
                        int nf_per_attempt, Control k, repro_ev::Config evc,
                        Dat dat, T* __restrict__ us,
                        T* __restrict__ u_final, T* __restrict__ t_final,
                        int* __restrict__ stats,
                        unsigned* __restrict__ queue) {
  constexpr int n = P::n, m = P::m;
  const P prob = repro_data::bind<P>(dat);
  // the trajectory this thread starts on; repro_queue::next hands out
  // the rest
  unsigned lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= static_cast<unsigned>(N)) return;
  const size_t NN = static_cast<size_t>(N);

  // the same for every trajectory
  const uint32_t n_total = 1u << depth;
  const T t_total = rsub(tf, t0);
  const T h_res = rdiv(t_total, T(n_total));
  const T sqrt_total = sqrt(t_total);
  const T dtmin = T(k.dtmin), dtmax = T(k.dtmax);
  const uint32_t min_cells = kPair ? 1u : 2u;

  // the trajectory's state: u, W at the left end and at T (m values each,
  // W(T) drawn once a trajectory), dt, the previous error norm, the dyadic
  // index, the counters, and `cur`, the first save point after the current
  // time
  T u[n], pp[P::k], w_l[m], w_end[m];
  uint32_t gl = 0, idx = 0;
  T dt = dt0, enorm_prev = T(1), t_out = t0;
  int naccept = 0, nreject = 0, nf = 0, status = 0, cur = 0;
  long long it = 0;
  bool done = false, fresh = true;

  for (;;) {
    if (fresh) {
      // ---- start trajectory `lane` ----------------------------------------
      fresh = false;
#pragma unroll
      for (int c = 0; c < n; ++c) u[c] = u0[c * NN + lane];
#pragma unroll
      for (int j = 0; j < P::k; ++j) pp[j] = p[j * NN + lane];
      gl = lane_offset + static_cast<uint32_t>(lane);
      // save points at or before t0 hold u0, the others 0 until crossed
      cur = 0;
      for (int j = 0; j < S; ++j) {
        const bool pre = __ldg(saveat + j) <= t0;
#pragma unroll
        for (int c = 0; c < n; ++c)
          us[(static_cast<size_t>(j) * n + c) * NN + lane] = pre ? u[c] : T(0);
        cur += pre;
      }
#pragma unroll
      for (int j = 0; j < m; ++j) {
        w_l[j] = T(0);  // W(0) = 0
        const float z = repro_rng::bridge_normal(seed, 0u, uint32_t(j), gl);
        w_end[j] = rmul(sqrt_total, T(z));
      }
      idx = 0;
      dt = dt0;
      enorm_prev = T(1);
      t_out = t0;
      naccept = nreject = nf = status = 0;
      it = 0;
      done = false;
    }

    if (!done && it < max_iters) {
      // ---- one attempt ----------------------------------------------------
      const T t = radd(t0, rmul(T(idx), h_res));
      // quantise the proposed dt to whole cells; below the floor no finer
      // path exists at this depth, so the step force-accepts
      const uint32_t want =
          static_cast<uint32_t>(rdiv(nmin(dt, t_total), h_res));
      const bool at_floor = want < min_cells;
      uint32_t mc = kPair ? want : ((want >> 1) << 1);
      mc = min(max(mc, min_cells), n_total - idx);
      const T dt_step = rmul(T(mc), h_res);

      T w_r[m], dWf[m];
      bridge_points<T, m>(seed, idx + mc, gl, depth, n_total, w_end, h_res,
                          w_r);
#pragma unroll
      for (int j = 0; j < m; ++j) dWf[j] = rsub(w_r[j], w_l[j]);

      T u2[n], err[n];
      if constexpr (kPair) {
        St::template pair(prob, u, pp, t, dt_step, dWf, u2, err);
      } else {
        const uint32_t mh = mc >> 1;
        const T dt_half = rmul(T(mh), h_res);
        const T t_mid = radd(t0, rmul(T(idx + mh), h_res));
        T w_m[m], dW1[m], dW2[m];
        bridge_points<T, m>(seed, idx + mh, gl, depth, n_total, w_end, h_res,
                            w_m);
#pragma unroll
        for (int j = 0; j < m; ++j) {
          dW1[j] = rsub(w_m[j], w_l[j]);
          dW2[j] = rsub(w_r[j], w_m[j]);
        }
        // one coarse step against two half steps on the same path; the
        // finer propagates
        T uc[n], uh[n];
        St::template step(prob, u, pp, t, dt_step, dWf, uc);
        St::template step(prob, u, pp, t, dt_half, dW1, uh);
        St::template step(prob, uh, pp, t_mid, dt_half, dW2, u2);
#pragma unroll
        for (int c = 0; c < n; ++c)
          err[c] = rmul(rsub(u2[c], uc[c]), T(k.richardson));
      }

      // ---- error control: Hairer norm, PI controller --------------------
      T sum = T(0);
      bool finite = true;
#pragma unroll
      for (int c = 0; c < n; ++c) {
        const T sc = radd(atol, rmul(nmax(T(fabs(u[c])), T(fabs(u2[c]))),
                                     rtol));
        const T r = rdiv(err[c], sc);
        sum = radd(sum, rmul(r, r));
        finite = finite && isfinite(u2[c]);
      }
      const T enorm = sqrt(rdiv(sum, T(n)));
      const bool accept = ((enorm <= T(1)) || at_floor) && finite;
      const T e = isfinite(enorm) ? nmax(enorm, T(1e-10)) : T(1e10);
      const T ep = nmax(enorm_prev, T(1e-10));
      const T pe = rmul(T(k.safety), T(pow(e, T(-k.beta1))));
      const T fac = accept ? clip(rmul(pe, T(pow(ep, T(k.beta2)))),
                                  T(k.qmin), T(k.qmax))
                           : clip(pe, T(k.qmin), T(1));
      const T dt_next = clip(rmul(dt_step, fac), dtmin, dtmax);

      bool term = false;
      if (accept) {
        const uint32_t idx_old = idx;
        idx += mc;
        T t_new = radd(t0, rmul(T(idx), h_res));
        // the saves run up to t_lim: the event time of a terminal hit,
        // else the (re-anchored) grid time
        T t_lim = t_new, unext[n];
        bool hit_nt = false;
        if constexpr (Ev::enabled) {
          auto interp = [&](T th, T* v) {
#pragma unroll
            for (int c = 0; c < n; ++c)
              v[c] = radd(u[c], rmul(th, rsub(u2[c], u[c])));
          };
          T t_ev;
          const bool hit = repro_ev::handle_event<Ev, Rounded, n>(
              evc, interp, u, u2, pp, t, dt_step, t_new, unext, t_ev);
          term = hit && evc.terminal;
          hit_nt = hit && !term;
          if (hit_nt) {
            // resume on the first grid point at or after the event time
            const T cells_f =
                ceil(rsub(rdiv(rsub(t_ev, t), h_res), T(1e-6)));
            const uint32_t cells =
                cells_f < T(1) ? 1u
                               : min(static_cast<uint32_t>(cells_f), mc);
            idx = idx_old + cells;
            t_new = radd(t0, rmul(T(idx), h_res));
          }
          t_lim = term ? t_ev : t_new;
        }
        t_out = t_lim;
        // ---- linear dense output onto every save point the step crossed
        const T lim = radd(t_lim, rmul(T(1e-7), nmax(T(fabs(t_lim)), T(1))));
        for (int j = cur; j < S && __ldg(saveat + j) <= lim; ++j) {
          const T th = clip(rdiv(rsub(__ldg(saveat + j), t), dt_step), T(0),
                            T(1));
#pragma unroll
          for (int c = 0; c < n; ++c)
            us[(static_cast<size_t>(j) * n + c) * NN + lane] =
                radd(u[c], rmul(th, rsub(u2[c], u[c])));
        }
        while (cur < S && __ldg(saveat + cur) <= t_new) ++cur;
#pragma unroll
        for (int c = 0; c < n; ++c) u[c] = Ev::enabled ? unext[c] : u2[c];
        if (hit_nt) {
          // a re-anchored lane restarts mid-step: its left W is at idx
          bridge_points<T, m>(seed, idx, gl, depth, n_total, w_end, h_res,
                              w_l);
        } else {
#pragma unroll
          for (int j = 0; j < m; ++j) w_l[j] = w_r[j];
        }
        enorm_prev = e;
        ++naccept;
      } else {
        ++nreject;
      }
      nf += nf_per_attempt;
      // rejecting at the resolution floor (only a non-finite state can) or
      // with dt pinned at the controller floor: the retry is bit-identical,
      // so the trajectory ends with status 2
      const bool hopeless = !accept && (at_floor || !(dt_step > dtmin));
      if (hopeless) status = 2;
      done = idx >= n_total || hopeless || term;
      dt = dt_next;
      ++it;
    }

    if (done || it >= max_iters) {
      // ---- finish trajectory `lane`, then take the next ------------------
#pragma unroll
      for (int c = 0; c < n; ++c) u_final[c * NN + lane] = u[c];
      t_final[lane] = t_out;
      stats[0 * NN + lane] = naccept;
      stats[1 * NN + lane] = nreject;
      stats[2 * NN + lane] = status > 0 ? status : (done ? 0 : 1);
      stats[3 * NN + lane] = nf;
      stats[4 * NN + lane] = 0;
      stats[5 * NN + lane] = 0;
      lane = repro_queue::next(queue);
      if (lane >= static_cast<unsigned>(N)) break;
      fresh = true;
    }
  }
}

struct LaunchArgs {
  const void* u0;
  const void* p;
  const void* saveat;
  int S, N;
  double t0, tf, dt0, rtol, atol;
  long long max_iters;
  uint32_t seed, lane_offset;
  int depth, nf_per_attempt;
  Control k;
  repro_ev::Config ev;
  void* us;
  void* u_final;
  void* t_final;
  void* stats;
  void* queue;  // the work queue's counter, zeroed by the wrapper
  cudaStream_t stream;
  repro_data::Tables data;  // the data forms' tables
};

template <typename T, class P, class St, bool kPair, class Ev,
          class Dat = repro_data::NoData>
int launch(const LaunchArgs& a) {
  const auto kernel = sde_adaptive_kernel<T, P, St, kPair, Ev, Dat>;
  const int grid = repro_queue::persistent_grid(kernel, kBlock, a.N);
  Dat dat{};
  if constexpr (Dat::enabled) dat = a.data;
  kernel<<<grid, kBlock, 0, a.stream>>>(
          static_cast<const T*>(a.u0), static_cast<const T*>(a.p),
          static_cast<const T*>(a.saveat), a.S, a.N, T(a.t0), T(a.tf),
          T(a.dt0), T(a.rtol), T(a.atol), a.max_iters, a.seed, a.lane_offset,
          a.depth, a.nf_per_attempt, a.k, a.ev, dat, static_cast<T*>(a.us),
          static_cast<T*>(a.u_final), static_cast<T*>(a.t_final),
          static_cast<int*>(a.stats), static_cast<unsigned*>(a.queue));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_sde_adaptive
