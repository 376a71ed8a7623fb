// Adaptive SDE ensemble kernel on the virtual Brownian tree (RSwM-style
// rejection sampling with an embedded pair or step doubling), written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `run_ensemble_kernel` + `sde_adaptive_body` of
// src/repro/kernels/ensemble_kernel.py (pallas_call at :282, body at :602),
// which runs src/repro/core/sde.py `sde_solve_adaptive(lanes=True)` with the
// noise of src/repro/kernels/rng.py (`bridge_normals` :49,
// `brownian_bridge_point` :67).  Per trajectory: attempt steps from t0
// until the dyadic index reaches 2^depth.  Each attempt quantises the
// proposed dt to whole cells of the depth-D grid (an even count for
// doubling), reads W at the step's right end (and at its midpoint, for
// doubling) from the virtual tree, runs the embedded pair once or the
// stepper three times (one step against two half steps, the difference
// scaled by the Richardson factor), takes the Hairer norm of the error,
// runs the PI controller, and accepts, rejects or gives up (status 2); on
// accept it writes each saveat point the step crossed, by linear
// interpolation.  Outputs us (S, n, N), u_final, t_final and the 6-row
// stats block (naccept, nreject, status, nf, 0, 0).
//
// Design: the whole adaptive loop in one launch, trajectories taken from a
// work queue (trajectory_queue.cuh): a persistent grid, each thread
// starting on its own index and, when its trajectory ends, taking the next
// one from a device counter, so a lane that finishes early starts another
// trajectory instead of idling until its warp's slowest lane is done.  The
// loop is flat, one attempt an iteration, and a lane whose trajectory ended
// writes it out, takes the next index and starts it inside the iteration,
// so the warp reconverges at every attempt.  A trajectory's inputs, outputs
// and noise are keyed by its index (gl = lane_offset + index), so it makes
// exactly the attempts the reference's lanes loop makes for its lane, and
// every output is what one trajectory per thread gives, bit for bit.  u, W
// at the left end (m values, carried across attempts and replaced on
// accept), W(T) of each row (drawn once a trajectory, node 0 of every
// descent), dt, the previous error norm, the dyadic index and the counters
// stay in registers.  The saveat grid is read through the read-only path,
// and `us` is stored lane-major.  The tree descent is a loop of `depth`
// levels with selects, not branches; the interval (l, r] and the heap id
// it walks are the same for every noise row, so one walk draws all m rows.
// The estimator, the stepper and the problem are template parameters, so
// each combination compiles to straight code.
//
// What bounds it on an H100: integer work, as in the fixed-dt kernel.  An
// attempt draws depth·m normals per descent, one descent with the embedded
// pair and two with doubling (42 or 84 Threefry calls at depth 14 with
// m = 3), against a few dozen floating-point operations of the stepper.
// The design draws nothing it does not use (W(T) once a trajectory, not
// once a descent), keeps the generator in registers, and lets no lane idle
// behind a slower one but at the tail of the run.
//
// Arithmetic: every add, multiply and divide of this file and of the
// functors it instantiates (sde_problems.cuh) is rounded on its own (the
// _rn intrinsics, which nvcc never contracts), in the plain version's
// order; pow, in the PI controller and the CRN drift, keeps nvcc's
// defaults, as PyTorch builds its own.  An adaptive step sequence follows
// the last bit, so a kernel that fused could not be held to its plain
// version's step counts.  No --use_fast_math.
//
// Events (the event template parameter, events.cuh): on an accepted step
// the condition is checked over it and, on a hit, the event time is
// bisected on the linear path output and the affect applied, every
// operation rounded on its own.  A terminal hit ends the trajectory at the
// event time (t_final, and the saves stop there); a non-terminal hit
// re-anchors it on the first dyadic grid point at or after the event time,
// cells = clip(ceil((t_ev - t) / h_res - 1e-6), 1, cells of the step), and
// the left-end W is refreshed there by one more tree descent (the tree
// replays W at any index exactly).  The no-event form (repro_ev::NoEvent)
// compiles to the code it had before events existed.

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

// stepper_id: 0 em, 1 heun_strat, 2 platen_w2, 3 milstein.  est_id:
// 0 doubling (every stepper the problem admits), 1 embedded (em and
// milstein, on a diagonal problem whose functor has gdg, and ddb for
// milstein).
template <typename T, class P, class Ev = repro_ev::NoEvent,
          class Dat = repro_data::NoData>
int by_method(int stepper_id, int est_id, const LaunchArgs& a) {
  if (est_id == 1) {
    if constexpr (P::diagonal && P::has_gdg) {
      if (stepper_id == 0) return launch<T, P, EmPair, true, Ev, Dat>(a);
      if constexpr (P::has_ddb) {
        if (stepper_id == 3)
          return launch<T, P, MilsteinPair, true, Ev, Dat>(a);
      }
    }
    return -1;
  }
  if (est_id != 0) return -1;
  switch (stepper_id) {
    case 0: return launch<T, P, Em, false, Ev, Dat>(a);
    case 1: return launch<T, P, HeunStrat, false, Ev, Dat>(a);
  }
  if constexpr (P::diagonal) {
    if (stepper_id == 2) return launch<T, P, PlatenW2, false, Ev, Dat>(a);
    if constexpr (P::has_gdg) {
      if (stepper_id == 3) return launch<T, P, Milstein, false, Ev, Dat>(a);
    }
  }
  return -1;
}

// The data functors (DATA_LAYOUTS in src/repro_torch/kernels/em/kernel.py):
// prob_id 3, the rate-table GBM.
template <typename T>
int by_data(int prob_id, int stepper_id, int est_id, const LaunchArgs& a) {
  if (prob_id == 3)
    return by_method<T, GbmRate, repro_ev::NoEvent, repro_data::Tables>(
        stepper_id, est_id, a);
  return -1;
}

// event_id 0: the no-event form; else the registered (problem, event)
// pairs (EVENT_PAIRS in src/repro_torch/kernels/em/kernel.py).
template <typename T>
int by_problem(int prob_id, int event_id, int stepper_id, int est_id,
               const LaunchArgs& a) {
  namespace ev = repro_ev;
  if (event_id == 0) {
    switch (prob_id) {
      case 0: return by_method<T, Gbm>(stepper_id, est_id, a);
      case 1: return by_method<T, Crn>(stepper_id, est_id, a);
      case 2: return by_method<T, Ramp>(stepper_id, est_id, a);
    }
    return -1;
  }
  if (prob_id == 0 && event_id == ev::GbmBarrier::kEventId)
    return by_method<T, Gbm, ev::GbmBarrier>(stepper_id, est_id, a);
  if (prob_id == 2 && event_id == ev::RampSawtooth::kEventId)
    return by_method<T, Ramp, ev::RampSawtooth>(stepper_id, est_id, a);
  return -1;
}

int dispatch(int dtype_id, int prob_id, int event_id, int stepper_id,
             int est_id, const LaunchArgs& a) {
  switch (dtype_id) {
    case 0: return by_problem<float>(prob_id, event_id, stepper_id, est_id, a);
    case 1: return by_problem<double>(prob_id, event_id, stepper_id, est_id, a);
  }
  return -1;
}

}  // namespace repro_sde_adaptive

// C interface, bound with ctypes by src/repro_torch/kernels/em/adaptive.py.
// dtype_id: 0 float32, 1 float64.  prob_id: 0 gbm, 1 crn, 2 ramp.  stepper_id and
// est_id: see by_method.  `saveat` is (S,) ascending; `control` points to 8
// host doubles: beta1, beta2, safety, qmin, qmax, dtmin, dtmax, richardson.
// The caller keeps 0 <= depth <= 30.  `queue` points to one 32-bit word on
// the card, zeroed on `stream` before the launch: the work queue's counter
// (trajectory_queue.cuh).  Returns cudaGetLastError() after the launch, or
// -1 for an unknown id or combination.  Launches on `stream` and does not
// synchronise.
extern "C" int sde_adaptive_launch(
    int dtype_id, int prob_id, int stepper_id, int est_id, const void* u0,
    const void* p, const void* saveat, int S, int N, double t0, double tf,
    double dt0, double rtol, double atol, long long max_iters,
    unsigned int seed, unsigned int lane_offset, int depth,
    int nf_per_attempt, const double* control, void* us, void* u_final,
    void* t_final, void* stats, void* queue, void* stream) {
  namespace sa = repro_sde_adaptive;
  const double* c = control;
  const sa::Control k{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
  const sa::LaunchArgs a{u0,        p,           saveat, S,
                         N,         t0,          tf,     dt0,
                         rtol,      atol,        max_iters, seed,
                         lane_offset, depth,     nf_per_attempt, k,
                         {0, 0, 0}, us,          u_final, t_final,
                         stats,     queue,
                         static_cast<cudaStream_t>(stream)};
  return sa::dispatch(dtype_id, prob_id, 0, stepper_id, est_id, a);
}

// The event form: event_id names the functor of events.cuh (kEventId),
// compiled for the pairs of `by_problem`; terminal, direction (-1, 0, 1)
// and bisect_iters are the Python Event's.  -1 for an unregistered pair.
extern "C" int sde_adaptive_event_launch(
    int dtype_id, int prob_id, int stepper_id, int est_id, int event_id,
    int terminal, int direction, int bisect_iters, const void* u0,
    const void* p, const void* saveat, int S, int N, double t0, double tf,
    double dt0, double rtol, double atol, long long max_iters,
    unsigned int seed, unsigned int lane_offset, int depth,
    int nf_per_attempt, const double* control, void* us, void* u_final,
    void* t_final, void* stats, void* queue, void* stream) {
  namespace sa = repro_sde_adaptive;
  if (event_id <= 0) return -1;
  const double* c = control;
  const sa::Control k{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
  const sa::LaunchArgs a{u0,        p,           saveat, S,
                         N,         t0,          tf,     dt0,
                         rtol,      atol,        max_iters, seed,
                         lane_offset, depth,     nf_per_attempt, k,
                         {terminal, direction, bisect_iters}, us,
                         u_final,   t_final,     stats,  queue,
                         static_cast<cudaStream_t>(stream)};
  return sa::dispatch(dtype_id, prob_id, event_id, stepper_id, est_id, a);
}

// The data form: the problem functor prob_id (3, the rate-table GBM) reads
// the n_data tables of `data` (device pointers), `data_shape` (kx, ky per
// table; ky = 0 in 1-D) and `data_grid` (x0, dx, y0, dy per table).  -1 for
// an unregistered combination or a bad table count.
extern "C" int sde_adaptive_data_launch(
    int dtype_id, int prob_id, int stepper_id, int est_id, int n_data,
    const void* const* data, const int* data_shape, const double* data_grid,
    const void* u0, const void* p, const void* saveat, int S, int N,
    double t0, double tf, double dt0, double rtol, double atol,
    long long max_iters, unsigned int seed, unsigned int lane_offset,
    int depth, int nf_per_attempt, const double* control, void* us,
    void* u_final, void* t_final, void* stats, void* queue, void* stream) {
  namespace sa = repro_sde_adaptive;
  const double* c = control;
  const sa::Control k{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
  sa::LaunchArgs a{u0,        p,           saveat, S,
                   N,         t0,          tf,     dt0,
                   rtol,      atol,        max_iters, seed,
                   lane_offset, depth,     nf_per_attempt, k,
                   {0, 0, 0}, us,          u_final, t_final,
                   stats,     queue,
                   static_cast<cudaStream_t>(stream)};
  if (!repro_data::make_tables(n_data, data, data_shape, data_grid, a.data))
    return -1;
  switch (dtype_id) {
    case 0: return sa::by_data<float>(prob_id, stepper_id, est_id, a);
    case 1: return sa::by_data<double>(prob_id, stepper_id, est_id, a);
  }
  return -1;
}
