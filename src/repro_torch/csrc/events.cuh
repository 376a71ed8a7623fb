// Event handling for the fused ensemble kernels (paper §6.6), shared by the
// explicit-RK, Rosenbrock and both SDE kernels: the device form of
// src/repro_torch/core/events.py (`handle_event`, `bisect_event`,
// `event_crossing`) and the event functors of
// src/repro_torch/configs/de_problems.py.
//
// One thread runs one trajectory, so `handle_event` is the per-lane body
// of the plain version's masked lanes code: it detects a directional sign
// change of the condition over an accepted step, re-anchors g_old == 0 at
// theta = kThetaEps (evaluating the interpolant only where g_old is 0),
// bisects on the kernel's dense output and applies the affect only where
// the step hits; the plain version's values elsewhere are discarded, so the
// outputs are the same.  The interpolant is the caller's (a functor
// `interp(theta, out)`), so each kernel locates events on its own dense
// output.  `terminal`, `direction` and `bisect_iters` are runtime values
// (`Config`), the functor a template parameter.
//
// Arithmetic: the condition, the affect and the time arithmetic take a
// policy `A` of arith.cuh (every event form passes `Rounded`, each
// operation rounded on its own as PyTorch rounds it), in the plain
// version's order: t_old + 1e-4 * dt, mid = 0.5 * (lo + hi),
// t_old + mid * dt, theta = hi.

#pragma once

#include <cuda_runtime.h>

#include "arith.cuh"

namespace repro_ev {

constexpr double kThetaEps = 1e-4;

// The launch's event settings (the Python Event's terminal, direction and
// bisect_iters).
struct Config {
  int terminal;
  int direction;
  int bisect_iters;
};

// The no-event form: `enabled` is false and nothing else is read.
struct NoEvent {
  static constexpr bool enabled = false;
};

// torch.sign: -1, 0 or 1, NaN for NaN.
template <typename T>
__device__ __forceinline__ T sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// ---------------------------------------------------------------------------
// Event functors (src/repro_torch/configs/de_problems.py), the conditions
// and affects in the Python functions' operation order.  kEventId is the
// registry's id (repro_torch/kernels/events.py); kAffect whether the
// functor has an affect.
// ---------------------------------------------------------------------------

// The bouncing ball (Fig. 8): height u[0] crossing 0; the affect sets the
// height to 0 and flips the velocity by the restitution e = p[1].
struct BallBounce {
  static constexpr bool enabled = true;
  static constexpr int kEventId = 1;
  static constexpr bool kAffect = true;
  template <class A, typename T>
  __device__ __forceinline__ static T condition(const T* u, const T* p, T t) {
    return u[0];
  }
  template <class A, typename T>
  __device__ __forceinline__ static void affect(const T* u, const T* p, T t,
                                                T* out) {
    out[0] = T(0.0);
    out[1] = A::mul(-p[1], u[1]);
  }
};

// Linear decay's half point: u[0] - 0.5.
struct DecayHalf {
  static constexpr bool enabled = true;
  static constexpr int kEventId = 2;
  static constexpr bool kAffect = false;
  template <class A, typename T>
  __device__ __forceinline__ static T condition(const T* u, const T* p, T t) {
    return A::sub(u[0], T(0.5));
  }
};

// ROBER's half conversion: y3 - 0.5.
struct RoberHalf {
  static constexpr bool enabled = true;
  static constexpr int kEventId = 3;
  static constexpr bool kAffect = false;
  template <class A, typename T>
  __device__ __forceinline__ static T condition(const T* u, const T* p, T t) {
    return A::sub(u[2], T(0.5));
  }
};

// The GBM knock-out barrier: u[0] - 0.18.
struct GbmBarrier {
  static constexpr bool enabled = true;
  static constexpr int kEventId = 4;
  static constexpr bool kAffect = false;
  template <class A, typename T>
  __device__ __forceinline__ static T condition(const T* u, const T* p, T t) {
    return A::sub(u[0], T(0.18));
  }
};

// The ramp's sawtooth: u[0] - 0.15; the affect drops the state by 0.1.
struct RampSawtooth {
  static constexpr bool enabled = true;
  static constexpr int kEventId = 5;
  static constexpr bool kAffect = true;
  template <class A, typename T>
  __device__ __forceinline__ static T condition(const T* u, const T* p, T t) {
    return A::sub(u[0], T(0.15));
  }
  template <class A, typename T>
  __device__ __forceinline__ static void affect(const T* u, const T* p, T t,
                                                T* out) {
    out[0] = A::sub(u[0], T(0.1));
  }
};

// The forced oscillator's level crossing (paper §6.7 with events):
// u[0] - 1.5.
struct OscLevel {
  static constexpr bool enabled = true;
  static constexpr int kEventId = 6;
  static constexpr bool kAffect = false;
  template <class A, typename T>
  __device__ __forceinline__ static T condition(const T* u, const T* p, T t) {
    return A::sub(u[0], T(1.5));
  }
};

// ---------------------------------------------------------------------------
// handle_event: one accepted step of one lane.
// ---------------------------------------------------------------------------

// The step went from (u_old, t_old) to (u_cand, t_new) over dt_step;
// `interp(theta, out)` writes the dense output at t_old + theta * dt_step.
// Without a hit: u_next = u_cand, t_next = t_new, returns false.  With a
// hit: u_next = the affected state at the located time t_next =
// t_old + theta * dt_step (theta the first bisection point past the root),
// returns true; the caller ends the lane where cfg.terminal is set.
template <class Ev, class A, int n, typename T, class Interp>
__device__ __forceinline__ bool handle_event(const Config& cfg,
                                             Interp&& interp,
                                             const T* u_old, const T* u_cand,
                                             const T* p, T t_old, T dt_step,
                                             T t_new, T* u_next, T& t_next) {
  T g_old = Ev::template condition<A>(u_old, p, t_old);
  const T g_new = Ev::template condition<A>(u_cand, p, t_new);
  if (g_old == T(0)) {
    // an affect applied exactly at a root leaves g_old == 0 and would mask
    // every later crossing: re-anchor the sign just inside the step
    T ue[n];
    interp(T(kThetaEps), ue);
    g_old = Ev::template condition<A>(
        ue, p, A::add(t_old, A::mul(T(kThetaEps), dt_step)));
  }
  bool hit = sign(g_old) * sign(g_new) < T(0);
  if (cfg.direction == -1) hit = hit && g_new < g_old;
  if (cfg.direction == 1) hit = hit && g_new > g_old;
  if (!hit) {
#pragma unroll
    for (int c = 0; c < n; ++c) u_next[c] = u_cand[c];
    t_next = t_new;
    return false;
  }
  const T s_old = sign(g_old);
  T lo = T(0), hi = T(1);
  for (int i = 0; i < cfg.bisect_iters; ++i) {
    const T mid = A::mul(T(0.5), A::add(lo, hi));
    T um[n];
    interp(mid, um);
    const T g_mid =
        Ev::template condition<A>(um, p, A::add(t_old, A::mul(mid, dt_step)));
    // the root lies in [lo, mid] iff g changes sign between g_old and g_mid
    const bool left = s_old * sign(g_mid) <= T(0);
    lo = left ? lo : mid;
    hi = left ? mid : hi;
  }
  // theta = hi, the first point past the root: g has crossed
  T us[n];
  interp(hi, us);
  t_next = A::add(t_old, A::mul(hi, dt_step));
  if constexpr (Ev::kAffect) {
    Ev::template affect<A>(us, p, t_next, u_next);
  } else {
#pragma unroll
    for (int c = 0; c < n; ++c) u_next[c] = us[c];
  }
  return true;
}

}  // namespace repro_ev
