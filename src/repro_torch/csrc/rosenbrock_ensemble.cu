// Fused whole-integration ensemble kernel for stiff ODEs: s-stage
// Rosenbrock W-methods (rosenbrock23, rodas4, rodas5p) with one pivoted LU
// of W = I − γh·J per step, written by hand for Hopper (sm_90a).  The
// paper lists stiff ODEs as beyond EnsembleGPUKernel (§7) and names the
// enabling primitive, the block-diagonal W solved as N small LUs (§5.1.3).
//
// Replaces the TPU kernel `run_ensemble_kernel` + `rosenbrock_body` of
// src/repro/kernels/ensemble_kernel.py (pallas_call at :282, body at :491),
// which runs src/repro/core/rosenbrock.py `solve_rosenbrock(lanes=True,
// linsolve="lanes")` with the lanes LU of src/repro/kernels/lu/kernel.py
// (`lu_factor_lanes` :28, `lu_resolve_lanes` :66) inlined: per trajectory,
// adaptive stepping with PI control, a finite check on every candidate,
// STATUS_DTMIN_EXHAUSTED detection, dense output onto a `saveat` grid (the
// tableau's stiffly accurate interpolant, or cubic Hermite), the 6-row
// stats block (naccept, nreject, status, nf, njac, nfact), and the lazy-W
// path (`WReuse`): J, the factored W and the dt it was factored at carried
// across steps, refreshed only when the WReusePolicy asks, with the
// extrapolated-secant touch-up of J in between.
//
// Design: one trajectory per thread.  A thread keeps its state, the s
// stage vectors, J, the LU factors (lu_lanes.cuh) and the controller
// values in registers, runs its own loop and retires when its trajectory
// reaches tf, so no thread steps at dt = 0 behind a finished lane.  The
// tableau, the right-hand side and the lazy-W switch are template
// parameters: coefficients are compile-time constants, terms whose
// coefficient is zero vanish at compile time, and every array index is a
// constant.  The PI controller's and the WReusePolicy's numbers come from
// the wrapper at launch (`Control`), so kernel and plain version share
// them.  Save points are written lane-major (S, n, N) when crossed.
//
// What bounds it on an H100: FP64 instructions.  A trajectory reads and
// writes a few dozen words in all, while every attempt costs s right-hand
// sides, a Jacobian, an n³/3 elimination and s back-substitutions — about a
// thousand double operations for rodas5p on ROBER — in registers.  A
// division or sqrt rounded correctly is a fast path of several FP64
// instructions and a pow more (PERF.md §6 counts them in this build's
// SASS, `bound_instr_ms`), so the arithmetic, not the memory, is the
// floor.  Divergence costs little: neighbouring trajectories of a sweep
// take nearly the same steps (warp SIMT efficiency 0.989–1.000 on every
// row at 2^20 trajectories), so the kernel keeps one trajectory per thread
// and takes none from a work queue (trajectory_queue.cuh, which the
// adaptive SDE kernel uses).  What the design does: everything per step
// stays in registers, no thread waits on another's step control, and the
// data form locates each attempt's t once for f and ∂f/∂t.  Every form
// launches 128 threads a block with its registers left to ptxas: a cap of
// 128 registers on every form (4 warps a scheduler) slowed the data form
// by 3% and sped the two forms above 128 registers by 4% and 6%, each in
// one reading (PERF.md §6, PR 20).
//
// Semantics follow the reference loop body expression by expression:
// W = I − (dt·γ)·J; the stage right-hand side (γ·dt)·F_i + Σ (γ·C_ij)·U_j
// + ((γ·d_i)·dt)·dt·f_t, with the products γ·C_ij and γ·d_i folded in
// double precision (the constants below); u1 = u + Σ b_i U_i and
// err = Σ btilde_i U_i; accept needs enorm <= 1 and a finite candidate; a
// save point s is written when t_old < s <= t_new + 1e-7·max(|t_new|, 1)
// on an accepted step, with θ clipped to [0, 1]; points at or before t0
// hold u0.  Two changes of schedule leave every output as it was: f(u1) for
// Hermite dense output is evaluated only on a step that writes a save (the
// reference evaluates it every attempt, and `nf` counts it there), and a
// finished trajectory stops instead of stepping at dt = 0.
//
// Events (the event template parameter, events.cuh, compiled in double):
// on an accepted step the condition is checked over the step and, on a
// hit, the event time is bisected on the method's dense output (the same
// interpolant the saves use; Hermite's f(u1) is then evaluated on the
// steps that hit or start on a root as well), the affect applied and the
// step truncated at the event, saves stopping there; a terminal hit ends
// the trajectory.  `nf` is still counted per attempt, as the plain version
// counts it.  Every operation of the event path is rounded on its own too.
// The no-event form (repro_ev::NoEvent) runs the code it ran before events.
//
// Data (the data template parameter, interp.cuh): a data form's RHS is a
// functor built from the dataset's tables (`repro_data::Tables`, the
// kernel argument `dat`) whose f, Jacobian and ∂f/∂t read them on the card:
// the forced oscillator of the paper's §6.7, whose ∂f/∂t is the tangent of
// its table lookup (interp.cuh `interp1d_and_tangent`, JAX's tie rule at the
// table's ends, as the plain version's jvp gives it).  Compiled in double,
// the stiff family's precision.  The no-data form (repro_data::NoData)
// builds a stateless functor and reads nothing.

#include "rosenbrock_body.cuh"

namespace repro_rb {

// ---------------------------------------------------------------------------
// Device right-hand sides (src/repro_torch/configs/de_problems.py) with
// their Jacobians ∂f/∂u and, beside f at an attempt's start (`eval_dfdt`),
// ∂f/∂t, in the Python functions' operation order.  ROBER's Jacobian is
// the reference's analytic `rober_jac`; OREGO's and Van der Pol's are
// written out by hand where the reference takes jacfwd.  All three are
// autonomous: ∂f/∂t = 0, as the reference's jvp gives it.
// ---------------------------------------------------------------------------

struct Rober {
  static constexpr int n = 3, m = 3;
  template <typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T,
                                              T* du) {
    const T k1 = p[0], k2 = p[1], k3 = p[2];
    const T y1 = u[0], y2 = u[1], y3 = u[2];
    // -k1 y1 + k3 y2 y3;  k1 y1 - k2 y2 y2 - k3 y2 y3;  k2 y2 y2
    du[0] = radd(rmul(-k1, y1), rmul(rmul(k3, y2), y3));
    du[1] = rsub(rsub(rmul(k1, y1), rmul(rmul(k2, y2), y2)),
                 rmul(rmul(k3, y2), y3));
    du[2] = rmul(rmul(k2, y2), y2);
  }
  template <typename T>
  __device__ __forceinline__ static void jac(const T* u, const T* p, T,
                                             T J[n][n]) {
    const T k1 = p[0], k2 = p[1], k3 = p[2];
    const T y2 = u[1], y3 = u[2];
    J[0][0] = -k1;
    J[0][1] = rmul(k3, y3);
    J[0][2] = rmul(k3, y2);
    J[1][0] = k1;
    J[1][1] = rsub(rmul(rmul(T(-2.0), k2), y2), rmul(k3, y3));
    J[1][2] = rmul(-k3, y2);
    J[2][0] = T(0);
    J[2][1] = rmul(rmul(T(2.0), k2), y2);
    J[2][2] = T(0);
  }
  template <typename T>
  __device__ __forceinline__ static void eval_dfdt(const T* u, const T* p,
                                                   T t, T* du, T* d) {
    eval(u, p, t, du);
#pragma unroll
    for (int c = 0; c < n; ++c) d[c] = T(0);
  }
};

struct Orego {
  static constexpr int n = 3, m = 3;
  template <typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T,
                                              T* du) {
    const T s = p[0], q = p[1], w = p[2];
    const T y1 = u[0], y2 = u[1], y3 = u[2];
    // s (y2 + y1 (1 - q y1 - y2));  (y3 - (1 + y1) y2) / s;  w (y1 - y3)
    du[0] = rmul(s, radd(y2, rmul(y1, rsub(rsub(T(1.0), rmul(q, y1)), y2))));
    du[1] = rdiv(rsub(y3, rmul(radd(T(1.0), y1), y2)), s);
    du[2] = rmul(w, rsub(y1, y3));
  }
  template <typename T>
  __device__ __forceinline__ static void jac(const T* u, const T* p, T,
                                             T J[n][n]) {
    const T s = p[0], q = p[1], w = p[2];
    const T y1 = u[0], y2 = u[1];
    const T qy1 = rmul(q, y1);
    J[0][0] = rmul(s, rsub(rsub(rsub(T(1.0), qy1), y2), qy1));
    J[0][1] = rmul(s, rsub(T(1.0), y1));
    J[0][2] = T(0);
    J[1][0] = rdiv(-y2, s);
    J[1][1] = rdiv(-radd(T(1.0), y1), s);
    J[1][2] = rdiv(T(1.0), s);
    J[2][0] = w;
    J[2][1] = T(0);
    J[2][2] = -w;
  }
  template <typename T>
  __device__ __forceinline__ static void eval_dfdt(const T* u, const T* p,
                                                   T t, T* du, T* d) {
    eval(u, p, t, du);
#pragma unroll
    for (int c = 0; c < n; ++c) d[c] = T(0);
  }
};

struct Vdp {
  static constexpr int n = 2, m = 1;
  template <typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T,
                                              T* du) {
    const T mu = p[0];
    // u1;  mu ((1 - u0^2) u1) - u0
    du[0] = u[1];
    du[1] = rsub(rmul(mu, rmul(rsub(T(1.0), rmul(u[0], u[0])), u[1])), u[0]);
  }
  template <typename T>
  __device__ __forceinline__ static void jac(const T* u, const T* p, T,
                                             T J[n][n]) {
    const T mu = p[0];
    J[0][0] = T(0);
    J[0][1] = T(1);
    J[1][0] = rsub(rmul(mu, rmul(rmul(T(-2.0), u[0]), u[1])), T(1));
    J[1][1] = rmul(mu, rsub(T(1.0), rmul(u[0], u[0])));
  }
  template <typename T>
  __device__ __forceinline__ static void eval_dfdt(const T* u, const T* p,
                                                   T t, T* du, T* d) {
    eval(u, p, t, du);
#pragma unroll
    for (int c = 0; c < n; ++c) d[c] = T(0);
  }
};

// The bouncing ball, u = (x, v), p = (g, e): (v, -g), J = [[0, 1], [0, 0]].
struct Ball {
  static constexpr int n = 2, m = 2;
  template <typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T,
                                              T* du) {
    du[0] = u[1];
    du[1] = -p[0];
  }
  template <typename T>
  __device__ __forceinline__ static void jac(const T*, const T*, T,
                                             T J[n][n]) {
    J[0][0] = T(0);
    J[0][1] = T(1);
    J[1][0] = T(0);
    J[1][1] = T(0);
  }
  template <typename T>
  __device__ __forceinline__ static void eval_dfdt(const T* u, const T* p,
                                                   T t, T* du, T* d) {
    eval(u, p, t, du);
#pragma unroll
    for (int c = 0; c < n; ++c) d[c] = T(0);
  }
};

// Linear decay: -lam u, J = -lam.
struct Decay {
  static constexpr int n = 1, m = 1;
  template <typename T>
  __device__ __forceinline__ static void eval(const T* u, const T* p, T,
                                              T* du) {
    du[0] = rmul(-p[0], u[0]);
  }
  template <typename T>
  __device__ __forceinline__ static void jac(const T*, const T* p, T,
                                             T J[n][n]) {
    J[0][0] = -p[0];
  }
  template <typename T>
  __device__ __forceinline__ static void eval_dfdt(const T* u, const T* p,
                                                   T t, T* du, T* d) {
    eval(u, p, t, du);
    d[0] = T(0);
  }
};

// The forced oscillator (paper §6.7): u = (x, v), p = (k, c),
// f = (v, -k x - c v + F(t)) with F read from the table data["force"]
// (gather), J = [[0, 1], [-k, -c]] and ∂f/∂t = (0, F'(t)).  f and ∂f/∂t at
// an attempt's start share one lookup of t (`interp1d_and_tangent`: one
// division and one pair of knot reads for both); 1/dx, the tangent's
// scale, is formed once, when the functor is built.  Compiled in double.
struct ForcedOsc {
  static constexpr int n = 2, m = 2;
  repro_data::Table1D<double> force;
  double inv_dx;
  __device__ __forceinline__ explicit ForcedOsc(const repro_data::Tables& d)
      : force(d.leaf[0]), inv_dx(rdiv(1.0, force.dx)) {}
  template <typename T>
  __device__ __forceinline__ void eval(const T* u, const T* p, T t,
                                       T* du) const {
    static_assert(std::is_same_v<T, double>, "the data forms are double");
    const T F = repro_data::interp1d<repro_data::kGather,
                                     repro_arith::Rounded>(force, t);
    du[0] = u[1];
    du[1] = radd(rsub(rmul(-p[0], u[0]), rmul(p[1], u[1])), F);
  }
  template <typename T>
  __device__ __forceinline__ void jac(const T*, const T* p, T,
                                      T J[n][n]) const {
    J[0][0] = T(0);
    J[0][1] = T(1);
    J[1][0] = -p[0];
    J[1][1] = -p[1];
  }
  template <typename T>
  __device__ __forceinline__ void eval_dfdt(const T* u, const T* p, T t,
                                            T* du, T* d) const {
    static_assert(std::is_same_v<T, double>, "the data forms are double");
    T F, dF;
    repro_data::interp1d_and_tangent<repro_arith::Rounded>(force, inv_dx, t,
                                                           F, dF);
    du[0] = u[1];
    du[1] = radd(rsub(rmul(-p[0], u[0]), rmul(p[1], u[1])), F);
    d[0] = T(0);
    d[1] = dF;
  }
};

template <typename T, class Tab, bool WReuse>
int by_rhs(int rhs_id, const LaunchArgs& a) {
  using repro_ev::NoEvent;
  switch (rhs_id) {
    case 0: return launch<T, Tab, Rober, WReuse, NoEvent>(a);
    case 1: return launch<T, Tab, Orego, WReuse, NoEvent>(a);
    case 2: return launch<T, Tab, Vdp, WReuse, NoEvent>(a);
    case 3: return launch<T, Tab, Ball, WReuse, NoEvent>(a);
    case 4: return launch<T, Tab, Decay, WReuse, NoEvent>(a);
  }
  return -1;
}

// The registered (RHS, event) pairs (EVENT_PAIRS in
// src/repro_torch/kernels/rosenbrock/kernel.py), in double only.
template <typename T, class Tab, bool WReuse>
int by_event(int rhs_id, int event_id, const LaunchArgs& a) {
  if constexpr (std::is_same_v<T, double>) {
    namespace ev = repro_ev;
    if (rhs_id == 0 && event_id == ev::RoberHalf::kEventId)
      return launch<T, Tab, Rober, WReuse, ev::RoberHalf>(a);
    if (rhs_id == 3 && event_id == ev::BallBounce::kEventId)
      return launch<T, Tab, Ball, WReuse, ev::BallBounce>(a);
    if (rhs_id == 4 && event_id == ev::DecayHalf::kEventId)
      return launch<T, Tab, Decay, WReuse, ev::DecayHalf>(a);
  }
  return -1;
}

// The data functors (DATA_LAYOUTS in src/repro_torch/kernels/rosenbrock/
// kernel.py), in double only: rhs_id 5, the forced oscillator.
template <bool WReuse>
int by_data(int tab_id, int rhs_id, const LaunchArgs& a) {
  using repro_data::Tables;
  using repro_ev::NoEvent;
  if (rhs_id != 5) return -1;
  switch (tab_id) {
    case 0: return launch<double, Ros23w, ForcedOsc, WReuse, NoEvent,
                          Tables>(a);
    case 1: return launch<double, Rodas4, ForcedOsc, WReuse, NoEvent,
                          Tables>(a);
    case 2: return launch<double, Rodas5p, ForcedOsc, WReuse, NoEvent,
                          Tables>(a);
  }
  return -1;
}

template <typename T, bool WReuse>
int by_tableau(int tab_id, int rhs_id, int event_id, const LaunchArgs& a) {
  switch (tab_id) {
    case 0: return event_id ? by_event<T, Ros23w, WReuse>(rhs_id, event_id, a)
                            : by_rhs<T, Ros23w, WReuse>(rhs_id, a);
    case 1: return event_id ? by_event<T, Rodas4, WReuse>(rhs_id, event_id, a)
                            : by_rhs<T, Rodas4, WReuse>(rhs_id, a);
    case 2: return event_id
                       ? by_event<T, Rodas5p, WReuse>(rhs_id, event_id, a)
                       : by_rhs<T, Rodas5p, WReuse>(rhs_id, a);
  }
  return -1;
}

template <typename T>
int by_reuse(int w_reuse, int tab_id, int rhs_id, int event_id,
             const LaunchArgs& a) {
  return w_reuse ? by_tableau<T, true>(tab_id, rhs_id, event_id, a)
                 : by_tableau<T, false>(tab_id, rhs_id, event_id, a);
}

int dispatch(int dtype_id, int w_reuse, int tab_id, int rhs_id, int event_id,
             const LaunchArgs& a) {
  switch (dtype_id) {
    case 0: return by_reuse<float>(w_reuse, tab_id, rhs_id, event_id, a);
    case 1: return by_reuse<double>(w_reuse, tab_id, rhs_id, event_id, a);
  }
  return -1;
}

}  // namespace repro_rb

// C interface, bound with ctypes by src/repro_torch/kernels/rosenbrock/
// kernel.py.  dtype_id: 0 float32, 1 float64.  tab_id: 0 rosenbrock23,
// 1 rodas4, 2 rodas5p.  rhs_id: 0 rober, 1 orego, 2 vdp, 3 ball, 4 decay.
// `control` points to 12 host doubles: beta1, beta2, safety, qmin, qmax,
// dtmin, dtmax, dt_rtol, growth, enorm_limit, max_age, secant.  Returns
// cudaGetLastError() after the launch, or -1 for an unknown id.  Launches
// on `stream` and does not synchronise.
extern "C" int rosenbrock_ensemble_launch(
    int dtype_id, int tab_id, int rhs_id, int w_reuse, const void* u0,
    const void* p, const void* saveat, int S, int N, double t0, double tf,
    double dt0, double rtol, double atol, long long max_iters,
    int nf_per_step, const double* control, void* us, void* u_final,
    void* t_final, void* stats, void* stream) {
  const double* c = control;
  const repro_rb::Control k{c[0], c[1], c[2], c[3], c[4],  c[5],
                            c[6], c[7], c[8], c[9], c[10], c[11]};
  const repro_rb::LaunchArgs a{u0,      p,         saveat,      S,
                               N,       t0,        tf,          dt0,
                               rtol,    atol,      max_iters,   nf_per_step,
                               k,       {0, 0, 0}, us,          u_final,
                               t_final, stats,
                               static_cast<cudaStream_t>(stream)};
  return repro_rb::dispatch(dtype_id, w_reuse, tab_id, rhs_id, 0, a);
}

// The event form (float64): event_id names the functor of events.cuh
// (kEventId), compiled for the pairs of `by_event`; terminal, direction
// (-1, 0, 1) and bisect_iters are the Python Event's.  -1 for an
// unregistered pair.
extern "C" int rosenbrock_ensemble_event_launch(
    int dtype_id, int tab_id, int rhs_id, int w_reuse, int event_id,
    int terminal, int direction, int bisect_iters, const void* u0,
    const void* p, const void* saveat, int S, int N, double t0, double tf,
    double dt0, double rtol, double atol, long long max_iters,
    int nf_per_step, const double* control, void* us, void* u_final,
    void* t_final, void* stats, void* stream) {
  if (event_id <= 0) return -1;
  const double* c = control;
  const repro_rb::Control k{c[0], c[1], c[2], c[3], c[4],  c[5],
                            c[6], c[7], c[8], c[9], c[10], c[11]};
  const repro_rb::LaunchArgs a{u0,      p,         saveat,      S,
                               N,       t0,        tf,          dt0,
                               rtol,    atol,      max_iters,   nf_per_step,
                               k,       {terminal, direction, bisect_iters},
                               us,      u_final,   t_final,     stats,
                               static_cast<cudaStream_t>(stream)};
  return repro_rb::dispatch(dtype_id, w_reuse, tab_id, rhs_id, event_id, a);
}

// The data form (float64): the RHS functor rhs_id (5, the forced
// oscillator) reads the n_data tables of `data` (device pointers),
// `data_shape` (kx, ky per table; ky = 0 in 1-D) and `data_grid` (x0, dx,
// y0, dy per table).  -1 for an unregistered combination, another dtype or
// a bad table count.
extern "C" int rosenbrock_ensemble_data_launch(
    int dtype_id, int tab_id, int rhs_id, int w_reuse, int n_data,
    const void* const* data, const int* data_shape, const double* data_grid,
    const void* u0, const void* p, const void* saveat, int S, int N,
    double t0, double tf, double dt0, double rtol, double atol,
    long long max_iters, int nf_per_step, const double* control, void* us,
    void* u_final, void* t_final, void* stats, void* stream) {
  const double* c = control;
  const repro_rb::Control k{c[0], c[1], c[2], c[3], c[4],  c[5],
                            c[6], c[7], c[8], c[9], c[10], c[11]};
  repro_rb::LaunchArgs a{u0,      p,         saveat,      S,
                         N,       t0,        tf,          dt0,
                         rtol,    atol,      max_iters,   nf_per_step,
                         k,       {0, 0, 0}, us,          u_final,
                         t_final, stats,
                         static_cast<cudaStream_t>(stream)};
  if (dtype_id != 1 ||
      !repro_data::make_tables(n_data, data, data_shape, data_grid, a.data))
    return -1;
  return w_reuse ? repro_rb::by_data<true>(tab_id, rhs_id, a)
                 : repro_rb::by_data<false>(tab_id, rhs_id, a);
}
