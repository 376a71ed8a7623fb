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

#include "sde_adaptive_body.cuh"

namespace repro_sde_adaptive {

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
