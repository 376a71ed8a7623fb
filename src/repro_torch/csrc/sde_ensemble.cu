// Fixed-dt SDE ensemble kernel with in-kernel counter-based noise (the
// paper's GPUEM / GPUSIEA, §5.2.2 and §6.8), written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `run_ensemble_kernel` + `sde_body` of
// src/repro/kernels/ensemble_kernel.py (pallas_call at :282, body at :533),
// with the noise of src/repro/kernels/rng.py (`threefry2x32` at :24,
// `counter_normals_threefry` at :136): every trajectory takes `n_steps`
// steps of one stepper (em, heun_strat, platen_w2, milstein), draws its
// N(0,1) increments from Threefry-2x32-20 keyed by (seed, 0x243F6A88) with
// counters (step * 0x9E3779B9 + row, lane_offset + lane), or reads them
// from a (n_steps, m, N) table, and writes a snapshot every `save_every`
// steps, then u_final, t_final and the 6-row stats block.
//
// Design: one trajectory per thread, the whole integration in one launch.
// u, p, the normals and the stepper's temporaries stay in registers; the
// only device-memory traffic is u0 and p in, the snapshots and final values
// out (lane-major (S, n, N), so neighbouring threads store neighbouring
// words), and the table when one is given.  The stepper and the problem are
// template parameters, so each (stepper, problem) pair compiles to straight
// code.  The generator (threefry.cuh) and the problems (sde_problems.cuh)
// are shared with the adaptive kernel (sde_adaptive_ensemble.cu); general
// noise applies g·dW inside the problem's functor, so a 4 x 8 noise matrix
// is never held whole in registers.
//
// What bounds it on an H100: integer operations.  One normal costs one
// Threefry-2x32-20 call (about 74 32-bit adds, funnel shifts and xors) plus
// a log, a sqrt and a cos, against a few floating-point operations of the
// stepper per state; the bytes moved per trajectory are a few dozen.  The
// design keeps the generator in registers, draws each step's normals at the
// end of the step before it (below), and draws nothing else; it takes one
// normal per Threefry call, as the reference does, so the stream stays the
// reference's (using both Box-Muller outputs is later work).  A problem
// whose drift and noise share a term computes it once a point
// (`drift_noise`: CRN's Hill term).  Counted in the card's instructions
// (chip_smoke.py `k4_bound_instr`), a normal issues ~147 (70 on the ALU
// pipe), so the kernel is bound by instruction issue with the ALU pipe
// close behind; the libm routines' slow-path branches cut each step into
// short blocks, which keeps the ALU-heavy Threefry rounds and the FMA-heavy
// Box-Muller and problem work from overlapping within a warp.
//
// Semantics follow the reference loop body (src/repro/core/sde.py
// `sde_step_and_save` and the steppers above it) expression by expression:
// dt and t0 are rounded to T, t = t0 + k*dt is computed from k on every step
// (never accumulated, never contracted to an fma), dW = z * sqrt(dt), and
// the normals are computed in float whatever T is, then cast, as JAX
// computes them in float32.  The steppers and the functors take an
// arithmetic policy (arith.cuh): without events products may contract into
// fused multiply-adds (`Contracting`; tools/parent_check.py holds the
// results bit for bit to earlier builds).  No --use_fast_math: the
// approximate intrinsics would move every normal.
//
// Data (the data template parameter, interp.cuh): the data form's problem
// functor is built from the dataset's tables (`repro_data::Tables`, the
// kernel argument `dat`) and reads them on the card: the rate-table GBM of
// the paper's §6.7, every operation rounded on its own (`Rounded`).  The
// no-data form (repro_data::NoData) builds a stateless functor.
//
// Events (the event template parameter, events.cuh): after each step the
// condition is checked over it and, on a hit, the event time is bisected on
// the linear path output and the affect applied.  Every operation of the
// event form, the steps included, is rounded on its own (`Rounded`), so a
// path that grazes the barrier crosses it on the step the plain version
// crosses it on; a non-terminal affect resumes at
// the step's grid end, a terminal hit freezes the trajectory (no more
// steps or noise; its snapshots keep the frozen state), t_final is then the
// event time and naccept the steps it took.  The noise stream is keyed by
// step, so it is the same with and without events.  The no-event form
// (repro_ev::NoEvent) compiles to the code it had before events existed.

#include "sde_body.cuh"

namespace repro_sde {

// The counter normals alone, one thread per (step, row, lane) element of a
// block, with the raw words: words[0][i], words[1][i], z[i].
__global__ void __launch_bounds__(kBlock)
    sde_normals_kernel(uint32_t seed, long long step0, int rows, int lanes,
                       long long total, uint32_t lane_offset,
                       uint32_t* __restrict__ words, float* __restrict__ z) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const int lane = static_cast<int>(i % lanes);
  const int row = static_cast<int>((i / lanes) % rows);
  const long long step = step0 + i / (static_cast<long long>(lanes) * rows);
  uint32_t a, b;
  threefry2x32(seed, repro_rng::kStreamKey,
               static_cast<uint32_t>(step) * repro_rng::kStepStride +
                   static_cast<uint32_t>(row),
               lane_offset + static_cast<uint32_t>(lane), a, b);
  words[i] = a;
  words[total + i] = b;
  z[i] = box_muller(a, b);
}

// stepper_id: 0 em, 1 heun_strat, 2 platen_w2, 3 milstein; platen_w2 and
// milstein exist for the diagonal problems only.
template <typename T, class P, class Ev = repro_ev::NoEvent,
          class Dat = repro_data::NoData>
int by_stepper(int stepper_id, int use_table, const LaunchArgs& a) {
  switch (stepper_id) {
    case 0: return by_table<T, P, Em, Ev, Dat>(use_table, a);
    case 1: return by_table<T, P, HeunStrat, Ev, Dat>(use_table, a);
  }
  if constexpr (P::diagonal) {
    switch (stepper_id) {
      case 2: return by_table<T, P, PlatenW2, Ev, Dat>(use_table, a);
      case 3: return by_table<T, P, Milstein, Ev, Dat>(use_table, a);
    }
  }
  return -1;
}

// The data functors (DATA_LAYOUTS in src/repro_torch/kernels/em/kernel.py):
// prob_id 3, the rate-table GBM.
template <typename T>
int by_data(int prob_id, int stepper_id, int use_table, const LaunchArgs& a) {
  if (prob_id == 3)
    return by_stepper<T, GbmRate, repro_ev::NoEvent, repro_data::Tables>(
        stepper_id, use_table, a);
  return -1;
}

// event_id 0: the no-event form; else the registered (problem, event)
// pairs (EVENT_PAIRS in src/repro_torch/kernels/em/kernel.py).
template <typename T>
int by_problem(int prob_id, int event_id, int stepper_id, int use_table,
               const LaunchArgs& a) {
  namespace ev = repro_ev;
  if (event_id == 0) {
    switch (prob_id) {
      case 0: return by_stepper<T, Gbm>(stepper_id, use_table, a);
      case 1: return by_stepper<T, Crn>(stepper_id, use_table, a);
      case 2: return by_stepper<T, Ramp>(stepper_id, use_table, a);
    }
    return -1;
  }
  if (prob_id == 0 && event_id == ev::GbmBarrier::kEventId)
    return by_stepper<T, Gbm, ev::GbmBarrier>(stepper_id, use_table, a);
  if (prob_id == 2 && event_id == ev::RampSawtooth::kEventId)
    return by_stepper<T, Ramp, ev::RampSawtooth>(stepper_id, use_table, a);
  return -1;
}

int dispatch(int dtype_id, int prob_id, int event_id, int stepper_id,
             int use_table, const LaunchArgs& a) {
  switch (dtype_id) {
    case 0: return by_problem<float>(prob_id, event_id, stepper_id, use_table, a);
    case 1: return by_problem<double>(prob_id, event_id, stepper_id, use_table, a);
  }
  return -1;
}

}  // namespace repro_sde

// C interface, bound with ctypes by src/repro_torch/kernels/em/kernel.py.
// dtype_id: 0 float32, 1 float64.  prob_id: 0 gbm, 1 crn, 2 ramp.
// stepper_id: see by_stepper.  `table` is (n_steps, m, N) of T when
// use_table is 1, else unused.  Returns cudaGetLastError() after the
// launch, or -1 for an unknown id or combination.  Launches on `stream` and
// does not synchronise.
extern "C" int sde_ensemble_launch(int dtype_id, int prob_id, int stepper_id,
                                   int use_table, const void* u0,
                                   const void* p, const void* table, int N,
                                   int n_steps, int save_every, double t0,
                                   double dt, double t_end, unsigned int seed,
                                   unsigned int lane_offset, void* us,
                                   void* u_final, void* t_final, void* stats,
                                   void* stream) {
  const repro_sde::LaunchArgs a{u0,   p,       table,       N,       n_steps,
                                save_every, t0, dt,         t_end,   seed,
                                lane_offset, {0, 0, 0}, us, u_final, t_final,
                                stats, static_cast<cudaStream_t>(stream)};
  return repro_sde::dispatch(dtype_id, prob_id, 0, stepper_id, use_table, a);
}

// The event form: event_id names the functor of events.cuh (kEventId),
// compiled for the pairs of `by_problem`; terminal, direction (-1, 0, 1)
// and bisect_iters are the Python Event's.  -1 for an unregistered pair.
extern "C" int sde_ensemble_event_launch(
    int dtype_id, int prob_id, int stepper_id, int use_table, int event_id,
    int terminal, int direction, int bisect_iters, const void* u0,
    const void* p, const void* table, int N, int n_steps, int save_every,
    double t0, double dt, double t_end, unsigned int seed,
    unsigned int lane_offset, void* us, void* u_final, void* t_final,
    void* stats, void* stream) {
  if (event_id <= 0) return -1;
  const repro_sde::LaunchArgs a{u0,   p,       table,       N,       n_steps,
                                save_every, t0, dt,         t_end,   seed,
                                lane_offset, {terminal, direction, bisect_iters},
                                us, u_final, t_final, stats,
                                static_cast<cudaStream_t>(stream)};
  return repro_sde::dispatch(dtype_id, prob_id, event_id, stepper_id,
                             use_table, a);
}

// The data form: the problem functor prob_id (3, the rate-table GBM)
// reads the n_data tables of `data` (device pointers), `data_shape` (kx, ky
// per table; ky = 0 in 1-D) and `data_grid` (x0, dx, y0, dy per table).  -1
// for an unregistered combination or a bad table count.
extern "C" int sde_ensemble_data_launch(
    int dtype_id, int prob_id, int stepper_id, int use_table, int n_data,
    const void* const* data, const int* data_shape, const double* data_grid,
    const void* u0, const void* p, const void* table, int N, int n_steps,
    int save_every, double t0, double dt, double t_end, unsigned int seed,
    unsigned int lane_offset, void* us, void* u_final, void* t_final,
    void* stats, void* stream) {
  repro_sde::LaunchArgs a{u0,   p,       table,       N,       n_steps,
                          save_every, t0, dt,         t_end,   seed,
                          lane_offset, {0, 0, 0}, us, u_final, t_final,
                          stats, static_cast<cudaStream_t>(stream)};
  if (!repro_data::make_tables(n_data, data, data_shape, data_grid, a.data))
    return -1;
  switch (dtype_id) {
    case 0: return repro_sde::by_data<float>(prob_id, stepper_id, use_table,
                                             a);
    case 1: return repro_sde::by_data<double>(prob_id, stepper_id, use_table,
                                              a);
  }
  return -1;
}

// The counter normals of (step0 + s, row, lane_offset + lane) for s < steps,
// row < rows, lane < lanes, laid out (steps, rows, lanes); words is
// (2, steps, rows, lanes) uint32, z float.  The caller keeps
// steps * rows * lanes below 2^31.
extern "C" int sde_normals_launch(unsigned int seed, long long step0,
                                  int steps, int rows, int lanes,
                                  unsigned int lane_offset, void* words,
                                  void* z, void* stream) {
  const long long total = static_cast<long long>(steps) * rows * lanes;
  if (total <= 0) return -1;
  const long long grid = (total + repro_sde::kBlock - 1) / repro_sde::kBlock;
  repro_sde::sde_normals_kernel<<<static_cast<unsigned int>(grid),
                                  repro_sde::kBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      seed, step0, rows, lanes, total, lane_offset,
      static_cast<uint32_t*>(words), static_cast<float*>(z));
  return static_cast<int>(cudaGetLastError());
}
