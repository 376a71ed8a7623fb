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
