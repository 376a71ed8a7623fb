"""The generated translation units: one per (functor, kernel, dtype,
tableau or stepper).

Each includes its kernel's body header (`erk_body.cuh`,
`rosenbrock_body.cuh`, `sde_body.cuh`), defines the generated functor (and
a user tableau) in ``namespace repro_gen``, instantiates only that
functor's no-event, no-data form for its dtype and tableau or stepper, and
exports C entries under the names and with **the argument lists** of the
hand-written ones, so each wrapper's `argtypes()` binds both:

- K1: ``erk_ensemble_launch`` and K2's ``erk_ensemble_staged_launch``;
- K3: ``rosenbrock_ensemble_launch`` (eager and lazy W, the ``w_reuse``
  argument);
- K4: ``sde_ensemble_launch`` (counter stream and noise table, the
  ``use_table`` argument).

A generated entry returns -1 for another dtype and ignores the tableau,
RHS and stepper ids, which its unit fixes.  `probe_unit` builds the one-op
probe: K1's functor evaluated once a lane, under either arithmetic policy.

`kernels/build.py` compiles a unit (`load_generated`) under
``build/repro_torch/gen/``.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.translate import emit
from repro_torch.translate.ir import Traced

CSRC = Path(__file__).resolve().parents[1] / "csrc"

# the hand-written tableau structs of K1 (copied into a unit, as the .cu
# files define them) and of K3 (in rosenbrock_body.cuh), and K4's steppers
ERK_TABLEAU_STRUCTS = {"tsit5": ("erk_ensemble.cu", "Tsit5"),
                       "dopri5": ("erk_ensemble.cu", "Dopri5"),
                       "rkck54": ("erk_tableaus.cu", "Rkck54"),
                       "bs3": ("erk_tableaus.cu", "Bs3"),
                       "rkf45": ("erk_tableaus.cu", "Rkf45"),
                       "rk4": ("erk_tableaus.cu", "Rk4"),
                       "vern7": ("erk_tableaus.cu", "Vern7"),
                       "gbs10": ("erk_tableaus.cu", "Gbs10")}
ROSENBROCK_STRUCTS = {"rosenbrock23": "Ros23w", "rodas4": "Rodas4",
                      "rodas5p": "Rodas5p"}
SDE_STEPPERS = {"em": "Em", "heun_strat": "HeunStrat",
                "platen_w2": "PlatenW2", "milstein": "Milstein"}
DTYPES = {torch.float32: (0, "float"), torch.float64: (1, "double")}


class Unit(NamedTuple):
    """A generated translation unit: a short name for reports, its text."""
    name: str
    text: str


def hand_struct(source: str, name: str) -> str:
    """The text of ``struct name { ... };`` in csrc/`source`."""
    text = (CSRC / source).read_text()
    start = text.index(f"struct {name} {{")
    return text[start:text.index("\n};\n", start) + 4]


def _dtype(dtype):
    if dtype not in DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or float64, not "
                        f"{dtype}")
    return DTYPES[dtype]


def _head(kernel: str, what: str, header: str) -> str:
    return (f"// Generated by repro_torch.translate (units.py): {kernel} for "
            f"{what}.\n#include \"{header}\"\n#include \"generated.cuh\"\n\n"
            "namespace repro_gen {\n\n")


def _tail(dtype) -> str:
    kdt, real = _dtype(dtype)
    return (f"using Real = {real};\nconstexpr int kDtype = {kdt};\n\n"
            "}  // namespace repro_gen\n\n")


def erk_unit(f: Optional[Traced], tab, dtype, *,
             hand_functor: Optional[str] = None) -> Unit:
    """K1 and K2 for the traced f (or the hand-written functor
    `hand_functor`, e.g. ``repro_erk::Lorenz``, with a user tableau) on
    tableau `tab` in `dtype`.  A tableau of `ERK_TABLEAU_STRUCTS` is the
    hand-written struct, copied; any other is emitted (`emit.erk_tableau`)."""
    if f is None and hand_functor is None:
        raise ValueError("erk_unit needs a traced f or a hand functor")
    registered = tab.name in ERK_TABLEAU_STRUCTS and _is_registered(tab)
    if registered:
        source, struct = ERK_TABLEAU_STRUCTS[tab.name]
        tab_text = hand_struct(source, struct)
    else:
        if tab.interp_bpoly is not None:
            raise NotImplementedError(
                f"user tableau {tab.name!r} carries a free interpolant "
                "(interp_bpoly), which the CUDA kernel cannot take yet: "
                "ROADMAP queue 1 item 17, its next slice")
        struct = "UserTableau"
        tab_text = emit.erk_tableau(struct, tab)
    if f is not None:
        rhs_text, rhs = emit.erk_functor("Rhs", f), "Rhs"
    else:
        rhs_text, rhs = "", hand_functor
    what = (f"{f.name if f is not None else hand_functor}, tableau "
            f"{tab.name}, {_dtype(dtype)[1]}")
    form = f"Real, {struct}, {rhs}, repro_ev::NoEvent"
    text = (_head("K1 (the explicit-RK ensemble kernel) and K2", what,
                  "erk_body.cuh")
            + rhs_text + "\n" + tab_text + "\n" + _tail(dtype)
            + _ERK_ENTRIES.replace("FORM", form))
    return Unit(f"erk[{what}]", text)


def _is_registered(tab) -> bool:
    from repro_torch.kernels.tsit5.kernel import _compiled
    return _compiled(tab)


_ERK_ENTRIES = """\
// erk_ensemble_launch's arguments; tab_id and rhs_id are this unit's
extern "C" int erk_ensemble_launch(int dtype_id, int tab_id, int rhs_id,
                                   const void* u0, const void* p,
                                   const void* saveat, int S, int N, double t0,
                                   double tf, double dt0, double rtol,
                                   double atol, int adaptive,
                                   long long max_iters, void* us,
                                   void* u_final, void* t_final, void* stats,
                                   void* stream) {
  if (dtype_id != repro_gen::kDtype) return -1;
  const repro_erk::LaunchArgs a{u0, p, saveat, S, N, t0, tf, dt0, rtol, atol,
                                adaptive, max_iters, {0, 0, 0}, us, u_final,
                                t_final, stats,
                                static_cast<cudaStream_t>(stream)};
  using namespace repro_gen;
  return repro_erk::launch<FORM>(a);
}

// K2: erk_ensemble_staged_launch's arguments (repro_erk::launch_segments)
extern "C" int erk_ensemble_staged_launch(
    int dtype_id, int tab_id, int rhs_id, int n, int k, const double* t0s,
    const double* tfs, const int* starts, const void* u0, const void* p,
    const void* saveat, int N, double dt0, double rtol, double atol,
    int adaptive, long long max_iters, void* us, void* u_mid0, void* u_mid1,
    void* u_final, void* t_final, void* stats, void* stream) {
  if (dtype_id != repro_gen::kDtype) return -1;
  const repro_erk::LaunchArgs a{u0, p, saveat, 0, N, 0.0, 0.0, dt0, rtol,
                                atol, adaptive, max_iters, {0, 0, 0}, us,
                                u_final, t_final, stats,
                                static_cast<cudaStream_t>(stream)};
  using namespace repro_gen;
  return repro_erk::launch_segments(
      a, n, sizeof(Real), k, t0s, tfs, starts, u_mid0, u_mid1,
      [&](const repro_erk::LaunchArgs& s) {
        return repro_erk::launch<FORM>(s);
      });
}
"""


def rosenbrock_unit(f: Traced, jac: Traced, dfdt: Traced, rtab,
                    dtype) -> Unit:
    """K3 for the traced f, its Jacobian (traced or derived) and ∂f/∂t on
    the registered tableau `rtab`, eager and lazy W, in `dtype`."""
    struct = ROSENBROCK_STRUCTS[rtab.name]
    what = f"{f.name} (Jacobian {jac.name}), {rtab.name}, {_dtype(dtype)[1]}"
    text = (_head("K3 (the Rosenbrock ensemble kernel)", what,
                  "rosenbrock_body.cuh")
            + emit.rosenbrock_functor("Rhs", f, jac, dfdt) + "\n"
            + f"using Tab = repro_rb::{struct};\n" + _tail(dtype)
            + _RB_ENTRY)
    return Unit(f"rosenbrock[{what}]", text)


_RB_ENTRY = """\
// rosenbrock_ensemble_launch's arguments; tab_id and rhs_id are this unit's
extern "C" int rosenbrock_ensemble_launch(
    int dtype_id, int tab_id, int rhs_id, int w_reuse, const void* u0,
    const void* p, const void* saveat, int S, int N, double t0, double tf,
    double dt0, double rtol, double atol, long long max_iters,
    int nf_per_step, const double* control, void* us, void* u_final,
    void* t_final, void* stats, void* stream) {
  if (dtype_id != repro_gen::kDtype) return -1;
  const double* c = control;
  const repro_rb::Control k{c[0], c[1], c[2], c[3], c[4],  c[5],
                            c[6], c[7], c[8], c[9], c[10], c[11]};
  const repro_rb::LaunchArgs a{u0, p, saveat, S, N, t0, tf, dt0, rtol, atol,
                               max_iters, nf_per_step, k, {0, 0, 0}, us,
                               u_final, t_final, stats,
                               static_cast<cudaStream_t>(stream)};
  using namespace repro_gen;
  using repro_ev::NoEvent;
  return w_reuse ? repro_rb::launch<Real, Tab, Rhs, true, NoEvent>(a)
                 : repro_rb::launch<Real, Tab, Rhs, false, NoEvent>(a);
}
"""


def sde_unit(f: Traced, g: Traced, noise: str, gdg: Optional[Traced],
             stepper: str, dtype) -> Unit:
    """K4 for the traced drift f and diffusion g (and, diagonal, gdg) with
    `stepper`, counter stream and noise table, in `dtype`."""
    what = (f"{f.name} / {g.name} ({noise}), {stepper}, "
            f"{_dtype(dtype)[1]}")
    text = (_head("K4 (the fixed-dt SDE ensemble kernel)", what,
                  "sde_body.cuh")
            + emit.sde_functor("Prob", f, g, noise, gdg) + "\n"
            + f"using St = repro_sde::{SDE_STEPPERS[stepper]};\n"
            + _tail(dtype) + _SDE_ENTRY)
    return Unit(f"sde[{what}]", text)


_SDE_ENTRY = """\
// sde_ensemble_launch's arguments; prob_id and stepper_id are this unit's
extern "C" int sde_ensemble_launch(int dtype_id, int prob_id, int stepper_id,
                                   int use_table, const void* u0,
                                   const void* p, const void* table, int N,
                                   int n_steps, int save_every, double t0,
                                   double dt, double t_end, unsigned int seed,
                                   unsigned int lane_offset, void* us,
                                   void* u_final, void* t_final, void* stats,
                                   void* stream) {
  if (dtype_id != repro_gen::kDtype) return -1;
  const repro_sde::LaunchArgs a{u0, p, table, N, n_steps, save_every, t0, dt,
                                t_end, seed, lane_offset, {0, 0, 0}, us,
                                u_final, t_final, stats,
                                static_cast<cudaStream_t>(stream)};
  using namespace repro_gen;
  return repro_sde::by_table<Real, Prob, St, repro_ev::NoEvent>(use_table,
                                                                 a);
}
"""


def probe_unit(f: Traced, dtype) -> Unit:
    """K1's functor of the traced f evaluated once a lane: ``probe_launch(
    dtype_id, rounded, u (n, N), p (m, N), t (N,), out (n, N), N,
    stream)``, under `Rounded` (rounded = 1) or `Contracting`."""
    what = f"{f.name}, {_dtype(dtype)[1]}"
    text = (_head("the one-op probe of K1's functor", what, "arith.cuh")
            + emit.erk_functor("Rhs", f) + "\n" + _tail(dtype)
            + _PROBE_ENTRY)
    return Unit(f"probe[{what}]", text)


_PROBE_ENTRY = """\
template <class A>
__global__ void probe_kernel(const repro_gen::Real* u,
                             const repro_gen::Real* p,
                             const repro_gen::Real* t, repro_gen::Real* out,
                             int N) {
  using namespace repro_gen;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  Real uu[Rhs::n], pp[Rhs::m > 0 ? Rhs::m : 1], du[Rhs::n];
  for (int c = 0; c < Rhs::n; ++c) uu[c] = u[c * static_cast<size_t>(N) + lane];
  for (int j = 0; j < Rhs::m; ++j) pp[j] = p[j * static_cast<size_t>(N) + lane];
  Rhs::eval<A>(uu, pp, t[lane], du);
  for (int c = 0; c < Rhs::n; ++c) out[c * static_cast<size_t>(N) + lane] = du[c];
}

extern "C" int probe_launch(int dtype_id, int rounded, const void* u,
                            const void* p, const void* t, void* out, int N,
                            void* stream) {
  using namespace repro_gen;
  if (dtype_id != kDtype || N < 1) return -1;
  const int grid = (N + 127) / 128;
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, 128, 0, s>>>(static_cast<const Real*>(u),
                                static_cast<const Real*>(p),
                                static_cast<const Real*>(t),
                                static_cast<Real*>(out), N);
  };
  if (rounded)
    args(probe_kernel<repro_arith::Rounded>);
  else
    args(probe_kernel<repro_arith::Contracting>);
  return static_cast<int>(cudaGetLastError());
}
"""

