"""The generated translation units: one per form of a kernel, a tuple of
the kernel, its right-hand side functor (traced, or hand-written and named),
its event functor (traced, hand-written and named, or none), whether it
reads a dataset, the dtype and the tableau, stepper or estimator.

Each includes its kernel's body header (`erk_body.cuh`,
`rosenbrock_body.cuh`, `sde_body.cuh`, `sde_adaptive_body.cuh`), defines the
generated functors (and a user tableau) in ``namespace repro_gen``,
instantiates only the form it was asked for, and exports the C entry of
that form under the name and with **the argument list** of the
hand-written one, so each wrapper's `argtypes()` binds both:

- K1: ``erk_ensemble_launch`` and K2's ``erk_ensemble_staged_launch``
  (no event, no data), ``erk_ensemble_event_launch`` (an event),
  ``erk_ensemble_data_launch`` (a dataset, with or without an event) and,
  without an event, K2's ``erk_ensemble_data_staged_launch``;
- K3: ``rosenbrock_ensemble_launch``, ``rosenbrock_ensemble_event_launch``,
  ``rosenbrock_ensemble_data_launch`` (eager or lazy W, which the unit
  fixes: the ``w_reuse`` argument must match);
- K4: ``sde_ensemble_launch``, ``sde_ensemble_event_launch``,
  ``sde_ensemble_data_launch`` (counter stream and noise table, the
  ``use_table`` argument);
- K5: ``sde_adaptive_launch``, ``sde_adaptive_event_launch``,
  ``sde_adaptive_data_launch``.

The data-and-event form of K3, K4 and K5, which the hand-written sources
do not compile, is exported as ``*_data_event_launch``: the data entry's
arguments with the event's four ints (id, terminal, direction,
bisect_iters) after the kernel's ids, before the tables, as K1's data
entry takes them.

A generated entry returns -1 for another dtype and ignores the tableau,
RHS, event, stepper and estimator ids, which its unit fixes.  A
hand-written K3 functor a unit needs is copied from its source
(`hand_struct`), as a hand-written tableau is; K1's and K4's are in the
body headers.  `probe_unit` builds the one-op probe: K1's functor
evaluated once a lane, under either arithmetic policy.

`kernels/build.py` compiles a unit (`load_generated`) under
``build/repro_torch/gen/``.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.translate import emit
from repro_torch.translate.ir import Traced, same
from repro_torch.translate.trace import trace_interp

CSRC = Path(__file__).resolve().parents[1] / "csrc"

# the hand-written tableau structs of K1 (copied into a unit, as the .cu
# files define them) and of K3 (in rosenbrock_body.cuh), and the steppers
# of K4 and K5
ERK_TABLEAU_STRUCTS = {"tsit5": ("erk_ensemble.cu", "Tsit5"),
                       "dopri5": ("erk_ensemble.cu", "Dopri5"),
                       "rkck54": ("erk_tableaus.cu", "Rkck54"),
                       "bs3": ("erk_tableaus.cu", "Bs3"),
                       "rkf45": ("erk_tableaus.cu", "Rkf45"),
                       "rk4": ("erk_tableaus.cu", "Rk4"),
                       "vern7": ("erk_tableaus.cu", "Vern7"),
                       "gbs10": ("erk_tableaus.cu", "Gbs10")}
# the hand-written K1 structs' arithmetic flags: a user tableau with one's
# coefficients and interpolant runs under them (`twin_flags`)
ERK_TABLEAU_FLAGS = {
    "tsit5": dict(rounded=False, stream_sums=False),
    "dopri5": dict(rounded=False, stream_sums=False),
    "rkck54": dict(rounded=True, stream_sums=True),
    "bs3": dict(rounded=False, stream_sums=True),
    "rkf45": dict(rounded=False, stream_sums=True),
    "rk4": dict(rounded=False, stream_sums=True),
    "vern7": dict(rounded=True, stream_sums=True),
    "gbs10": dict(rounded=True, stream_sums=True)}
ROSENBROCK_STRUCTS = {"rosenbrock23": "Ros23w", "rodas4": "Rodas4",
                      "rodas5p": "Rodas5p"}
SDE_STEPPERS = {"em": "Em", "heun_strat": "HeunStrat",
                "platen_w2": "PlatenW2", "milstein": "Milstein"}
SDE_PAIRS = {"em": "EmPair", "milstein": "MilsteinPair"}
DTYPES = {torch.float32: (0, "float"), torch.float64: (1, "double")}

# An event form: None (no event), the C++ name of a hand-written functor of
# events.cuh, or the traced (condition, affect or None).
EventForm = Union[None, str, Tuple[Traced, Optional[Traced]]]


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


def _head(kernel: str, what: str, header: str, prelude: str = "") -> str:
    return (f"// Generated by repro_torch.translate (units.py): {kernel} for "
            f"{what}.\n#include \"{header}\"\n#include \"generated.cuh\"\n\n"
            + prelude + "namespace repro_gen {\n\n")


def _tail(dtype) -> str:
    kdt, real = _dtype(dtype)
    return (f"using Real = {real};\nconstexpr int kDtype = {kdt};\n\n"
            "}  // namespace repro_gen\n\n")


def _event(event: EventForm) -> Tuple[str, str, str]:
    """(the text defining the event functor, its C++ name, a note for the
    unit's name)."""
    if event is None:
        return "", "repro_ev::NoEvent", ""
    if isinstance(event, str):
        return "", event, f", event {event}"
    cond, affect = event
    return (emit.event_functor("Ev", cond, affect) + "\n", "Ev",
            f", event {cond.name} (traced)")


def _entry(name: str, ids: str, event: bool, data: bool, rest: str,
           args: str, call: str, guard: str = "") -> str:
    """A C entry: `ids` (the kernel's ids), the event's four ints and the
    tables where the form has them, then `rest`; it returns -1 for another
    dtype (or where `guard`, a C condition, holds); `args` initialises the
    kernel's LaunchArgs `a` from them (EV standing for the event's
    Config), `call` launches."""
    params = ids
    if event:
        params += ("int event_id, int terminal, int direction, "
                   "int bisect_iters, ")
    if data:
        params += ("int n_data, const void* const* data, "
                   "const int* data_shape, const double* data_grid, ")
    ev = "{terminal, direction, bisect_iters}" if event else "{0, 0, 0}"
    tables = ("  if (!repro_data::make_tables(n_data, data, data_shape, "
              "data_grid, a.data))\n    return -1;\n" if data else "")
    lines, line = [], f'extern "C" int {name}('
    for arg in (params + rest).split(", "):
        if len(line) + len(arg) + 2 > 79:
            lines.append(line.rstrip())
            line = "    "
        line += arg + ", "
    lines.append(line[:-2] + ") {")
    return ("\n".join(lines) + "\n"
            f"  if (dtype_id != repro_gen::kDtype{guard}) return -1;\n"
            f"{args.replace('EV', ev)}{tables}"
            "  using namespace repro_gen;\n"
            f"  {call}\n}}\n")


def _entry_name(base: str, event: bool, data: bool) -> str:
    return (base + ("_data" if data else "") + ("_event" if event else "")
            + "_launch")


# ---------------------------------------------------------------------------
# K1 and K2
# ---------------------------------------------------------------------------

def erk_unit(f: Optional[Traced], tab, dtype, *,
             hand_functor: Optional[str] = None, event: EventForm = None,
             data: bool = False) -> Unit:
    """K1 and K2 for the traced f (or the hand-written functor
    `hand_functor`, e.g. ``repro_erk::Lorenz``) on tableau `tab` in
    `dtype`, with the event form `event` and, where `data`, the dataset's
    tables.  A tableau of `ERK_TABLEAU_STRUCTS` is the hand-written struct,
    copied; any other is emitted (`emit.erk_tableau`), with its free
    interpolant traced (`trace_interp`) into the struct's weight function
    and its arithmetic flags from `twin_flags`."""
    if f is None and hand_functor is None:
        raise ValueError("erk_unit needs a traced f or a hand functor")
    registered = tab.name in ERK_TABLEAU_STRUCTS and _is_registered(tab)
    if registered:
        source, struct = ERK_TABLEAU_STRUCTS[tab.name]
        tab_text = hand_struct(source, struct)
    else:
        interp = None if tab.interp_bpoly is None else trace_interp(
            tab.interp_bpoly, tab.stages)
        struct = "UserTableau"
        tab_text = emit.erk_tableau(struct, tab, interp,
                                    **twin_flags(tab, interp))
    if f is not None:
        rhs_text, rhs = emit.erk_functor("Rhs", f), "Rhs"
    else:
        rhs_text, rhs = "", hand_functor
    ev_text, ev, ev_note = _event(event)
    what = (f"{f.name if f is not None else hand_functor}, tableau "
            f"{tab.name}, {_dtype(dtype)[1]}{ev_note}"
            + (", data" if data else ""))
    body = rhs_text + "\n" + ev_text + tab_text + "\n" + _tail(dtype)
    if event is None and not data:
        entries = _ERK_ENTRIES.replace(
            "FORM", f"Real, {struct}, {rhs}, repro_ev::NoEvent")
    else:
        form = (f"Real, {struct}, {rhs}, {ev}"
                + (", repro_data::Tables" if data else ""))
        entries = _erk_entries(form, event is not None, data)
    text = (_head("K1 (the explicit-RK ensemble kernel) and K2", what,
                  "erk_body.cuh") + body + entries)
    return Unit(f"erk[{what}]", text)


def _is_registered(tab) -> bool:
    from repro_torch.kernels.tsit5.kernel import _compiled
    return _compiled(tab)


def twin_flags(tab, interp: Optional[Traced]) -> dict:
    """The arithmetic flags (``rounded``, ``stream_sums``) of a user
    tableau's struct: those of the hand-written struct
    (`ERK_TABLEAU_FLAGS`) of the compiled tableau with its coefficients and
    its free interpolant (the same IR, or
    none on both), which runs the same method under another name; else
    every operation rounded on its own, the sums streamed, so that the
    kernel computes what the plain version does."""
    from repro_torch.core.tableaus import TABLEAUS
    from repro_torch.kernels.tsit5.kernel import same_coefficients
    for name, flags in ERK_TABLEAU_FLAGS.items():
        ref = TABLEAUS[name]
        if not same_coefficients(tab, ref) or (
                (ref.interp_bpoly is None) != (interp is None)):
            continue
        if interp is not None and not same(
                interp, trace_interp(ref.interp_bpoly, ref.stages)):
            continue
        return dict(flags)
    return dict(rounded=True, stream_sums=True)


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

_ERK_REST = ("const void* u0, const void* p, const void* saveat, int S, "
             "int N, double t0, double tf, double dt0, double rtol, "
             "double atol, int adaptive, long long max_iters, void* us, "
             "void* u_final, void* t_final, void* stats, void* stream")
_ERK_ARGS = ("  repro_erk::LaunchArgs a{u0, p, saveat, S, N, t0, tf, dt0, "
             "rtol, atol, adaptive,\n                          max_iters, EV, "
             "us, u_final, t_final, stats,\n"
             "                          static_cast<cudaStream_t>(stream)};\n")
_ERK_DATA_STAGED = """\
// K2: erk_ensemble_data_staged_launch's arguments
extern "C" int erk_ensemble_data_staged_launch(
    int dtype_id, int tab_id, int rhs_id, int n, int k, const double* t0s,
    const double* tfs, const int* starts, int n_data,
    const void* const* data, const int* data_shape, const double* data_grid,
    const void* u0, const void* p, const void* saveat, int N, double dt0,
    double rtol, double atol, int adaptive, long long max_iters, void* us,
    void* u_mid0, void* u_mid1, void* u_final, void* t_final, void* stats,
    void* stream) {
  if (dtype_id != repro_gen::kDtype) return -1;
  repro_erk::LaunchArgs a{u0, p, saveat, 0, N, 0.0, 0.0, dt0, rtol, atol,
                          adaptive, max_iters, {0, 0, 0}, us, u_final,
                          t_final, stats, static_cast<cudaStream_t>(stream)};
  if (!repro_data::make_tables(n_data, data, data_shape, data_grid, a.data))
    return -1;
  using namespace repro_gen;
  return repro_erk::launch_segments(
      a, n, sizeof(Real), k, t0s, tfs, starts, u_mid0, u_mid1,
      [&](const repro_erk::LaunchArgs& s) {
        return repro_erk::launch<FORM>(s);
      });
}
"""


def _erk_entries(form: str, event: bool, data: bool) -> str:
    """The event entry, or the data entry (whose arguments carry the
    event's, as the hand-written one's do) and, without an event, K2's
    data entry."""
    text = _entry(_entry_name("erk_ensemble", event and not data, data),
                  "int dtype_id, int tab_id, int rhs_id, ",
                  event or data, data, _ERK_REST, _ERK_ARGS,
                  f"return repro_erk::launch<{form}>(a);")
    if data and not event:
        text += "\n" + _ERK_DATA_STAGED.replace("FORM", form)
    return text


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def rosenbrock_unit(f: Optional[Traced], jac: Optional[Traced],
                    dfdt: Optional[Traced], rtab, dtype, *,
                    hand_functor: Optional[str] = None,
                    event: EventForm = None, data: bool = False,
                    w_reuse: bool = False) -> Unit:
    """K3 for the traced f, its Jacobian (traced or derived) and ∂f/∂t (or
    the hand-written functor `hand_functor` of `rosenbrock_ensemble.cu`, a
    struct name there, copied) on the registered tableau `rtab`, eager or
    lazy W (`w_reuse`; the entry returns -1 for the other), in `dtype`,
    with the event form `event` and, where `data`, the dataset's
    tables."""
    struct = ROSENBROCK_STRUCTS[rtab.name]
    ev_text, ev, ev_note = _event(event)
    if f is not None:
        rhs_text, rhs, prelude = emit.rosenbrock_functor("Rhs", f, jac,
                                                         dfdt), "Rhs", ""
        name = f"{f.name} (Jacobian {jac.name})"
    else:
        from repro_torch.kernels.rosenbrock.kernel import SOURCE
        rhs_text, rhs = "", f"repro_rb::{hand_functor}"
        prelude = ("namespace repro_rb {\n\n// copied from " + SOURCE
                   + "\n" + hand_struct(SOURCE, hand_functor)
                   + "\n}  // namespace repro_rb\n\n")
        name = f"repro_rb::{hand_functor}"
    wr = "true" if w_reuse else "false"
    what = (f"{name}, {rtab.name} {'lazy W' if w_reuse else 'eager'}, "
            f"{_dtype(dtype)[1]}{ev_note}" + (", data" if data else ""))
    body = (rhs_text + "\n" + ev_text + f"using Tab = repro_rb::{struct};\n"
            + _tail(dtype))
    if event is None and not data:
        entries = _RB_ENTRY.replace("Tab, Rhs,", f"Tab, {rhs},").replace(
            "WREUSE", wr)
    else:
        dat = ", repro_data::Tables" if data else ""
        entries = _entry(
            _entry_name("rosenbrock_ensemble", event is not None, data),
            "int dtype_id, int tab_id, int rhs_id, int w_reuse, ",
            event is not None, data, _RB_REST, _RB_ARGS,
            f"return repro_rb::launch<Real, Tab, {rhs}, {wr}, {ev}{dat}>(a);",
            guard=f" || (w_reuse != 0) != {wr}")
    text = (_head("K3 (the Rosenbrock ensemble kernel)", what,
                  "rosenbrock_body.cuh", prelude) + body + entries)
    return Unit(f"rosenbrock[{what}]", text)


_RB_ENTRY = """\
// rosenbrock_ensemble_launch's arguments; tab_id, rhs_id and w_reuse are
// this unit's
extern "C" int rosenbrock_ensemble_launch(
    int dtype_id, int tab_id, int rhs_id, int w_reuse, const void* u0,
    const void* p, const void* saveat, int S, int N, double t0, double tf,
    double dt0, double rtol, double atol, long long max_iters,
    int nf_per_step, const double* control, void* us, void* u_final,
    void* t_final, void* stats, void* stream) {
  if (dtype_id != repro_gen::kDtype || (w_reuse != 0) != WREUSE) return -1;
  const double* c = control;
  const repro_rb::Control k{c[0], c[1], c[2], c[3], c[4],  c[5],
                            c[6], c[7], c[8], c[9], c[10], c[11]};
  const repro_rb::LaunchArgs a{u0, p, saveat, S, N, t0, tf, dt0, rtol, atol,
                               max_iters, nf_per_step, k, {0, 0, 0}, us,
                               u_final, t_final, stats,
                               static_cast<cudaStream_t>(stream)};
  using namespace repro_gen;
  return repro_rb::launch<Real, Tab, Rhs, WREUSE, repro_ev::NoEvent>(a);
}
"""
_RB_REST = ("const void* u0, const void* p, const void* saveat, int S, "
            "int N, double t0, double tf, double dt0, double rtol, "
            "double atol, long long max_iters, int nf_per_step, "
            "const double* control, void* us, void* u_final, void* t_final, "
            "void* stats, void* stream")
_RB_ARGS = """\
  const double* c = control;
  const repro_rb::Control k{c[0], c[1], c[2], c[3], c[4],  c[5],
                            c[6], c[7], c[8], c[9], c[10], c[11]};
  repro_rb::LaunchArgs a{u0, p, saveat, S, N, t0, tf, dt0, rtol, atol,
                         max_iters, nf_per_step, k, EV, us, u_final,
                         t_final, stats, static_cast<cudaStream_t>(stream)};
"""


# ---------------------------------------------------------------------------
# K4 and K5
# ---------------------------------------------------------------------------

class SdeFunctor(NamedTuple):
    """The drift/noise functor of a K4 or K5 unit: traced (f, g and the
    derived gdg and ddb where the stepper needs them) or the hand-written
    struct `hand` of sde_problems.cuh (e.g. ``repro_sde::Gbm``)."""
    f: Optional[Traced] = None
    g: Optional[Traced] = None
    noise: str = "diagonal"
    gdg: Optional[Traced] = None
    ddb: Optional[Traced] = None
    hand: Optional[str] = None


def _sde_prob(prob: SdeFunctor) -> Tuple[str, str, str]:
    """(the text defining the functor, its C++ name, its name in reports)."""
    if prob.hand is not None:
        return "", prob.hand, prob.hand
    return (emit.sde_functor("Prob", prob.f, prob.g, prob.noise, prob.gdg,
                             prob.ddb), "Prob",
            f"{prob.f.name} / {prob.g.name} ({prob.noise})")


def sde_unit(f: Optional[Traced], g: Optional[Traced], noise: str,
             gdg: Optional[Traced], stepper: str, dtype, *,
             hand_functor: Optional[str] = None, event: EventForm = None,
             data: bool = False) -> Unit:
    """K4 for the traced drift f and diffusion g (and, diagonal, gdg), or
    the hand-written functor `hand_functor`, with `stepper`, counter stream
    and noise table, in `dtype`, with the event form `event` and, where
    `data`, the dataset's tables."""
    prob_text, prob, name = _sde_prob(SdeFunctor(f, g, noise, gdg, None,
                                                 hand_functor))
    ev_text, ev, ev_note = _event(event)
    what = (f"{name}, {stepper}, {_dtype(dtype)[1]}{ev_note}"
            + (", data" if data else ""))
    text = (_head("K4 (the fixed-dt SDE ensemble kernel)", what,
                  "sde_body.cuh")
            + prob_text + "\n" + ev_text
            + f"using St = repro_sde::{SDE_STEPPERS[stepper]};\n"
            + _tail(dtype))
    if event is None and not data and hand_functor is None:
        text += _SDE_ENTRY
    else:
        dat = ", repro_data::Tables" if data else ""
        text += _entry(
            _entry_name("sde_ensemble", event is not None, data),
            "int dtype_id, int prob_id, int stepper_id, int use_table, ",
            event is not None, data, _SDE_REST, _SDE_ARGS,
            f"return repro_sde::by_table<Real, {prob}, St, {ev}{dat}>("
            "use_table, a);")
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
_SDE_REST = ("const void* u0, const void* p, const void* table, int N, "
             "int n_steps, int save_every, double t0, double dt, "
             "double t_end, unsigned int seed, unsigned int lane_offset, "
             "void* us, void* u_final, void* t_final, void* stats, "
             "void* stream")
_SDE_ARGS = """\
  repro_sde::LaunchArgs a{u0, p, table, N, n_steps, save_every, t0, dt,
                          t_end, seed, lane_offset, EV, us, u_final,
                          t_final, stats, static_cast<cudaStream_t>(stream)};
"""


def sde_adaptive_unit(prob: SdeFunctor, stepper: str, error_est: str,
                      dtype, *, event: EventForm = None,
                      data: bool = False) -> Unit:
    """K5 for the functor `prob` with `stepper` and its embedded pair
    (``error_est="embedded"``) or step doubling, on the virtual Brownian
    tree and the work queue, in `dtype`, with the event form `event` and,
    where `data`, the dataset's tables."""
    prob_text, pname, name = _sde_prob(prob)
    pair = error_est == "embedded"
    st = (SDE_PAIRS if pair else SDE_STEPPERS)[stepper]
    ev_text, ev, ev_note = _event(event)
    what = (f"{name}, {stepper} {error_est}, {_dtype(dtype)[1]}{ev_note}"
            + (", data" if data else ""))
    dat = ", repro_data::Tables" if data else ""
    text = (_head("K5 (the adaptive SDE ensemble kernel)", what,
                  "sde_adaptive_body.cuh")
            + prob_text + "\n" + ev_text
            + f"using St = repro_sde_adaptive::{st};\n" + _tail(dtype)
            + _entry(_entry_name("sde_adaptive", event is not None, data),
                     "int dtype_id, int prob_id, int stepper_id, "
                     "int est_id, ",
                     event is not None, data, _K5_REST, _K5_ARGS,
                     f"return repro_sde_adaptive::launch<Real, {pname}, St, "
                     f"{'true' if pair else 'false'}, {ev}{dat}>(a);"))
    return Unit(f"sde_adaptive[{what}]", text)


_K5_REST = ("const void* u0, const void* p, const void* saveat, int S, "
            "int N, double t0, double tf, double dt0, double rtol, "
            "double atol, long long max_iters, unsigned int seed, "
            "unsigned int lane_offset, int depth, int nf_per_attempt, "
            "const double* control, void* us, void* u_final, void* t_final, "
            "void* stats, void* queue, void* stream")
_K5_ARGS = """\
  const double* c = control;
  const repro_sde_adaptive::Control k{c[0], c[1], c[2], c[3],
                                      c[4], c[5], c[6], c[7]};
  repro_sde_adaptive::LaunchArgs a{u0, p, saveat, S, N, t0, tf, dt0, rtol,
                                   atol, max_iters, seed, lane_offset,
                                   depth, nf_per_attempt, k, EV, us,
                                   u_final, t_final, stats, queue,
                                   static_cast<cudaStream_t>(stream)};
"""


# ---------------------------------------------------------------------------
# the one-op probe
# ---------------------------------------------------------------------------

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
