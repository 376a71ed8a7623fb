"""ctypes binding of the fused Rosenbrock stiff ensemble kernel
(`csrc/rosenbrock_ensemble.cu`), which replaces the TPU kernel
`repro.kernels.ensemble_kernel.run_ensemble_kernel` + `rosenbrock_body`
with the lanes LU (`repro.kernels.lu.kernel.lu_factor_lanes`,
`lu_resolve_lanes`) inlined.

`rosenbrock_ensemble` is the wrapper: for CUDA tensors it checks its
inputs, allocates the outputs and launches the kernel on the current
stream (or raises); for CPU tensors, and only for them, it runs the plain
version of the same function, the lanes engine
`repro_torch.core.rosenbrock.solve_rosenbrock(linsolve="lanes")`.

The kernel cannot call a Python RHS.  A registered RHS reaches it through
the hand-written device functor it is registered with by `device_stiff`,
which gives f, its Jacobian ∂f/∂u and ∂f/∂t; a problem's analytic Jacobian
hook then carries the same registration.  `rosenbrock_ensemble.cu`
compiles those functors without an event in f32 and f64, their event forms
for its `EVENT_PAIRS` in f64, and its data functor (`DATA_LAYOUTS`, whose
Jacobian and ∂f/∂t read the tables too, through a third C entry,
`kernels/interp.py`) in f64 without an event.  Every other form goes
through the automated translation (`repro_torch.translate`), in a
generated translation unit: any other ``f(u, p, t)`` or ``f(u, p, t,
data)`` (or a registered f with a Jacobian hook that is not its
functor's) is traced, a given Jacobian hook is traced too (the (n, n)
Jacobian of the same problem), ``jac=None`` takes the derived Jacobian
(forward mode on the traced f, as the plain version's `torch.func.jacfwd`;
a lookup's tangent in its mode), ∂f/∂t is derived; an event whose
condition and affect are not registered together is traced; a registered
functor in a form the source lacks (an event in f32, an event the source
does not pair with it, data with an event) runs its hand-written struct,
copied into the unit.  `route` decides between source and unit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.controller import PIController
from repro_torch.core.events import without_log
from repro_torch.core.problem import bind_data
from repro_torch.core.rosenbrock import (_policy, rosenbrock_nf_per_step,
                                         solve_rosenbrock)
from repro_torch.core.tableaus import RosenbrockTableau
from repro_torch.kernels.events import (compiled_in, event_form,
                                        event_launch_args)
from repro_torch.kernels.interp import (DataLayout, data_argtypes,
                                        data_launch_args, matches)

SOURCE = "rosenbrock_ensemble.cu"


class StiffFunctor(NamedTuple):
    """A registered RHS's device functor: its id in SOURCE, its state's and
    parameters' sizes, and its struct there, which a generated unit copies
    for a form the source does not compile."""
    id: int
    n: int
    m: int
    struct: str


# as in the .cu
STIFF_FUNCTORS = {
    "rober": StiffFunctor(0, 3, 3, "Rober"),
    "orego": StiffFunctor(1, 3, 3, "Orego"),
    "vdp": StiffFunctor(2, 2, 1, "Vdp"), "ball": StiffFunctor(3, 2, 2, "Ball"),
    "decay": StiffFunctor(4, 1, 1, "Decay"),
    "forced_osc": StiffFunctor(5, 2, 2, "ForcedOsc")}
# the data functors and the dataset each reads (`by_data`, float64)
DATA_LAYOUTS = {"forced_osc": DataLayout((("force", 1),))}
# the (RHS, event) pairs whose event form the .cu compiles, in float64
# (`by_event`)
EVENT_PAIRS = {("rober", "rober_half"), ("ball", "ball_bounce"),
               ("decay", "decay_half")}
TABLEAU_IDS = {"rosenbrock23": 0, "rodas4": 1, "rodas5p": 2}
DTYPE_IDS = {torch.float32: 0, torch.float64: 1}

# launches of the CUDA kernel since the counter was last set to 0
launches = 0


def device_stiff(name: str):
    """Register a Python RHS, or its analytic Jacobian, with the stiff
    kernel's hand-written device functor."""
    if name not in STIFF_FUNCTORS:
        raise ValueError(f"no device functor {name!r} in {SOURCE}; have "
                         f"{sorted(STIFF_FUNCTORS)}")

    def mark(fn):
        fn.device_stiff = name
        return fn

    return mark


_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
    + [ctypes.c_double] * 5 + [ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_void_p] * 6


def argtypes(event: bool = False, data: bool = False):
    """The ctypes argument types of the no-event entry, the event entry
    (the event id, terminal, direction and bisect_iters after the lazy-W
    switch), the data entry (the tables there) or a generated unit's
    data-and-event entry (the event's four, then the tables)."""
    extra = (([ctypes.c_int] * 4 if event else [])
             + (data_argtypes() if data else []))
    return _ARGTYPES[:4] + extra + _ARGTYPES[4:]


@functools.lru_cache(maxsize=None)
def _bind(event: bool = False, unit=None, data: bool = False):
    """The entry of SOURCE (unit None) or of a generated unit for the form
    (event, data)."""
    from repro_torch.kernels.build import load, load_generated
    lib = load(SOURCE) if unit is None else load_generated(unit)
    fn = getattr(lib, "rosenbrock_ensemble" + ("_data" if data else "")
                 + ("_event" if event else "") + "_launch")
    fn.argtypes = argtypes(event, data)
    fn.restype = ctypes.c_int
    return fn



def _plain(f, rtab, u0, p, saveat, *, jac, t0, tf, dt0, rtol, atol,
           max_iters, w_reuse, event=None):
    res = without_log(solve_rosenbrock(
        f, rtab, u0, p, t0, tf, dt0, rtol=rtol, atol=atol, saveat=saveat,
        max_iters=max_iters, lanes=True, linsolve="lanes", jac=jac,
        w_reuse=w_reuse, event=event), event)
    stats = torch.stack([res.naccept, res.nreject, res.status,
                         res.nf.to(torch.int32), res.njac.to(torch.int32),
                         res.nfact.to(torch.int32)])
    return res.us, res.u_final, res.t_final, stats


def controller_constants(rtab: RosenbrockTableau, w_reuse):
    """The 12 doubles the kernel takes for its step control: the PI
    controller of the order the error estimate measures (beta1, beta2,
    safety, qmin, qmax, dtmin, dtmax), then the `WReusePolicy` (dt_rtol,
    growth, enorm_limit, max_age, secant; zeros when eager)."""
    ctrl = PIController.for_order(min(rtab.order, rtab.embedded_order))
    pol = _policy(w_reuse)
    pol_v = (pol.dt_rtol, pol.growth, pol.enorm_limit, pol.max_age,
             pol.secant) if pol is not None else (0.0,) * 5
    return (ctrl.beta1, ctrl.beta2, ctrl.safety, ctrl.qmin, ctrl.qmax,
            ctrl.dtmin, ctrl.dtmax) + tuple(float(v) for v in pol_v)


def rosenbrock_ensemble(f, rtab: RosenbrockTableau, u0, p, saveat, *, jac,
                        t0: float, tf: float, dt0: float, rtol: float,
                        atol: float, max_iters: int, w_reuse=None,
                        event=None, data=None):
    """Integrate every lane of u0 (n, N) with parameters p (m, N) from t0
    to tf by the s-stage W-method `rtab`, eager or lazy-W (`w_reuse`), with
    an optional `Event` located on the method's dense output and an
    optional dataset `data`, which `f` and `jac` then take as a fourth
    argument.  Returns us (S, n, N), u_final (n, N), t_final (N,) and stats
    (6, N) int32 with rows (naccept, nreject, status, nf, njac, nfact)."""
    kw = dict(t0=t0, tf=tf, dt0=dt0, rtol=rtol, atol=atol,
              max_iters=max_iters, w_reuse=w_reuse, event=event)
    if u0.device.type == "cpu":
        return _plain(bind_data(f, data), rtab, u0, p, saveat,
                      jac=None if jac is None else bind_data(jac, data),
                      **kw)
    if u0.device.type != "cuda":
        raise ValueError(f"rosenbrock_ensemble runs on CPU or CUDA tensors, "
                         f"not {u0.device.type}")
    if rtab.name not in TABLEAU_IDS or not _compiled_in(rtab):
        raise NotImplementedError(
            f"tableau {rtab.name!r} is not compiled into the CUDA kernel; it "
            f"has {sorted(TABLEAU_IDS)}")
    dtype = u0.dtype
    if dtype not in DTYPE_IDS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {dtype}")
    unit, rhs_id, n, m = route(f, jac, rtab, event, data, n=u0.shape[0],
                               m=p.shape[0], dtype=dtype,
                               w_reuse=_policy(w_reuse) is not None)
    name = (getattr(f, "device_stiff", None) if unit is None
            else getattr(f, "__name__", "the RHS"))
    ev = () if event is None else event_launch_args(event)
    tables = (() if data is None
              else data_launch_args(data, None, name, u0))
    N = u0.shape[-1]
    for what, x, shape in (("u0", u0, (n, N)), ("p", p, (m, N)),
                           ("saveat", saveat, (saveat.shape[0],))):
        if x.device != u0.device or x.dtype != dtype:
            raise ValueError(f"{what} must be a {dtype} tensor on {u0.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous with shape {shape} "
                             f"for {name}, got {tuple(x.shape)}")
    S = saveat.shape[0]
    if S < 1 or N < 1 or N >= 2 ** 31:
        raise ValueError(f"need 1 <= N < 2^31 lanes and S >= 1 saves, got "
                         f"N={N}, S={S}")
    if S > 1 and not bool((saveat[1:] >= saveat[:-1]).all()):
        raise ValueError("the CUDA kernel needs an ascending saveat grid")

    consts = (ctypes.c_double * 12)(*controller_constants(rtab, w_reuse))
    us = torch.empty((S, n, N), dtype=dtype, device=u0.device)
    u_final = torch.empty((n, N), dtype=dtype, device=u0.device)
    t_final = torch.empty((N,), dtype=dtype, device=u0.device)
    stats = torch.empty((6, N), dtype=torch.int32, device=u0.device)
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    with torch.cuda.device(u0.device):
        entry = _bind(event is not None, unit, data is not None)
        rc = entry(
            DTYPE_IDS[dtype], TABLEAU_IDS[rtab.name], rhs_id,
            int(_policy(w_reuse) is not None), *ev, *tables, u0.data_ptr(),
            p.data_ptr(), saveat.data_ptr(), S, N, float(t0), float(tf),
            float(dt0), float(rtol), float(atol), int(max_iters),
            rosenbrock_nf_per_step(rtab), ctypes.addressof(consts),
            us.data_ptr(), u_final.data_ptr(), t_final.data_ptr(),
            stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rosenbrock_ensemble launch failed: CUDA error "
                           f"{rc}")
    global launches
    launches += 1
    return us, u_final, t_final, stats


def _compiled_in(rtab: RosenbrockTableau) -> bool:
    """The registry's tableau of that name, whose constants the .cu holds
    (a test checks them); a user tableau that only shares the name is not."""
    from repro_torch.core.tableaus import ROSENBROCK_TABLEAUS
    return ROSENBROCK_TABLEAUS.get(rtab.name) is rtab


_UNITS: dict = {}


def generated_unit(f, jac, rtab: RosenbrockTableau, n: int, m: int, dtype,
                   *, event=None, data=None, hand=None, w_reuse=False):
    """The generated unit of K3 on `rtab` in `dtype`, eager or lazy W
    (`w_reuse`), with the `Event` `event` and the dataset `data`: for f
    traced, its Jacobian (the hook
    `jac` traced, the (n, n) Jacobian of the same problem, or derived where
    `jac` is None) and its derived ∂f/∂t; or, where `hand` names a
    registered functor, its hand-written struct, copied."""
    from repro_torch.translate import derive
    from repro_torch.translate.trace import trace, trace_pair
    from repro_torch.translate.units import rosenbrock_unit
    form = event_form(event, n, m)
    if hand is not None:
        key = (hand, rtab.name, dtype, form, data is not None, w_reuse)
        if key not in _UNITS:
            _UNITS[key] = rosenbrock_unit(
                None, None, None, rtab, dtype,
                hand_functor=STIFF_FUNCTORS[hand].struct, event=form,
                data=data is not None, w_reuse=w_reuse)
        return _UNITS[key]
    if jac is None:
        tf = trace(f, n, m, outputs=(n,), data=data)
        tj = None
    else:
        tf, tj = trace_pair(f, jac, n, m, f_outputs=(n,), g_outputs=(n, n),
                            data=data)
    key = (tf, tj, rtab.name, dtype, form, w_reuse)
    if key not in _UNITS:
        J = derive.jacobian(tf) if tj is None else tj
        _UNITS[key] = rosenbrock_unit(tf, J, derive.time_derivative(tf),
                                      rtab, dtype, event=form,
                                      data=data is not None,
                                      w_reuse=w_reuse)
    return _UNITS[key]


def route(f, jac, rtab: RosenbrockTableau, event=None, data=None, *, n: int,
          m: int, dtype=torch.float64, w_reuse: bool = False):
    """(generated unit or None for SOURCE, RHS id, n, m) of a launch, eager
    or lazy W (`w_reuse`, which a unit fixes): a
    registered functor (with its own Jacobian hook or none) in the forms
    SOURCE compiles (no event in f32 and f64; the `EVENT_PAIRS` in f64; the
    data functor of `DATA_LAYOUTS` in f64 without an event) goes to SOURCE;
    in any other form it runs its hand-written struct in a unit, but for
    the f64-only data functor in f32, which is traced; any other RHS is
    traced into a unit (and so is a registered one that reads no dataset,
    given one)."""
    name = getattr(f, "device_stiff", None)
    hand = name is not None and (
        jac is None or getattr(jac, "device_stiff", None) == name)
    if hand:
        rhs_id, n, m, _ = STIFF_FUNCTORS[name]
    layout = DATA_LAYOUTS.get(name) if hand else None
    f64 = dtype == torch.float64
    if data is not None:
        if layout is not None and matches(data, layout) and f64:
            if event is None:
                return None, rhs_id, n, m
            return generated_unit(f, jac, rtab, n, m, dtype, event=event,
                                  data=data, hand=name,
                                  w_reuse=w_reuse), -1, n, m
        return generated_unit(f, jac, rtab, n, m, dtype, event=event,
                              data=data, w_reuse=w_reuse), -1, n, m
    if layout is not None:
        raise ValueError(f"the device functor {name!r} reads a dataset; "
                         "the problem has none (prob.data)")
    if not hand:
        return generated_unit(f, jac, rtab, n, m, dtype, event=event,
                              w_reuse=w_reuse), -1, n, m
    if event is None or (f64 and compiled_in(event, name, EVENT_PAIRS)):
        return None, rhs_id, n, m
    return generated_unit(f, jac, rtab, n, m, dtype, event=event,
                          hand=name, w_reuse=w_reuse), -1, n, m
