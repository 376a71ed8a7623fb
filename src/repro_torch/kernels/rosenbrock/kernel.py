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
hook then carries the same registration.  Any other ``f(u, p, t)`` (or a
registered f with a Jacobian hook that is not its functor's) reaches it
through the automated translation (`repro_torch.translate`): f is traced,
a given Jacobian hook is traced too (the (n, n) Jacobian of the same
problem), ``jac=None`` takes the derived Jacobian (forward mode on the
traced f, as the plain version's `torch.func.jacfwd`), ∂f/∂t is derived,
and the kernel is compiled for them, the tableau and the dtype in a
generated translation unit.  An event reaches the kernel through its
`device_event` functor (`repro_torch.kernels.events`); the event forms are
compiled in float64, the stiff family's precision, for registered RHS
only.  A data-driven RHS ``f(u, p, t, data)`` reaches it through a data
functor (`DATA_LAYOUTS`), whose Jacobian and ∂f/∂t read the tables too,
through a third C entry in float64 (`kernels/interp.py`).  A translated RHS
with an event or a dataset refuses (ROADMAP queue 1 item 17, its next
slice).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.controller import PIController
from repro_torch.core.events import without_log
from repro_torch.core.problem import bind_data
from repro_torch.core.rosenbrock import (_policy, rosenbrock_nf_per_step,
                                         solve_rosenbrock)
from repro_torch.core.tableaus import RosenbrockTableau
from repro_torch.kernels.events import event_launch_args
from repro_torch.kernels.interp import (DataLayout, data_argtypes,
                                        data_launch_args)

SOURCE = "rosenbrock_ensemble.cu"
# device functor id and (n, m) for each registered RHS — as in the .cu
STIFF_FUNCTORS = {"rober": (0, 3, 3), "orego": (1, 3, 3), "vdp": (2, 2, 1),
                  "ball": (3, 2, 2), "decay": (4, 1, 1),
                  "forced_osc": (5, 2, 2)}
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
    switch) or the data entry (float64; the tables there)."""
    extra = data_argtypes() if data else [ctypes.c_int] * 4 if event else []
    return _ARGTYPES[:4] + extra + _ARGTYPES[4:]


@functools.lru_cache(maxsize=None)
def _bind(event: bool = False, unit=None):
    """The no-event entry (of SOURCE or of a generated unit), or the event
    entry."""
    from repro_torch.kernels.build import load, load_generated
    lib = load(SOURCE) if unit is None else load_generated(unit)
    fn = (lib.rosenbrock_ensemble_event_launch if event
          else lib.rosenbrock_ensemble_launch)
    fn.argtypes = argtypes(event)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind_data():
    """The data entry (float64)."""
    from repro_torch.kernels.build import load
    fn = load(SOURCE).rosenbrock_ensemble_data_launch
    fn.argtypes = argtypes(data=True)
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
    name = getattr(f, "device_stiff", None)
    if rtab.name not in TABLEAU_IDS or not _compiled_in(rtab):
        raise NotImplementedError(
            f"tableau {rtab.name!r} is not compiled into the CUDA kernel; it "
            f"has {sorted(TABLEAU_IDS)}")
    dtype = u0.dtype
    if dtype not in DTYPE_IDS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {dtype}")
    ev, unit = (), None
    if name is None or (jac is not None
                        and getattr(jac, "device_stiff", None) != name):
        if event is not None or data is not None:
            raise NotImplementedError(
                f"RHS {getattr(f, '__name__', f)!r} reaches the CUDA kernel "
                "through the automated translation, which takes no "
                f"{'event' if event is not None else 'dataset'} yet: event "
                "condition and affect functors and data functors are "
                "ROADMAP queue 1 item 17's next slice")
        n, m = u0.shape[0], p.shape[0]
        unit, rhs_id = generated_unit(f, jac, rtab, n, m, dtype), -1
        name = getattr(f, "__name__", "the RHS")
    else:
        rhs_id, n, m = STIFF_FUNCTORS[name]
        if data is not None:
            tables = data_launch_args(data, DATA_LAYOUTS.get(name), name, u0)
            if dtype != torch.float64 or event is not None:
                raise NotImplementedError(
                    "the stiff kernel's data forms are compiled in float64 "
                    f"without events, not {dtype}"
                    + (" with an event" if event is not None else ""))
        elif name in DATA_LAYOUTS:
            raise ValueError(f"the device functor {name!r} reads a dataset; "
                             "the problem has none (prob.data)")
        elif event is not None:
            ev = event_launch_args(event, name, EVENT_PAIRS, SOURCE)
            if dtype != torch.float64:
                raise NotImplementedError(
                    f"the stiff kernel's event forms are compiled in float64 "
                    f"only, not {dtype}")
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
        entry = (_bind_data() if data is not None
                 else _bind(event is not None, unit))
        rc = entry(
            DTYPE_IDS[dtype], TABLEAU_IDS[rtab.name], rhs_id,
            int(_policy(w_reuse) is not None), *ev,
            *(tables if data is not None else ()), u0.data_ptr(),
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


def generated_unit(f, jac, rtab: RosenbrockTableau, n: int, m: int, dtype):
    """The generated unit of K3 for f traced, its Jacobian (the hook
    `jac` traced, the (n, n) Jacobian of the same problem, or derived where
    `jac` is None) and its derived ∂f/∂t, on `rtab` in `dtype`."""
    from repro_torch.translate import derive
    from repro_torch.translate.trace import trace, trace_pair
    from repro_torch.translate.units import rosenbrock_unit
    if jac is None:
        tf = trace(f, n, m, outputs=(n,))
        tj = None
    else:
        tf, tj = trace_pair(f, jac, n, m, f_outputs=(n,), g_outputs=(n, n))
    key = (tf, tj, rtab.name, dtype)
    if key not in _UNITS:
        J = derive.jacobian(tf) if tj is None else tj
        _UNITS[key] = rosenbrock_unit(tf, J, derive.time_derivative(tf),
                                      rtab, dtype)
    return _UNITS[key]
