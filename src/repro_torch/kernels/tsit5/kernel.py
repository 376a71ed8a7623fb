"""ctypes binding of the fused explicit-RK ensemble kernel
(`csrc/erk_ensemble.cu`), which replaces the TPU kernel
`repro.kernels.ensemble_kernel.run_ensemble_kernel` + `erk_body`.

`erk_ensemble` is the wrapper: for CUDA tensors it checks its inputs,
allocates the outputs and launches the kernel on the current stream (or
raises); for CPU tensors, and only for them, it runs the plain PyTorch
version of the same function, the lanes-mode solver
`repro_torch.core.solvers.solve_adaptive(lanes=True)`.

The kernel cannot call a Python RHS.  An RHS reaches it through the
hand-written device functor it is registered with by `device_rhs`, and an
event through its `device_event` functor (`repro_torch.kernels.events`).
A data-driven RHS ``f(u, p, t, data)`` reaches it through a data functor
(`DATA_LAYOUTS`), which reads the dataset's tables on the card through a
second C entry (`kernels/interp.py`);
turning an arbitrary ``f(u, p, t)`` into device code automatically (the
paper's "automated translation") is a later ROADMAP item.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.events import without_log
from repro_torch.core.problem import bind_data
from repro_torch.core.solvers import AdaptiveOptions, solve_adaptive
from repro_torch.core.tableaus import Tableau
from repro_torch.kernels.events import event_launch_args
from repro_torch.kernels.interp import (DataLayout, data_argtypes,
                                        data_launch_args)

SOURCE = "erk_ensemble.cu"
# device functor id and (n, m) for each registered RHS — as in the .cu
RHS_FUNCTORS = {"lorenz": (0, 3, 3), "sho": (1, 2, 1), "ball": (2, 2, 2),
                "decay": (3, 1, 1), "forced_osc": (4, 2, 2),
                "forced_osc_onehot": (5, 2, 2), "forced_osc_cubic": (6, 2, 2)}
# the data functors and the dataset each reads (`by_data`)
_FORCE = DataLayout((("force", 1),))
DATA_LAYOUTS = {"forced_osc": _FORCE, "forced_osc_onehot": _FORCE,
                "forced_osc_cubic": _FORCE}
# the (RHS, event) pairs whose event form the .cu compiles (`by_event`),
# and those of the data forms (`by_data`)
EVENT_PAIRS = {("ball", "ball_bounce"), ("decay", "decay_half")}
DATA_EVENT_PAIRS = {("forced_osc", "osc_level")}
TABLEAU_IDS = {"tsit5": 0, "dopri5": 1}
DTYPE_IDS = {torch.float32: 0, torch.float64: 1}

# launches of the CUDA kernel since the counter was last set to 0
launches = 0


def device_rhs(name: str):
    """Register a Python RHS with its hand-written device functor."""
    if name not in RHS_FUNCTORS:
        raise ValueError(f"no device functor {name!r} in {SOURCE}; have "
                         f"{sorted(RHS_FUNCTORS)}")

    def mark(f):
        f.device_rhs = name
        return f

    return mark


_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
    + [ctypes.c_double] * 5 + [ctypes.c_int, ctypes.c_longlong] \
    + [ctypes.c_void_p] * 5


@functools.lru_cache(maxsize=None)
def _bind_data():
    """The data entry: the event id, terminal, direction and bisect_iters
    (0 without an event), then the tables, after the RHS id."""
    from repro_torch.kernels.build import load
    fn = load(SOURCE).erk_ensemble_data_launch
    fn.argtypes = (_ARGTYPES[:3] + [ctypes.c_int] * 4 + data_argtypes()
                   + _ARGTYPES[3:])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind(event: bool = False):
    """The no-event entry, or the event entry (which takes the event id,
    terminal, direction and bisect_iters after the RHS id)."""
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = lib.erk_ensemble_event_launch if event else lib.erk_ensemble_launch
    fn.argtypes = (_ARGTYPES[:3] + [ctypes.c_int] * 4 + _ARGTYPES[3:]
                   if event else _ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def _plain(f, tab, u0, p, saveat, t0, tf, dt0, rtol, atol, adaptive,
           max_iters, event=None):
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive)
    res = without_log(solve_adaptive(f, tab, u0, p, t0, tf, dt0,
                                     saveat=saveat, opts=opts, event=event,
                                     lanes=True), event)
    zero = torch.zeros_like(res.naccept)
    stats = torch.stack([res.naccept, res.nreject, res.status, res.nf,
                         zero, zero])
    return res.us, res.u_final, res.t_final, stats


def erk_ensemble(f, tab: Tableau, u0, p, saveat, *, t0: float, tf: float,
                 dt0: float, rtol: float, atol: float, adaptive: bool,
                 max_iters: int, event=None, data=None):
    """Integrate every lane of u0 (n, N) with parameters p (m, N) from t0
    to tf, with an optional `Event` (FSAL off, as in the plain version) and
    an optional dataset `data`, which `f` then takes as a fourth argument.
    Returns us (S, n, N), u_final (n, N), t_final (N,) and stats (6, N)
    int32 with rows (naccept, nreject, status, nf, njac, nfact)."""
    if u0.device.type == "cpu":
        return _plain(bind_data(f, data), tab, u0, p, saveat, t0, tf, dt0,
                      rtol, atol, adaptive, max_iters, event)
    if u0.device.type != "cuda":
        raise ValueError(f"erk_ensemble runs on CPU or CUDA tensors, not "
                         f"{u0.device.type}")
    name = getattr(f, "device_rhs", None)
    if name is None:
        raise NotImplementedError(
            f"RHS {getattr(f, '__name__', f)!r} has no device form: register "
            f"a functor in {SOURCE} with @device_rhs (automatic translation "
            "of a Python RHS is ROADMAP queue 1 item 17)")
    if tab.name not in TABLEAU_IDS:
        raise NotImplementedError(
            f"tableau {tab.name!r} is not compiled into the CUDA kernel; it "
            f"has {sorted(TABLEAU_IDS)}")
    rhs_id, n, m = RHS_FUNCTORS[name]
    if data is not None:
        tables = data_launch_args(data, DATA_LAYOUTS.get(name), name, u0)
        ev = ((0, 0, 0, 0) if event is None
              else event_launch_args(event, name, DATA_EVENT_PAIRS, SOURCE))
    elif name in DATA_LAYOUTS:
        raise ValueError(f"the device functor {name!r} reads a dataset; "
                         "the problem has none (prob.data)")
    else:
        ev = (() if event is None
              else event_launch_args(event, name, EVENT_PAIRS, SOURCE))
    dtype = u0.dtype
    if dtype not in DTYPE_IDS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {dtype}")
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

    us = torch.empty((S, n, N), dtype=dtype, device=u0.device)
    u_final = torch.empty((n, N), dtype=dtype, device=u0.device)
    t_final = torch.empty((N,), dtype=dtype, device=u0.device)
    stats = torch.empty((6, N), dtype=torch.int32, device=u0.device)
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    with torch.cuda.device(u0.device):
        entry = (_bind_data() if data is not None
                 else _bind(event is not None))
        rc = entry(
            DTYPE_IDS[dtype], TABLEAU_IDS[tab.name], rhs_id, *ev,
            *(tables if data is not None else ()), u0.data_ptr(), p.data_ptr(), saveat.data_ptr(), S, N, float(t0),
            float(tf), float(dt0), float(rtol), float(atol),
            int(bool(adaptive)), int(max_iters), us.data_ptr(),
            u_final.data_ptr(), t_final.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"erk_ensemble launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return us, u_final, t_final, stats
