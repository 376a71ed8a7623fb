"""ctypes binding of the fused explicit-RK ensemble kernel (K1: the body
`csrc/erk_body.cuh`, built in `csrc/erk_ensemble.cu` for tsit5 and dopri5
and in `csrc/erk_tableaus.cu` for the other six tableaus of
`core.tableaus.TABLEAUS`), which replaces the TPU kernel
`repro.kernels.ensemble_kernel.run_ensemble_kernel` + `erk_body`.

`erk_ensemble` is the wrapper: for CUDA tensors it checks its inputs,
allocates the outputs and launches the kernel on the current stream (or
raises); for CPU tensors, and only for them, it runs the plain PyTorch
version of the same function, the lanes-mode solver
`repro_torch.core.solvers.solve_adaptive(lanes=True)`.

The kernel cannot call a Python RHS.  A registered RHS reaches it through
the hand-written device functor it is registered with by `device_rhs`, an
event through its `device_event` functor (`repro_torch.kernels.events`),
and a data-driven RHS ``f(u, p, t, data)`` through a data functor
(`DATA_LAYOUTS`), which reads the dataset's tables on the card through a
second C entry (`kernels/interp.py`), in the forms the two sources compile.
Every other form goes through the automated translation
(`repro_torch.translate`), in a generated translation unit whose C entries
take the hand-written entries' arguments: any other ``f(u, p, t)`` or
``f(u, p, t, data)`` (traced once, with its dataset's lookups), any event
whose condition and affect are not registered together (traced), any
tableau that is not one of the compiled eight (a user tableau, e.g. from
`convert.tableau_from_arrays`), and any pairing of these that the sources
do not compile (a registered RHS with an event on one of the six tableaus
of `erk_tableaus.cu`, a data functor with another event).  `route` decides
between source and unit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.events import without_log
from repro_torch.core.problem import bind_data
from repro_torch.core.solvers import AdaptiveOptions, solve_adaptive
from repro_torch.core.tableaus import TABLEAUS, Tableau
from repro_torch.kernels.events import (compiled_in, event_form,
                                        event_launch_args)
from repro_torch.kernels.interp import (DataLayout, data_argtypes,
                                        data_launch_args, matches)
from repro_torch.translate.trace import trace

SOURCE = "erk_ensemble.cu"
# rkck54, bs3, rkf45, rk4, vern7 and gbs10: their no-event, no-data form
TABLEAUS_SOURCE = "erk_tableaus.cu"


class RhsFunctor(NamedTuple):
    """A registered RHS's device functor: its id in the sources, its
    state's and parameters' sizes, and its struct in erk_body.cuh, which a
    generated unit instantiates in a form the sources do not compile."""
    id: int
    n: int
    m: int
    struct: str


# as in the .cu files
RHS_FUNCTORS = {
    "lorenz": RhsFunctor(0, 3, 3, "Lorenz"), "sho": RhsFunctor(1, 2, 1, "Sho"),
    "ball": RhsFunctor(2, 2, 2, "Ball"), "decay": RhsFunctor(3, 1, 1, "Decay"),
    "forced_osc": RhsFunctor(4, 2, 2, "ForcedOsc<repro_data::kGather>"),
    "forced_osc_onehot": RhsFunctor(5, 2, 2,
                                    "ForcedOsc<repro_data::kOneHot>"),
    "forced_osc_cubic": RhsFunctor(6, 2, 2, "ForcedOsc<repro_data::kCubic>")}
# the data functors and the dataset each reads (`by_data`)
_FORCE = DataLayout((("force", 1),))
DATA_LAYOUTS = {"forced_osc": _FORCE, "forced_osc_onehot": _FORCE,
                "forced_osc_cubic": _FORCE}
# the (RHS, event) pairs whose event form the .cu compiles (`by_event`),
# and those of the data forms (`by_data`)
EVENT_PAIRS = {("ball", "ball_bounce"), ("decay", "decay_half")}
DATA_EVENT_PAIRS = {("forced_osc", "osc_level")}
# the tableau ids of the two C dispatches (`by_tableau` in SOURCE,
# `by_tableau_no_event` in TABLEAUS_SOURCE)
TABLEAU_IDS = {"tsit5": 0, "dopri5": 1, "rkck54": 2, "bs3": 3, "rkf45": 4,
               "rk4": 5, "vern7": 6, "gbs10": 7}
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
_STAGED_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6 \
    + [ctypes.c_int] + [ctypes.c_double] * 3 \
    + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 7


def argtypes(event: bool = False, data: bool = False,
             staged: bool = False) -> list:
    """The ctypes types of a C entry's arguments: the no-event entry; the
    event entry (the event id, terminal, direction and bisect_iters after
    the RHS id); the data entry (those four, 0 without an event, then the
    tables); the staged entries (the state size, the segment count and the
    segments' t0s, tfs and starts after the RHS id, the data one with the
    tables after those)."""
    if staged:
        return (_STAGED_ARGTYPES[:8] + (data_argtypes() if data else [])
                + _STAGED_ARGTYPES[8:])
    if event or data:
        return (_ARGTYPES[:3] + [ctypes.c_int] * 4
                + (data_argtypes() if data else []) + _ARGTYPES[3:])
    return list(_ARGTYPES)


@functools.lru_cache(maxsize=None)
def _bind_data(source=SOURCE):
    """The data entry of SOURCE or of a generated unit."""
    fn = _library(source).erk_ensemble_data_launch
    fn.argtypes = argtypes(data=True)
    fn.restype = ctypes.c_int
    return fn


def _library(source):
    """The built library of a source of csrc/ or of a generated unit."""
    from repro_torch.kernels.build import load, load_generated
    return load(source) if isinstance(source, str) else load_generated(source)


@functools.lru_cache(maxsize=None)
def _bind(event: bool = False, source=SOURCE):
    """The no-event or the event entry of `source` (a generated unit's
    included)."""
    lib = _library(source)
    if event:
        fn = lib.erk_ensemble_event_launch
    elif source == TABLEAUS_SOURCE:
        fn = lib.erk_tableaus_launch
    else:
        fn = lib.erk_ensemble_launch
    fn.argtypes = argtypes(event=event)
    fn.restype = ctypes.c_int
    return fn


def source_of(name: str) -> str:
    """The source that compiles tableau `name` into K1."""
    return SOURCE if name in ("tsit5", "dopri5") else TABLEAUS_SOURCE


def same_coefficients(tab: Tableau, ref: Tableau) -> bool:
    """Whether the kernel runs `tab` as `ref`: the same a, b, btilde, c,
    FSAL and embedded order (the step controller's)."""
    return (tab.fsal == ref.fsal and tab.embedded_order == ref.embedded_order
            and all(np.array_equal(getattr(tab, k), getattr(ref, k))
                    for k in ("a", "b", "btilde", "c")))


def _compiled(tab: Tableau) -> bool:
    """Whether `tab` is one of the compiled tableaus: a name of
    TABLEAU_IDS with that tableau's coefficients and free interpolant (a
    user tableau named alike is not)."""
    ref = TABLEAUS.get(tab.name)
    if ref is tab:
        return tab.name in TABLEAU_IDS
    return (tab.name in TABLEAU_IDS and ref is not None
            and tab.interp_bpoly is ref.interp_bpoly
            and same_coefficients(tab, ref))


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
    int32 with rows (naccept, nreject, status, nf, njac, nfact).  On the
    card the save grid must ascend: checking it reads the card."""
    return _erk_ensemble(f, tab, u0, p, saveat, t0=t0, tf=tf, dt0=dt0,
                         rtol=rtol, atol=atol, adaptive=adaptive,
                         max_iters=max_iters, event=event, data=data)


def _tableau_key(tab: Tableau):
    return (tab.name, tab.fsal, tab.order, tab.embedded_order,
            tab.interp_bpoly,
            *(np.asarray(getattr(tab, k), np.float64).tobytes()
              for k in ("a", "b", "btilde", "c")))


_UNITS: dict = {}


def generated_unit(f, tab: Tableau, n: int, m: int, dtype, *, event=None,
                   data=None, hand=None):
    """The generated unit of K1 and K2 for `f` on `tab` in `dtype`, with
    the `Event` `event` and the dataset `data`: f traced (with the
    dataset's lookups), or, where `hand` names a registered functor, its
    hand-written struct."""
    from repro_torch.translate.units import erk_unit
    traced = None if hand is not None else trace(f, n, m, outputs=(n,),
                                                 data=data)
    form = event_form(event, n, m)
    key = (hand if hand is not None else traced, _tableau_key(tab), dtype,
           form, data is not None)
    if key not in _UNITS:
        _UNITS[key] = erk_unit(
            traced, tab, dtype, event=form, data=data is not None,
            hand_functor=None if hand is None
            else f"repro_erk::{RHS_FUNCTORS[hand].struct}")
    return _UNITS[key]


class Route(NamedTuple):
    """Where a launch goes: a source of csrc/ or a generated unit
    (`target`), with the RHS id, n and m its entry takes."""
    target: object
    rhs_id: int
    n: int
    m: int


def route(f, tab: Tableau, event=None, data=None, *, n: int, m: int,
          dtype=torch.float64) -> Route:
    """The hand-written source that compiles this form, else the generated
    unit: a registered RHS in the forms `erk_ensemble.cu` (tsit5, dopri5:
    no event, the `EVENT_PAIRS`, the data functors of `DATA_LAYOUTS` alone
    or with the `DATA_EVENT_PAIRS`) and `erk_tableaus.cu` (the other six
    tableaus, no event, no data) compile goes there; a registered functor
    in any other form, with a translated event or on a user tableau, runs
    its hand-written struct in a unit; any other RHS (and a registered one
    that reads no dataset, given one) is traced.  `n` and `m` are the
    state's and the parameters' sizes (a registered functor's are its
    own)."""
    name = getattr(f, "device_rhs", None)
    compiled = _compiled(tab)
    source = source_of(tab.name) if compiled else None
    if name is not None:
        rhs_id, n, m, _ = RHS_FUNCTORS[name]
    layout = DATA_LAYOUTS.get(name)
    if data is not None:
        if layout is not None and matches(data, layout):
            if source == SOURCE and (event is None or compiled_in(
                    event, name, DATA_EVENT_PAIRS)):
                return Route(SOURCE, rhs_id, n, m)
            return Route(generated_unit(f, tab, n, m, dtype, event=event,
                                        data=data, hand=name), -1, n, m)
        return Route(generated_unit(f, tab, n, m, dtype, event=event,
                                    data=data), -1, n, m)
    if layout is not None:
        raise ValueError(f"the device functor {name!r} reads a dataset; "
                         "the problem has none (prob.data)")
    if name is None:
        return Route(generated_unit(f, tab, n, m, dtype, event=event), -1, n,
                     m)
    if source is not None and (event is None or (
            source == SOURCE and compiled_in(event, name, EVENT_PAIRS))):
        return Route(source, rhs_id, n, m)
    return Route(generated_unit(f, tab, n, m, dtype, event=event,
                                hand=name), -1, n, m)


def _form(f, tab: Tableau, u0, p, saveat, event, data):
    """The checks of a launch on the card, and what its C entry takes:
    (source or generated unit, RHS id, n, the event's arguments, the
    tables' arguments)."""
    if u0.device.type != "cuda":
        raise ValueError(f"erk_ensemble runs on CPU or CUDA tensors, not "
                         f"{u0.device.type}")
    dtype = u0.dtype
    if dtype not in DTYPE_IDS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {dtype}")
    source, rhs_id, n, m = route(f, tab, event, data, n=u0.shape[0],
                                 m=p.shape[0], dtype=dtype)
    what = getattr(f, "device_rhs", None) or getattr(f, "__name__", "the RHS")
    tables, ev = (), ()
    if event is not None:
        ev = event_launch_args(event)
    if data is not None:
        tables = data_launch_args(data, None, what, u0)
        ev = ev or (0, 0, 0, 0)
    N = u0.shape[-1]
    S = saveat.shape[0]
    for x_name, x, shape in (("u0", u0, (n, N)), ("p", p, (m, N)),
                             ("saveat", saveat, (S,))):
        if x.device != u0.device or x.dtype != dtype:
            raise ValueError(f"{x_name} must be a {dtype} tensor on "
                             f"{u0.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{x_name} must be contiguous with shape {shape} "
                             f"for {what}, got {tuple(x.shape)}")
    if S < 1 or N < 1 or N >= 2 ** 31:
        raise ValueError(f"need 1 <= N < 2^31 lanes and S >= 1 saves, got "
                         f"N={N}, S={S}")
    return source, rhs_id, n, ev, tables


def _erk_ensemble(f, tab: Tableau, u0, p, saveat, *, t0, tf, dt0, rtol,
                  atol, adaptive, max_iters, event=None, data=None,
                  grid_checked=False):
    """`erk_ensemble`, without the ascending check where the caller has
    made it on the host (`grid_checked`), so that a launch reads nothing
    back from the card."""
    if u0.device.type == "cpu":
        return _plain(bind_data(f, data), tab, u0, p, saveat, t0, tf, dt0,
                      rtol, atol, adaptive, max_iters, event)
    source, rhs_id, n, ev, tables = _form(f, tab, u0, p, saveat, event, data)
    S, N = saveat.shape[0], u0.shape[-1]
    if not grid_checked and S > 1 and not bool(
            (saveat[1:] >= saveat[:-1]).all()):
        raise ValueError("the CUDA kernel needs an ascending saveat grid")
    dtype, dev = u0.dtype, u0.device
    us = torch.empty((S, n, N), dtype=dtype, device=dev)
    u_final = torch.empty((n, N), dtype=dtype, device=dev)
    t_final = torch.empty((N,), dtype=dtype, device=dev)
    stats = torch.empty((6, N), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        entry = (_bind_data(source) if data is not None
                 else _bind(event is not None, source))
        rc = entry(
            DTYPE_IDS[dtype], TABLEAU_IDS.get(tab.name, -1), rhs_id, *ev,
            *tables,
            u0.data_ptr(), p.data_ptr(), saveat.data_ptr(), S, N, float(t0),
            float(tf), float(dt0), float(rtol), float(atol),
            int(bool(adaptive)), int(max_iters), us.data_ptr(),
            u_final.data_ptr(), t_final.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"erk_ensemble launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return us, u_final, t_final, stats


@functools.lru_cache(maxsize=None)
def _bind_staged(source, data: bool):
    """The staged entry of `source` or of a generated unit (K2's k
    launches in one call)."""
    lib = _library(source)
    if source == TABLEAUS_SOURCE:
        fn = lib.erk_tableaus_staged_launch
    else:
        fn = (lib.erk_ensemble_data_staged_launch if data
              else lib.erk_ensemble_staged_launch)
    fn.argtypes = argtypes(data=data, staged=True)
    fn.restype = ctypes.c_int
    return fn


def erk_ensemble_staged(f, tab: Tableau, u0, p, saveat, segments, *, dt0,
                        rtol, atol, adaptive, max_iters, data=None):
    """K2's launches of K1: the segments ``(t0s, tfs, starts)`` of the save
    grid, one launch each (``starts`` has k + 1 entries, the last S):
    segment i integrates from t0s[i] to tfs[i] and saves on
    saveat[starts[i]:starts[i + 1]] into its slice of us, the first from
    u0, each from its predecessor's final state.  On the card the k
    launches go in one call, so the host pays for one; the caller has
    checked the grid to ascend, on the host.  On CPU tensors the plain
    version runs segment by segment.  Returns us (S, n, N), u_final
    (n, N) and t_final (N,) of the last segment, and stats (k, 6, N), a
    block a segment."""
    t0s, tfs, starts = segments
    k = len(t0s)
    N = u0.shape[-1]
    if u0.device.type == "cpu":
        us = torch.empty((starts[-1],) + tuple(u0.shape), dtype=u0.dtype)
        block = torch.empty((k, 6, N), dtype=torch.int32)
        fb = bind_data(f, data)
        for i in range(k):
            us[starts[i]:starts[i + 1]], u0, t_final, block[i] = _plain(
                fb, tab, u0, p, saveat[starts[i]:starts[i + 1]], t0s[i],
                tfs[i], dt0, rtol, atol, adaptive, max_iters)
        return us, u0, t_final, block
    source, rhs_id, n, _, tables = _form(f, tab, u0, p, saveat, None, data)
    dtype, dev = u0.dtype, u0.device
    us = torch.empty((starts[-1], n, N), dtype=dtype, device=dev)
    mids = torch.empty((2, n, N), dtype=dtype, device=dev)
    u_final = torch.empty((n, N), dtype=dtype, device=dev)
    t_final = torch.empty((N,), dtype=dtype, device=dev)
    block = torch.empty((k, 6, N), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _bind_staged(source, data is not None)(
            DTYPE_IDS[dtype], TABLEAU_IDS.get(tab.name, -1), rhs_id, n, k,
            (ctypes.c_double * k)(*t0s), (ctypes.c_double * k)(*tfs),
            (ctypes.c_int * (k + 1))(*starts), *tables, u0.data_ptr(),
            p.data_ptr(), saveat.data_ptr(), N, float(dt0), float(rtol),
            float(atol), int(bool(adaptive)), int(max_iters), us.data_ptr(),
            mids[0].data_ptr(), mids[1].data_ptr(), u_final.data_ptr(),
            t_final.data_ptr(), block.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"erk_ensemble launch failed: CUDA error {rc}")
    global launches
    launches += k
    return us, u_final, t_final, block
