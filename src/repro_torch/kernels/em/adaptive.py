"""ctypes binding of the adaptive SDE ensemble kernel
(`csrc/sde_adaptive_ensemble.cu`), which replaces the TPU kernel
`repro.kernels.ensemble_kernel.run_ensemble_kernel` + `sde_adaptive_body`
with its virtual-Brownian-tree noise (`repro.kernels.rng.bridge_normals`,
`brownian_bridge_point`).

`sde_adaptive_ensemble` is the wrapper: for CUDA tensors it checks its
inputs, allocates the outputs and launches the kernel on the current stream
(or raises); for CPU tensors, and only for them, it runs the plain PyTorch
version of the same function, the lanes loop
`repro_torch.kernels.em.ref.solve_adaptive_lanes`.

The drift and diffusion reach the kernel through the device functor both
are registered with (`repro_torch.kernels.em.kernel.device_sde`), whose
hand-written ``gdg``, (∂g/∂u)·g, the em pair needs and whose ``ddb``,
∂((∂g)·g)·g, the milstein pair needs as well.  The source compiles those
functors without an event, their event forms for `em.kernel.EVENT_PAIRS`
and the data functor (`em.kernel.DATA_LAYOUTS`, a third C entry) without an
event.  Every other form goes through the automated translation
(`repro_torch.translate`, `units.sde_adaptive_unit`), in a generated unit
that instantiates the same kernel, its Brownian tree and its work queue
(`csrc/sde_adaptive_body.cuh`): any other pair is traced (with the
dataset's lookups), ``gdg`` derived as the plain version's
`torch.func.jvp` computes it and, for the milstein pair, ``ddb`` as the
derivative of ``gdg`` along g (the reference's nested JVP); an event whose
condition and affect are not registered together is traced; a registered
functor in a form the source lacks runs its hand-written struct in a unit.
`em.kernel.sde_route` decides between source and unit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.controller import PIController
from repro_torch.core.problem import bind_data
from repro_torch.kernels.em.kernel import (DTYPE_IDS, SDE_FUNCTORS,
                                           STEPPER_IDS, SDEFunctor,
                                           sde_route, traced_pair)
from repro_torch.kernels.em.ref import solve_adaptive_lanes
from repro_torch.kernels.events import event_form, event_launch_args
from repro_torch.kernels.interp import data_argtypes, data_launch_args
from repro_torch.kernels.rng import check_u32

SOURCE = "sde_adaptive_ensemble.cu"
ESTIMATOR_IDS = {"doubling": 0, "embedded": 1}
# the steppers whose embedded pair the kernel compiles in
PAIRS = ("em", "milstein")
MAX_DEPTH = 30

# launches of the kernel since the counter was last set to 0
launches = 0


def argtypes(event: bool = False, data: bool = False):
    """The ctypes argument types of the no-event entry, the event entry
    (the event id, terminal, direction and bisect_iters after the
    estimator id), the data entry (the tables there) or a generated unit's
    data-and-event entry (the event's four, then the tables)."""
    vp, i32, f64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                         ctypes.c_uint)
    args = [i32, i32, i32, i32, vp, vp, vp, i32, i32, f64, f64, f64, f64,
            f64, ctypes.c_longlong, u32, u32, i32, i32, vp, vp, vp, vp, vp,
            vp, vp]
    extra = ([i32] * 4 if event else []) + (data_argtypes() if data else [])
    return args[:4] + extra + args[4:]


@functools.lru_cache(maxsize=None)
def _bind(event: bool = False, data: bool = False, unit=None):
    """The no-event, event, data or data-and-event entry of SOURCE's
    library (unit None) or of a generated unit's."""
    from repro_torch.kernels.build import load, load_generated
    lib = load(SOURCE) if unit is None else load_generated(unit)
    fn = getattr(lib, "sde_adaptive" + ("_data" if data else "")
                 + ("_event" if event else "") + "_launch")
    fn.argtypes = argtypes(event, data)
    fn.restype = ctypes.c_int
    return fn


def controller_constants(est_order: int, order: float):
    """The 8 doubles the kernel takes for its step control: the PI
    controller of the estimator's order (beta1, beta2, safety, qmin, qmax,
    dtmin, dtmax), then the Richardson factor 1/(2^order - 1) of step
    doubling."""
    ctrl = PIController.for_order(int(est_order))
    return (ctrl.beta1, ctrl.beta2, ctrl.safety, ctrl.qmin, ctrl.qmax,
            ctrl.dtmin, ctrl.dtmax, 1.0 / (2.0 ** order - 1.0))


_UNITS: dict = {}


def generated_unit(f, g, method: str, error_est: str, fun: SDEFunctor, dtype,
                   *, event=None, data=None, hand=None):
    """The generated unit of K5 for `method` with its embedded pair or step
    doubling in `dtype`, with the `Event` `event` and the dataset `data`:
    the pair (f, g) traced into one graph with gdg derived and, for the
    milstein pair, ddb; or, where `hand` names a registered functor, its
    hand-written struct."""
    from repro_torch.translate.units import SdeFunctor, sde_adaptive_unit
    form = event_form(event, fun.n, fun.k)
    if hand is not None:
        prob = SdeFunctor(hand=SDE_FUNCTORS[hand].struct)
    else:
        ddb = method == "milstein" and error_est == "embedded"
        tf, tg, gdg, tddb = traced_pair(f, g, fun, data, ddb)
        prob = SdeFunctor(tf, tg, fun.noise, gdg, tddb)
    key = (prob, method, error_est, dtype, form, data is not None)
    if key not in _UNITS:
        _UNITS[key] = sde_adaptive_unit(prob, method, error_est, dtype,
                                        event=form, data=data is not None)
    return _UNITS[key]


def _device_functor(f, g, method: str, noise: str, m_noise: int,
                    error_est: str, *, n: int = 0, k: int = 0,
                    dtype=torch.float64, event=None, data=None):
    """(the registered functor's name, or None where the pair runs in a
    generated unit; its SDEFunctor; the unit or None) for this pair,
    method and estimator, or an exception naming what the kernel cannot
    take (n, k: the state's and the parameters' sizes)."""
    if method not in STEPPER_IDS:
        raise NotImplementedError(
            f"stepper {method!r} is not compiled into the CUDA kernel; it "
            f"has {sorted(STEPPER_IDS)}")
    if error_est == "embedded":
        if method not in PAIRS:
            raise ValueError(f"{method} ships no embedded pair in {SOURCE}; "
                             f"pairs: {PAIRS}")
        if noise != "diagonal":
            raise ValueError("embedded SDE pairs are diagonal-noise only; "
                             "pass error_est='doubling' for general noise")
    unit, name, fun = sde_route(
        f, g, method, noise=noise, m_noise=m_noise, n=n, k=k, dtype=dtype,
        event=event, data=data, make_unit=lambda f_, g_, fun_, hand: generated_unit(
            f_, g_, method, error_est, fun_, dtype, event=event, data=data,
            hand=hand))
    if unit is None and (method == "milstein" or error_est == "embedded"):
        if not fun.gdg:
            raise NotImplementedError(
                f"{method} on the CUDA kernel needs the functor's "
                f"hand-written gdg member, (dg/du)·g; {name!r} has none")
        if method == "milstein" and error_est == "embedded" and not fun.ddb:
            raise NotImplementedError(
                f"the milstein pair on the CUDA kernel needs the functor's "
                f"hand-written ddb member; {name!r} has none")
    return (None if unit is not None else name), fun, unit


def sde_adaptive_ensemble(f, g, method: str, u0, p, saveat, *, noise: str,
                          m_noise: int, t0: float, tf: float, dt0: float,
                          rtol: float, atol: float, max_iters: int,
                          seed: int, depth: int, order: float,
                          error_est: str, est_order: int,
                          nf_per_attempt: int, lane_offset: int = 0,
                          event=None, data=None):
    """Integrate every lane of u0 (n, N) with parameters p (k, N) from t0
    to tf by `method` with adaptive steps, the error estimated by its
    embedded pair (``error_est="embedded"``) or by step doubling, on the
    virtual Brownian tree of depth `depth` keyed by (seed; lane_offset +
    lane, row), with an optional `Event` (a terminal hit ends the lane at
    the event time; a non-terminal one re-anchors it on the dyadic grid).
    With a dataset `data`, f and g take it as a fourth argument.  Returns
    us (S, n, N) on the `saveat` grid, u_final (n, N), t_final (N,) and
    stats (6, N) int32 with rows (naccept, nreject, status, nf, 0, 0)."""
    seed = check_u32("seed", seed)
    lane_offset = check_u32("lane_offset", lane_offset)
    if error_est not in ESTIMATOR_IDS:
        raise ValueError(f"unknown error_est {error_est!r} "
                         "(use 'embedded' or 'doubling')")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"need 0 <= depth <= {MAX_DEPTH}, got {depth}")
    if max_iters < 0 or max_iters * nf_per_attempt >= 2 ** 31:
        raise ValueError(f"need 0 <= max_iters with max_iters * "
                         f"nf_per_attempt < 2^31 (the int32 nf count), got "
                         f"{max_iters} * {nf_per_attempt}")
    kw = dict(noise=noise, m_noise=m_noise, t0=t0, tf=tf, dt0=dt0, rtol=rtol,
              atol=atol, max_iters=max_iters, seed=seed, depth=depth,
              order=order, error_est=error_est, est_order=est_order,
              nf_per_attempt=nf_per_attempt, lane_offset=lane_offset,
              event=event)
    if u0.device.type == "cpu":
        return solve_adaptive_lanes(bind_data(f, data), bind_data(g, data),
                                    method, u0, p, saveat, **kw)
    if u0.device.type != "cuda":
        raise ValueError(f"sde_adaptive_ensemble runs on CPU or CUDA "
                         f"tensors, not {u0.device.type}")
    name, fun, unit = _device_functor(
        f, g, method, noise, m_noise, error_est, n=u0.shape[0],
        k=p.shape[0], dtype=u0.dtype, event=event, data=data)
    name = name or "/".join(getattr(fn, "__name__", "the pair")
                            for fn in (f, g))
    tables = (None if data is None
              else data_launch_args(data, None, name, u0))
    ev = () if event is None else event_launch_args(event)
    dtype = u0.dtype
    if dtype not in DTYPE_IDS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, not "
                        f"{dtype}")
    N = u0.shape[-1]
    S = saveat.shape[0] if saveat.dim() == 1 else 0
    if N < 1 or N >= 2 ** 31 or S < 1:
        raise ValueError(f"need 1 <= N < 2^31 lanes and a (S,) saveat grid "
                         f"with S >= 1, got N={N}, saveat "
                         f"{tuple(saveat.shape)}")
    for what, x, shape in (("u0", u0, (fun.n, N)), ("p", p, (fun.k, N)),
                           ("saveat", saveat, (S,))):
        if x.device != u0.device or x.dtype != dtype:
            raise ValueError(f"{what} must be a {dtype} tensor on {u0.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous with shape {shape} "
                             f"for {name}, got {tuple(x.shape)}")
    if S > 1 and not bool((saveat[1:] >= saveat[:-1]).all()):
        raise ValueError("the CUDA kernel needs an ascending saveat grid")

    consts = (ctypes.c_double * 8)(*controller_constants(est_order, order))
    us = torch.empty((S, fun.n, N), dtype=dtype, device=u0.device)
    u_final = torch.empty((fun.n, N), dtype=dtype, device=u0.device)
    t_final = torch.empty((N,), dtype=dtype, device=u0.device)
    stats = torch.empty((6, N), dtype=torch.int32, device=u0.device)
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    with torch.cuda.device(u0.device):
        # the work queue's counter (csrc/trajectory_queue.cuh), zeroed on
        # the launch's stream
        queue = torch.zeros(1, dtype=torch.int32, device=u0.device)
        rc = _bind(event is not None, tables is not None, unit)(
            DTYPE_IDS[dtype], fun.id, STEPPER_IDS[method],
            ESTIMATOR_IDS[error_est], *ev, *(tables or ()), u0.data_ptr(),
            p.data_ptr(),
            saveat.data_ptr(), S, N, float(t0), float(tf), float(dt0),
            float(rtol), float(atol), int(max_iters), seed, lane_offset,
            int(depth), int(nf_per_attempt), ctypes.addressof(consts),
            us.data_ptr(), u_final.data_ptr(), t_final.data_ptr(),
            stats.data_ptr(), queue.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sde_adaptive_ensemble launch failed: CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return us, u_final, t_final, stats
