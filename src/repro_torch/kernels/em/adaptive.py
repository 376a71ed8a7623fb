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
are registered with (`repro_torch.kernels.em.kernel.device_sde`).  The
kernel cannot take a JVP, so the em pair needs the functor's hand-written
``gdg``, (∂g/∂u)·g, and the milstein pair its ``ddb`` as well,
∂((∂g)·g)·g.  An event reaches it through its `device_event` functor
(`repro_torch.kernels.events`), for the pairs of `em.kernel.EVENT_PAIRS`.
A data-driven pair reaches it through a data functor
(`em.kernel.DATA_LAYOUTS`) and a third C entry, as in the fixed-dt kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.controller import PIController
from repro_torch.core.problem import bind_data
from repro_torch.kernels.em.kernel import (DIAGONAL_ONLY, DTYPE_IDS,
                                           EVENT_PAIRS, SDE_FUNCTORS,
                                           STEPPER_IDS, device_data_args)
from repro_torch.kernels.em.ref import solve_adaptive_lanes
from repro_torch.kernels.events import event_launch_args
from repro_torch.kernels.interp import data_argtypes
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
    estimator id) or the data entry (the tables there)."""
    vp, i32, f64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                         ctypes.c_uint)
    args = [i32, i32, i32, i32, vp, vp, vp, i32, i32, f64, f64, f64, f64,
            f64, ctypes.c_longlong, u32, u32, i32, i32, vp, vp, vp, vp, vp,
            vp, vp]
    extra = data_argtypes() if data else [i32] * 4 if event else []
    return args[:4] + extra + args[4:]


@functools.lru_cache(maxsize=None)
def _bind(event: bool = False, data: bool = False):
    """The no-event, event or data entry of the built library."""
    from repro_torch.kernels.build import load
    lib = load(SOURCE)
    fn = (lib.sde_adaptive_data_launch if data
          else lib.sde_adaptive_event_launch if event
          else lib.sde_adaptive_launch)
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


def _device_functor(f, g, method: str, noise: str, m_noise: int,
                    error_est: str):
    """The functor (name, SDEFunctor) the kernel instantiates for this
    pair and method, or an exception naming what is missing."""
    names = {getattr(f, "device_sde", None), getattr(g, "device_sde", None)}
    if len(names) != 1 or None in names:
        raise NotImplementedError(
            f"drift/diffusion pair ({getattr(f, '__name__', f)!r}, "
            f"{getattr(g, '__name__', g)!r}) has no device form: register "
            f"both with the same @device_sde functor (the adaptive SDE "
            "kernel's translation, with the milstein pair's ddb and the "
            "Brownian tree, is ROADMAP queue 1 item 17's next slice)")
    name = names.pop()
    fun = SDE_FUNCTORS[name]
    if method not in STEPPER_IDS:
        raise NotImplementedError(
            f"stepper {method!r} is not compiled into the CUDA kernel; it "
            f"has {sorted(STEPPER_IDS)}")
    if noise != fun.noise or m_noise != fun.m:
        raise ValueError(f"functor {name!r} has {fun.noise} noise with "
                         f"{fun.m} Wiener processes, not {noise} with "
                         f"{m_noise}")
    if method in DIAGONAL_ONLY and fun.noise != "diagonal":
        raise ValueError(f"{method} supports diagonal noise only")
    if error_est == "embedded":
        if method not in PAIRS:
            raise ValueError(f"{method} ships no embedded pair in {SOURCE}; "
                             f"pairs: {PAIRS}")
        if fun.noise != "diagonal":
            raise ValueError("embedded SDE pairs are diagonal-noise only; "
                             "pass error_est='doubling' for general noise")
    if method == "milstein" or error_est == "embedded":
        if not fun.gdg:
            raise NotImplementedError(
                f"{method} on the CUDA kernel needs the functor's "
                f"hand-written gdg member, (dg/du)·g; {name!r} has none")
        if method == "milstein" and error_est == "embedded" and not fun.ddb:
            raise NotImplementedError(
                f"the milstein pair on the CUDA kernel needs the functor's "
                f"hand-written ddb member; {name!r} has none")
    return name, fun


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
    name, fun = _device_functor(f, g, method, noise, m_noise, error_est)
    tables = device_data_args(name, data, event, u0, SOURCE)
    ev = (() if event is None
          else event_launch_args(event, name, EVENT_PAIRS, SOURCE))
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
        rc = _bind(event is not None, tables is not None)(
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
