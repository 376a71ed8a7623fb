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

The kernel cannot call a Python RHS or differentiate one.  An RHS reaches
it through the hand-written device functor it is registered with by
`device_stiff`, which gives f, its Jacobian ∂f/∂u and ∂f/∂t; a problem's
analytic Jacobian hook must carry the same registration.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.controller import PIController
from repro_torch.core.rosenbrock import (_policy, rosenbrock_nf_per_step,
                                         solve_rosenbrock)
from repro_torch.core.tableaus import RosenbrockTableau

SOURCE = "rosenbrock_ensemble.cu"
# device functor id and (n, m) for each registered RHS — as in the .cu
STIFF_FUNCTORS = {"rober": (0, 3, 3), "orego": (1, 3, 3), "vdp": (2, 2, 1)}
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


@functools.lru_cache(maxsize=None)
def _bind():
    from repro_torch.kernels.build import load
    fn = load(SOURCE).rosenbrock_ensemble_launch
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [i32, i32, i32, i32, vp, vp, vp, i32, i32, f64, f64, f64,
                   f64, f64, ctypes.c_longlong, i32, vp, vp, vp, vp, vp, vp]
    fn.restype = i32
    return fn


def _plain(f, rtab, u0, p, saveat, *, jac, t0, tf, dt0, rtol, atol,
           max_iters, w_reuse):
    res = solve_rosenbrock(f, rtab, u0, p, t0, tf, dt0, rtol=rtol, atol=atol,
                           saveat=saveat, max_iters=max_iters, lanes=True,
                           linsolve="lanes", jac=jac, w_reuse=w_reuse)
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
                        atol: float, max_iters: int, w_reuse=None):
    """Integrate every lane of u0 (n, N) with parameters p (m, N) from t0
    to tf by the s-stage W-method `rtab`, eager or lazy-W (`w_reuse`).
    Returns us (S, n, N), u_final (n, N), t_final (N,) and stats (6, N)
    int32 with rows (naccept, nreject, status, nf, njac, nfact)."""
    kw = dict(jac=jac, t0=t0, tf=tf, dt0=dt0, rtol=rtol, atol=atol,
              max_iters=max_iters, w_reuse=w_reuse)
    if u0.device.type == "cpu":
        return _plain(f, rtab, u0, p, saveat, **kw)
    if u0.device.type != "cuda":
        raise ValueError(f"rosenbrock_ensemble runs on CPU or CUDA tensors, "
                         f"not {u0.device.type}")
    name = getattr(f, "device_stiff", None)
    if name is None:
        raise NotImplementedError(
            f"RHS {getattr(f, '__name__', f)!r} has no device form: register "
            f"a functor with its Jacobian in {SOURCE} with @device_stiff "
            "(automatic translation of a Python RHS is a later ROADMAP item)")
    if jac is not None and getattr(jac, "device_stiff", None) != name:
        raise NotImplementedError(
            f"Jacobian {getattr(jac, '__name__', jac)!r} is not the device "
            f"functor {name!r}'s: the kernel runs only the registered one")
    if rtab.name not in TABLEAU_IDS or not _compiled_in(rtab):
        raise NotImplementedError(
            f"tableau {rtab.name!r} is not compiled into the CUDA kernel; it "
            f"has {sorted(TABLEAU_IDS)}")
    rhs_id, n, m = STIFF_FUNCTORS[name]
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

    consts = (ctypes.c_double * 12)(*controller_constants(rtab, w_reuse))
    us = torch.empty((S, n, N), dtype=dtype, device=u0.device)
    u_final = torch.empty((n, N), dtype=dtype, device=u0.device)
    t_final = torch.empty((N,), dtype=dtype, device=u0.device)
    stats = torch.empty((6, N), dtype=torch.int32, device=u0.device)
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    with torch.cuda.device(u0.device):
        rc = _bind()(DTYPE_IDS[dtype], TABLEAU_IDS[rtab.name], rhs_id,
                     int(_policy(w_reuse) is not None), u0.data_ptr(),
                     p.data_ptr(), saveat.data_ptr(), S, N, float(t0),
                     float(tf), float(dt0), float(rtol), float(atol),
                     int(max_iters), rosenbrock_nf_per_step(rtab),
                     ctypes.addressof(consts), us.data_ptr(),
                     u_final.data_ptr(), t_final.data_ptr(),
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
