"""Generic explicit Runge-Kutta engine (tableau-driven), three execution
shapes — the PyTorch counterpart of `repro.core.solvers`.

  * scalar mode — ``u: (n,)``, 0-d ``t/dt``: the per-trajectory reference
                  solver (`solve_one`).
  * array mode  — ``u: (n, N)``, 0-d ``t/dt`` and an ensemble-wide error
                  norm: EnsembleGPUArray semantics (§5.1), one lock-step dt.
  * lanes mode  — ``u: (n, B)``, per-lane ``t/dt/accept`` masks: the
                  structure of the paper's EnsembleGPUKernel (§5.2).  This
                  loop is the plain PyTorch version of the fused CUDA kernel
                  (`csrc/erk_ensemble.cu`): the kernel wrapper runs it for
                  CPU tensors, and the chip smoke test holds the kernel
                  against it on the card.

The reference's ``lax.while_loop`` is a Python loop here; its loop body
(`_make_adaptive_body`) keeps the reference's expressions and their order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from .controller import (STATUS_DTMIN_EXHAUSTED, PIController, hairer_norm,
                         pi_propose)
from .tableaus import Tableau

Tensor = torch.Tensor


class SolveResult(NamedTuple):
    ts: Tensor        # (S,) save times (the common saveat grid)
    us: Tensor        # scalar/array mode: (S, n)/(S, n, N); lanes: (S, n, B)
    t_final: Tensor
    u_final: Tensor
    naccept: Tensor
    nreject: Tensor
    status: Tensor    # 0 success, 1 max_iters exhausted, 2 dtmin exhausted
    nf: Tensor        # RHS evaluations (per control element)
    njac: Any = 0     # Jacobian evaluations (stiff family; 0 elsewhere)
    nfact: Any = 0    # W = I − γh·J factorizations (stiff family)


def _bc(v, u):
    """Broadcast a control value (a float, 0-d or (B,)) against state u."""
    return v[None] if torch.is_tensor(v) and v.dim() == 1 else v


def rk_step(f, tab: Tableau, u, p, t, dt, k1):
    """One embedded step. Returns (u_new, err, ks).

    k1 must be f(u, p, t) (caller owns FSAL reuse).  Zero coefficients are
    skipped and sums run left to right, as in the reference; tableau entries
    enter as Python floats, so they are rounded to the state dtype.
    """
    s = tab.stages
    dtb = _bc(dt, u)
    ks = [k1]
    for i in range(1, s):
        acc = None
        for j in range(i):
            aij = float(tab.a[i, j])
            if aij == 0.0:
                continue
            term = aij * ks[j]
            acc = term if acc is None else acc + term
        ui = u if acc is None else u + dtb * acc
        ks.append(f(ui, p, t + float(tab.c[i]) * dt))
    unew_acc = None
    err_acc = None
    for i in range(s):
        if tab.b[i] != 0.0:
            term = float(tab.b[i]) * ks[i]
            unew_acc = term if unew_acc is None else unew_acc + term
        if tab.btilde[i] != 0.0:
            term = float(tab.btilde[i]) * ks[i]
            err_acc = term if err_acc is None else err_acc + term
    u_new = u + dtb * unew_acc
    err = dtb * err_acc if err_acc is not None else torch.zeros_like(u)
    return u_new, err, ks


def interp_step(f, tab: Tableau, u_old, u_new, ks, p, t, dt, theta,
                lanes: bool = False):
    """Dense output u(t + theta*dt), theta in [0,1].

    Uses the tableau's free interpolant when available (Tsit5: 4th order),
    otherwise cubic Hermite on (u_old, k1, u_new, f(u_new)).

      lanes=False: u (n,)/(n,N), dt 0-d, theta 0-d or (S,)
                   -> u-shaped or (S, *ushape).
      lanes=True : u (n,B), dt (B,), theta (B,) or (S,B) — the LAST theta
                   axis is the lane axis -> (n,B) or (S,n,B).
    """
    th_nd = theta.dim()
    u_nd = u_old.dim()

    def expand_w(w):
        if th_nd == 0:
            return w
        if lanes:
            return w.unsqueeze(-2)          # (..., B) -> (..., 1, B)
        return w.reshape(tuple(w.shape) + (1,) * u_nd)

    def expand_u(x):
        lead = th_nd - (1 if lanes else 0)
        if lead <= 0:
            return x
        return x.reshape((1,) * lead + tuple(x.shape))

    dtb = _bc(dt, u_old)

    if tab.interp_bpoly is not None:
        bw = tab.interp_bpoly(theta)          # (s, *theta.shape)
        incr = None
        for i, k in enumerate(ks):
            term = expand_w(bw[i]) * expand_u(k)
            incr = term if incr is None else incr + term
        return expand_u(u_old) + dtb * incr
    # Hermite cubic
    f_old = ks[0]
    f_new = ks[-1] if tab.fsal else f(u_new, p, t + dt)
    the = theta
    h00 = expand_w((1 + 2 * the) * (1 - the) ** 2)
    h10 = expand_w(the * (1 - the) ** 2)
    h01 = expand_w(the ** 2 * (3 - 2 * the))
    h11 = expand_w(the ** 2 * (the - 1))
    return (h00 * expand_u(u_old) + h10 * dtb * expand_u(f_old)
            + h01 * expand_u(u_new) + h11 * dtb * expand_u(f_new))


def solve_fixed(f, tab: Tableau, u0, p, t0, dt, n_steps: int,
                save_every: int = 1):
    """Fixed-dt integration; saves every `save_every`-th step, so
    S = n_steps // save_every snapshots.  Any state shape."""
    if n_steps % save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")
    S = n_steps // save_every
    dtype, device = u0.dtype, u0.device
    dt = torch.as_tensor(dt, dtype=dtype, device=device)
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    u, t = u0, t0
    us = []
    for _ in range(S):
        for _ in range(save_every):
            k1 = f(u, p, t)
            u, _, _ = rk_step(f, tab, u, p, t, dt, k1)
            t = t + dt
        us.append(u)
    ts = t0 + dt * save_every * torch.arange(1, S + 1, dtype=dtype,
                                             device=device)
    fsal = 1 if tab.fsal else 0
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return SolveResult(ts=ts, us=torch.stack(us), t_final=t, u_final=u,
                       naccept=i32(n_steps), nreject=i32(0), status=i32(0),
                       nf=i32(n_steps * (tab.stages - fsal) + fsal))


@dataclasses.dataclass(frozen=True)
class AdaptiveOptions:
    rtol: float = 1e-6
    atol: float = 1e-6
    max_iters: int = 100_000
    adaptive: bool = True            # False => accept every step at fixed dt


def _grid_save(f, tab, us, saveat, u_old, u_new, ks, p, t_old, dt_step,
               t_new, active):
    """Masked write of every save point crossed by this step (vectorized
    over S): crossed when saveat > t_old and saveat <= t_new + eps."""
    lanes = t_old.dim() == 1
    eps = torch.tensor(1e-7, dtype=us.dtype, device=us.device) \
        * torch.clamp(t_new.abs(), min=1.0)
    if lanes:
        cross = ((saveat[:, None] > t_old[None, :])
                 & (saveat[:, None] <= t_new[None, :] + eps[None, :])
                 & active[None, :])                       # (S, B)
        step = torch.where(dt_step == 0, torch.ones_like(dt_step), dt_step)
        theta = torch.clamp((saveat[:, None] - t_old[None, :]) / step[None, :],
                            0.0, 1.0)                     # (S, B)
        vals = interp_step(f, tab, u_old, u_new, ks, p, t_old, dt_step, theta,
                           lanes=True)
        return torch.where(cross[:, None, :], vals, us)
    cross = (saveat > t_old) & (saveat <= t_new + eps) & active   # (S,)
    step = torch.where(dt_step == 0, torch.ones_like(dt_step), dt_step)
    theta = torch.clamp((saveat - t_old) / step, 0.0, 1.0)
    vals = interp_step(f, tab, u_old, u_new, ks, p, t_old, dt_step, theta)
    cross_e = cross.reshape(tuple(cross.shape) + (1,) * (us.dim() - 1))
    return torch.where(cross_e, vals, us)


def _make_adaptive_body(f, tab: Tableau, opts: AdaptiveOptions, ctrl,
                        lanes: bool, saveat, p, tf):
    """The adaptive loop body over a dict carry — the reference's
    `_make_adaptive_body` without events and without the bounded adjoint
    loop (later slices).  Finished lanes step at dt = 0 and every write is
    accept- or active-masked, so they are exact no-ops."""

    def body(c):
        t, u, dt, k1 = c["t"], c["u"], c["dt"], c["k1"]
        active = ~c["done"]
        dt_step = torch.minimum(dt, tf - t)
        dt_step = torch.where(active, dt_step, torch.zeros_like(dt_step))

        u_cand, err, ks = rk_step(f, tab, u, p, t, dt_step, k1)

        if opts.adaptive:
            enorm = hairer_norm(err, u, u_cand, opts.atol, opts.rtol,
                                dim=0 if lanes else None)
            finite = torch.isfinite(u_cand)
            finite = finite.all(dim=0) if lanes else finite.all()
            accept = (enorm <= 1.0) & finite
            dt_next, enorm_prev = pi_propose(ctrl, dt, enorm, c["enorm_prev"],
                                             accept)
        else:
            accept = torch.ones_like(active)
            dt_next, enorm_prev = dt, c["enorm_prev"]

        accept = accept & active
        t_new = torch.where(accept, t + dt_step, t)

        acc_e = _bc(accept, u) if lanes else accept
        u_new = torch.where(acc_e, u_cand, u)
        # FSAL: reuse the last stage
        if tab.fsal:
            k1_new = torch.where(acc_e, ks[-1], k1)
            nf_inc = active.to(torch.int32) * (tab.stages - 1)
        else:
            k1_new = torch.where(acc_e, f(u_new, p, t_new), k1)
            nf_inc = active.to(torch.int32) * tab.stages

        us = c["us"]
        # the reference's lax.cond gate: skip the O(S) interpolation on
        # steps that cross no save point
        if bool((accept & (saveat.max() > t.min())).any()):
            us = _grid_save(f, tab, us, saveat, u, u_cand, ks, p, t,
                            dt_step, t_new, accept)

        # dt pinned at the controller floor and still rejecting: terminate
        # the lane with a distinct status instead of spinning to max_iters
        if opts.adaptive:
            hopeless = active & ~accept & ~(dt_step > ctrl.dtmin)
        else:
            hopeless = torch.zeros_like(active)
        statusv = torch.where(hopeless, STATUS_DTMIN_EXHAUSTED, c["status"])
        eps_end = 1e-7 * torch.clamp(tf.abs(), min=1.0)
        done = c["done"] | (t_new >= tf - eps_end) | hopeless

        return dict(
            t=t_new, u=u_new, dt=dt_next, k1=k1_new,
            enorm_prev=enorm_prev, done=done, us=us,
            naccept=c["naccept"] + accept.to(torch.int32),
            nreject=c["nreject"] + (active & ~accept).to(torch.int32),
            nf=c["nf"] + nf_inc, status=statusv.to(torch.int32),
            iters=c["iters"] + 1)

    return body


def solve_adaptive(f, tab: Tableau, u0, p, t0, tf, dt0,
                   saveat: Optional[Tensor] = None,
                   opts: AdaptiveOptions = AdaptiveOptions(),
                   lanes: bool = False):
    """Adaptive (or fixed-accept) integration.

    lanes=False, u0 (n,)   : per-trajectory (scalar control).
    lanes=False, u0 (n, N) : EnsembleGPUArray lock-step semantics (scalar
                             control, ensemble-wide norm).
    lanes=True,  u0 (n, B) : per-lane control — EnsembleGPUKernel structure.
    """
    dtype, device = u0.dtype, u0.device
    ctrl = PIController.for_order(tab.embedded_order)
    cshape = (u0.shape[-1],) if lanes else ()
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)

    t0 = as_t(t0)
    tf = as_t(tf)
    tv = t0.expand(cshape).clone()
    dtv = as_t(dt0).expand(cshape).clone()

    saveat = as_t([tf.item()] if saveat is None else saveat)
    S = saveat.shape[0]
    # prefill save points at/before t0 with u0
    pre = (saveat <= t0).reshape((S,) + (1,) * u0.dim())
    us0 = torch.where(pre, u0[None], torch.zeros((S,) + tuple(u0.shape),
                                                 dtype=dtype, device=device))

    i32 = lambda v: torch.full(cshape, v, dtype=torch.int32, device=device)
    c = dict(t=tv, u=u0, dt=dtv, k1=f(u0, p, tv),
             enorm_prev=torch.ones(cshape, dtype=dtype, device=device),
             done=torch.zeros(cshape, dtype=torch.bool, device=device),
             us=us0, naccept=i32(0), nreject=i32(0), nf=i32(1),
             status=i32(0), iters=0)

    body = _make_adaptive_body(f, tab, opts, ctrl, lanes, saveat, p, tf)
    while c["iters"] < opts.max_iters and not bool(c["done"].all()):
        c = body(c)
    status = torch.where(c["status"] > 0, c["status"],
                         torch.where(c["done"], 0, 1).to(torch.int32))
    return SolveResult(ts=saveat, us=c["us"], t_final=c["t"],
                       u_final=c["u"], naccept=c["naccept"],
                       nreject=c["nreject"], status=status.to(torch.int32),
                       nf=c["nf"])


def solve_one(f, tab: Tableau, u0, p, t0, tf, dt0, saveat=None,
              rtol=1e-6, atol=1e-6, adaptive=True, max_iters=100_000):
    """Public single-trajectory reference solver (scalar mode)."""
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive)
    return solve_adaptive(f, tab, u0, p, t0, tf, dt0, saveat=saveat,
                          opts=opts, lanes=False)
