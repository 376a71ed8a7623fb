"""Adaptive step-size control: Hairer scaled error norm + PI controller
(paper §3.1) — the PyTorch counterpart of `repro.core.controller`.

All functions are shape-polymorphic: 0-d control tensors for per-trajectory
and lock-step array solving, `(B,)` tensors for the per-lane lanes path.
Python-float constants enter the arithmetic as weak scalars, so they are
rounded to the state dtype before use, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Adaptive-loop status codes (SolveResult.status / EnsembleResult.status).
STATUS_SUCCESS = 0          # reached tf
STATUS_MAX_ITERS = 1        # iteration cap hit with lanes still running
STATUS_DTMIN_EXHAUSTED = 2  # dt pinned at the controller floor and the step
#                             still rejects: retrying the identical step is a
#                             deterministic live-lock, so the lane terminates


class PIController(NamedTuple):
    """Proportional-integral step controller (Hairer PI).

    dt_new = dt * clip(safety * err^(-beta1) * err_prev^(beta2), qmin, qmax)
    with beta1 = 7/(10k), beta2 = 2/(5k), k = embedded_order + 1.
    """

    beta1: float
    beta2: float
    safety: float = 0.9
    qmin: float = 0.2
    qmax: float = 10.0
    dtmin: float = 1e-12
    dtmax: float = math.inf

    @staticmethod
    def for_order(embedded_order: int, **kw) -> "PIController":
        k = float(embedded_order + 1)
        return PIController(beta1=0.7 / k, beta2=0.4 / k, **kw)


def hairer_norm(err, u_old, u_new, atol, rtol, dim=None):
    """RMS of componentwise error scaled by atol + rtol*max(|u_old|,|u_new|).

    dim=None reduces everything (per-trajectory and lock-step array
    semantics); dim=0 reduces the state axis of a lanes tile, one norm per
    lane.  err <= 1  <=>  accept.
    """
    scale = atol + torch.maximum(u_old.abs(), u_new.abs()) * rtol
    r = err / scale
    return torch.sqrt(torch.mean(r * r) if dim is None
                      else torch.mean(r * r, dim=dim))


def pi_propose(ctrl: PIController, dt, enorm, enorm_prev, accept):
    """One controller update. Returns (dt_next, enorm_prev_next).

    On accept: PI formula with history term.  On reject: pure P shrink
    (growth capped at 1).  A non-finite error norm counts as a huge error
    (maximum shrink), so a lane with a NaN candidate shrinks toward dtmin
    instead of poisoning dt.
    """
    e = torch.where(torch.isfinite(enorm), torch.clamp(enorm, min=1e-10),
                    torch.full_like(enorm, 1e10))
    ep = torch.clamp(enorm_prev, min=1e-10)
    fac_pi = ctrl.safety * e ** (-ctrl.beta1) * ep ** ctrl.beta2
    fac_acc = torch.clamp(fac_pi, ctrl.qmin, ctrl.qmax)
    fac_rej = torch.clamp(ctrl.safety * e ** (-ctrl.beta1), ctrl.qmin, 1.0)
    fac = torch.where(accept, fac_acc, fac_rej)
    dt_next = torch.clamp(dt * fac, ctrl.dtmin, ctrl.dtmax)
    enorm_prev_next = torch.where(accept, e, enorm_prev)
    return dt_next, enorm_prev_next


def initial_dt(f, u0, p, t0, tf, order, atol, rtol):
    """Hairer's automatic initial step size (Solving ODEs I, II.4), simplified.

    u0 (n,) gives one step; u0 (n, N) with p (m, N) gives one per column
    (the norms reduce the state axis only).  The result is clamped to
    [1e-12·span, span] and any non-finite intermediate collapses to the
    conservative 1e-6·span fallback, as in the reference.
    """
    span = tf - t0
    sc = atol + u0.abs() * rtol

    def rms(x):
        return torch.sqrt(torch.mean(x * x, dim=0))

    f0 = f(u0, p, t0)
    d0 = rms(u0 / sc)
    d1 = rms(f0 / sc)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                     torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    h0 = torch.clamp(h0, 1e-12 * span, span)
    u1 = u0 + h0 * f0
    f1 = f(u1, p, t0 + h0)
    d2 = rms((f1 - f0) / sc) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15,
                     torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dmax) ** (1.0 / order))
    dt = torch.minimum(100.0 * h0, torch.clamp(h1, max=span))
    dt = torch.where(torch.isfinite(dt) & (dt > 0), dt,
                     torch.full_like(dt, 1e-6 * span))
    return torch.clamp(dt, 1e-12 * span, span)
