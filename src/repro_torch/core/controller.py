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
    if dim is None:
        total, count = torch.sum(r * r), r.numel()
    else:
        # the state axis summed left to right, as a kernel thread sums it
        total = sum_left_to_right(r * r, dim)
        count = r.shape[dim]
    # the mean divides the sum by the count, as jnp.mean does: torch.mean,
    # and a division by a Python number on CUDA, multiply by the rounded
    # reciprocal instead
    return torch.sqrt(total / torch.full_like(total, count))


def sum_left_to_right(x, dim):
    """Σ along `dim` in index order, ((x0 + x1) + x2) + ..., whatever
    order the library's reduction would take."""
    parts = x.unbind(dim)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


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


class WReusePolicy(NamedTuple):
    """Freshness controller for lazy-W stiff stepping (sibling of
    PIController), as `repro.core.controller.WReusePolicy`.

    Per step attempt and per lane it decides two freshness levels:
    re-evaluate J (``need_jac``) after a rejection taken with a reused J,
    when an accepted error norm grew past ``enorm_limit`` or by more than
    ``growth`` against the previous accepted one, or after ``max_age``
    accepted steps on the same J; and re-factor W = I − γh·J from the
    cached J (``need_fact``) whenever J refreshes or the step drifted from
    the dt of the factorization by more than the γ-scaled threshold
    γ·|dt − dt_fact| > dt_rtol·dt_fact.  Between refreshes an extrapolated
    secant (Broyden) update, J ← J + secant·(Δf − J·Δu)·Δuᵀ/(Δuᵀ·Δu), keeps
    the cached J close to the state (``secant = 0`` freezes it).
    """

    dt_rtol: float = 0.005    # γ-scaled dt-drift refactor threshold
    growth: float = 4.0       # accepted-enorm growth ratio forcing a J refresh
    enorm_limit: float = 0.9  # predictive refresh: accepted enorm above this
    max_age: int = 20         # accepted steps per Jacobian, hard cap
    secant: float = 2.0       # extrapolated-secant gain (0 = disable)


def w_refresh(policy: WReusePolicy, gamma, dt, dt_fact, jac_stale):
    """Pre-step freshness decision. Returns (need_jac, need_fact)."""
    drift = gamma * (dt - dt_fact).abs() > policy.dt_rtol * dt_fact
    return jac_stale, jac_stale | drift


def w_mark_stale(policy: WReusePolicy, accept, enorm, enorm_prev, age, fresh):
    """Post-step staleness signal for the NEXT attempt's `need_jac`:
    `enorm_prev` is the previous accepted error norm (before this attempt's
    update), `age` the accepted-step age of J after this attempt and
    `fresh` whether J was re-evaluated for this attempt."""
    rej_stale = ~accept & ~fresh
    grew = accept & ((enorm > policy.growth * enorm_prev)
                     | (enorm > policy.enorm_limit))
    return rej_stale | grew | (age >= policy.max_age)


def w_dt_blame(accept, fresh, dt, dt_proposed):
    """Rejection triage with secant updates off: a step rejected on a
    reused J retries at the same dt with a fresh J; fresh-J rejections keep
    the PI controller's shrink."""
    return torch.where(~accept & ~fresh, dt, dt_proposed)


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
