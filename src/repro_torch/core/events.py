"""Family-agnostic event handling (paper §6.6) — the port of
`repro.core.events`, shared by every solver family.

Detection (a sign change of the condition over an accepted step),
location (bisection on a dense-output closure) and application (the affect
and per-lane termination) are written once, against an abstract
interpolant, and reused by

  * `repro_torch.core.solvers.solve_adaptive`       (ERK: tableau dense
    output),
  * `repro_torch.core.rosenbrock.solve_rosenbrock`  (the method's dense
    output),
  * `repro_torch.core.sde.sde_solve_adaptive` and the fixed-dt SDE loop
    body (piecewise-linear dense output).

Everything is shape-polymorphic over the control shape: 0-d control for a
per-trajectory solve, (B,) per-lane masks for the lanes engines.  The
condition g(u, p, t) returns one value per control element; a zero crossing
of g triggers the event.  The order of operations is the reference's
(``t_old + 1e-4 * dt_step``, ``theta = hi``, ``sign(g_old) * sign(g_mid)
<= 0``), so the engines that round every operation alone equal their CUDA
kernels bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class Event(NamedTuple):
    """condition g(u, p, t) crossing zero triggers affect h (paper §6.6).

    direction: -1 (+ -> -), +1 (- -> +), 0 (any crossing).
    terminal:  stop integration (the lane) at the event.
    affect:    (u, p, t) -> u_new  applied at the event point.
    bisect_iters: bisection refinement steps for the event time.
    """
    condition: Callable[[Any, Any, Any], Any]
    affect: Optional[Callable[[Any, Any, Any], Any]] = None
    terminal: bool = False
    direction: int = 0
    bisect_iters: int = 30


def event_crossing(ev: Event, g_old, g_new):
    """Directional sign-change mask for g over one step (per control
    element)."""
    sgn_change = torch.sign(g_old) * torch.sign(g_new) < 0
    if ev.direction == -1:
        sgn_change = sgn_change & (g_new < g_old)
    elif ev.direction == 1:
        sgn_change = sgn_change & (g_new > g_old)
    return sgn_change


def bisect_event(ev: Event, interp_fn: Callable, p, t_old, dt_step, g_old):
    """Bisection for g = 0 inside a step on a dense-output closure.

    interp_fn(theta) returns the interpolated state at t_old + theta *
    dt_step, theta shaped like g_old.  Returns (theta_star, u_star), meaningful
    only where the caller's `hit` mask is true."""
    lo = torch.zeros_like(g_old)
    hi = torch.ones_like(g_old)
    for _ in range(ev.bisect_iters):
        mid = 0.5 * (lo + hi)
        g_mid = ev.condition(interp_fn(mid), p, t_old + mid * dt_step)
        # the root lies in [lo, mid] iff g changes sign between g_old and
        # g_mid
        left = torch.sign(g_old) * torch.sign(g_mid) <= 0
        lo = torch.where(left, lo, mid)
        hi = torch.where(left, mid, hi)
    theta = hi  # first point past the root: g has crossed
    return theta, interp_fn(theta)


def handle_event(ev: Event, interp_fn: Callable, u_old, u_cand, p, t_old,
                 dt_step, t_new, accept, event_t, event_count, *,
                 lanes: bool = False):
    """Detect, locate and apply `ev` over one accepted step — all families.

    interp_fn(theta) -> state at t_old + theta * dt_step; accept is the
    step's acceptance mask; event_t/event_count are the running logs.
    Returns (u_next, t_next, event_t, event_count, term), `term` true only
    for terminal hits (the caller ORs it into its `done` mask).

    In lanes mode the bisection runs only on iterations where some lane
    hits, and the re-anchoring only where some g_old is 0: the values they
    would give elsewhere are discarded, so the outputs are the same.  (A
    per-trajectory body run under `torch.func.vmap` passes lanes=False and
    takes every branch.)"""
    g_old = ev.condition(u_old, p, t_old)
    g_new = ev.condition(u_cand, p, t_new)
    # an affect applied exactly at a root leaves g_old == 0 and would mask
    # every later crossing; re-anchor the sign just inside the step
    # (theta = 1e-4) in that case
    zero = g_old == 0
    if not lanes or bool(zero.any()):
        theta_eps = torch.full_like(g_old, 1e-4)
        g_eps = ev.condition(interp_fn(theta_eps), p,
                             t_old + 1e-4 * dt_step)
        g_old = torch.where(zero, g_eps, g_old)
    hit = event_crossing(ev, g_old, g_new) & accept
    term = hit if ev.terminal else torch.zeros_like(hit)
    if lanes and not bool(hit.any()):
        return u_cand, t_new, event_t, event_count, term
    theta_star, u_star = bisect_event(ev, interp_fn, p, t_old, dt_step,
                                      g_old)
    t_star = t_old + theta_star * dt_step
    u_aff = ev.affect(u_star, p, t_star) if ev.affect is not None else u_star
    hit_e = hit[None] if lanes else hit
    u_next = torch.where(hit_e, u_aff, u_cand)
    t_next = torch.where(hit, t_star, t_new)
    ev_t = torch.where(hit, t_star, event_t)
    ev_n = event_count + hit.to(torch.int32)
    return u_next, t_next, ev_t, ev_n, term


def without_log(result, event):
    """An engine's result without the event log it returns beside it when
    an event is given (the ensemble strategies drop the log, as the
    reference's do)."""
    return result[0] if event is not None else result


# ---------------------------------------------------------------------------
# dense-output closures for families without a tableau interpolant
# ---------------------------------------------------------------------------

def hermite_interp(u_old, f_old, u_new, f_new, dt, theta, lanes: bool = False):
    """Cubic Hermite dense output on one step — u(t_old + theta*dt).

    theta and dt are control-shaped: 0-d, or (B,) against u (n, B) in lanes
    mode; with lanes=False they arrive already broadcast against u."""
    if lanes:
        th = theta[None]
        dtb = dt[None]
    else:
        th = theta
        dtb = dt
    h00 = (1 + 2 * th) * (1 - th) ** 2
    h10 = th * (1 - th) ** 2
    h01 = th ** 2 * (3 - 2 * th)
    h11 = th ** 2 * (th - 1)
    return (h00 * u_old + h10 * dtb * f_old + h01 * u_new + h11 * dtb * f_new)


def linear_interp(u_old, u_new, theta, lanes: bool = False):
    """Piecewise-linear dense output — the SDE path output (linear
    interpolation is strong-order-1/2 consistent; a higher-order interpolant
    would claim accuracy the Brownian path does not have)."""
    th = theta[None] if lanes else theta
    return u_old + th * (u_new - u_old)
