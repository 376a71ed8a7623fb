"""Dense-output closures shared by the method families — the part of
`repro.core.events` that the stiff engine needs.

Only `hermite_interp` is ported here: the Rosenbrock dense output of a
tableau without interpolation weights.  Event detection and location
(`handle_event`, `bisect_event`) and `linear_interp` wait for ROADMAP
queue 1 item 7, which ports events on all three families.
"""
from __future__ import annotations


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
