"""Sensitivity analysis through the solvers (paper §6.6) — the PyTorch
counterpart of `repro.core.sensitivity`.

Both modes are capabilities of the front door
(`repro_torch.core.ensemble.solve_ensemble_local`, ``sensitivity=``); this
module is the convenience layer on top:

  forward_sensitivity      — du(t)/dθ for every trajectory and save point:
                             one `torch.func.jvp` pass per parameter column
                             through the plain loops (forward mode crosses
                             the Python while loop, so ADAPTIVE solves
                             differentiate without any bound).
  ensemble_value_and_grad  — loss(EnsembleResult) and its gradient with
                             respect to (u0s, ps) by reverse mode through
                             the bounded, checkpointed discrete adjoint
                             (``sensitivity="adjoint"``, `core.loops`):
                             memory O(sqrt-steps), the exact gradient of the
                             realized discretization.
  suggest_adjoint_steps    — probe the forward solve for the attempt-count
                             bound the adaptive adjoint needs.
  adjoint_continuous       — the continuous adjoint λ' = -(∂f/∂u)ᵀλ on a
                             backward replay: O(1)-in-steps memory, gradient
                             accurate to O(dt^order).  Kept as the
                             independent oracle the discrete adjoint is
                             tested against.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from .ensemble import solve_ensemble_local
from .problem import EnsembleProblem
from .solvers import solve_fixed
from .tableaus import Tableau

Tensor = torch.Tensor


def _resolve(eprob: EnsembleProblem, u0s, ps) -> EnsembleProblem:
    return EnsembleProblem(eprob.prob, u0s.shape[0], u0s=u0s, ps=ps)


def forward_sensitivity(eprob: EnsembleProblem, *, wrt: str = "ps",
                        **solve_kw) -> Tensor:
    """Forward-mode sensitivities du(t)/dθ through the front door.

    One `torch.func.jvp` pass per column of ``wrt`` ("ps" or "u0s"): each
    pass is a full ensemble solve carrying one tangent, and forward mode
    crosses the adaptive while loop untouched (no step bound needed).

    Returns ``(N, S, n, k)``: d ``us[i, s, :]`` / d ``θ[i, j]`` for each
    trajectory i (trajectory i's output with respect to its own
    parameters).  ``solve_kw`` are `solve_ensemble_local` arguments;
    ``sensitivity="forward"`` is implied (and validated)."""
    if wrt not in ("ps", "u0s"):
        raise ValueError(f"wrt must be 'ps' or 'u0s', got {wrt!r}")
    u0s, ps = eprob.materialize()
    kw = dict(solve_kw, sensitivity="forward")

    def us_of(u, p):
        return solve_ensemble_local(_resolve(eprob, u, p), **kw).us

    target = ps if wrt == "ps" else u0s
    cols = []
    for j in range(target.shape[1]):
        tangent = torch.zeros_like(target)
        tangent[:, j] = 1.0
        if wrt == "ps":
            _, dus = torch.func.jvp(lambda p_: us_of(u0s, p_), (ps,),
                                    (tangent,))
        else:
            _, dus = torch.func.jvp(lambda u_: us_of(u_, ps), (u0s,),
                                    (tangent,))
        cols.append(dus)
    return torch.stack(cols, dim=-1)


def suggest_adjoint_steps(eprob: EnsembleProblem, *, margin: float = 0.25,
                          **solve_kw) -> int:
    """Attempt-count bound for ``sensitivity="adjoint"`` on adaptive solves.

    Runs the forward solve once (the while loop, no autograd) and returns
    the worst ``naccept + nreject`` over the ensemble plus ``margin``
    headroom.  If a later solve under the returned bound still runs out
    (other parameters, a tighter tolerance), it reports ``status == 1``."""
    with torch.no_grad():
        res = solve_ensemble_local(eprob, **solve_kw)
    worst = int((res.naccept + res.nreject).max())
    return worst + max(4, int(math.ceil(worst * float(margin))))


def ensemble_value_and_grad(loss_fn: Callable, eprob: EnsembleProblem,
                            **solve_kw) -> Tuple[Tensor, Tuple[Tensor,
                                                               Tensor]]:
    """``(loss, (dL/du0s, dL/dps))`` through the checkpointed discrete
    adjoint.

    ``loss_fn`` maps the `EnsembleResult` to a scalar (use ``res.us`` /
    ``res.u_final``; solver statistics and event times are
    non-differentiable outputs).  ``solve_kw`` are `solve_ensemble_local`
    arguments — pass ``adjoint_steps=`` for adaptive solves (see
    `suggest_adjoint_steps`); ``sensitivity="adjoint"`` is implied."""
    u0s, ps = eprob.materialize()
    u = u0s.detach().clone().requires_grad_(True)
    p = ps.detach().clone().requires_grad_(True)
    kw = dict(solve_kw, sensitivity="adjoint")
    with torch.enable_grad():
        loss = loss_fn(solve_ensemble_local(_resolve(eprob, u, p), **kw))
        gu, gp = torch.autograd.grad(loss, (u, p))
    return loss.detach(), (gu, gp)


def adjoint_continuous(loss_of_uf: Callable, f, tab: Tableau, u0, p, t0, dt,
                       n_steps: int):
    """Continuous adjoint for terminal-state losses: O(1)-in-steps memory.

    Forward: integrate u to tf (no history).  Backward: integrate the
    augmented system (u, λ, μ) from tf to t0 with the same RK method:
        u'  = f(u)          (replayed backwards)
        λ' = -(∂f/∂u)ᵀ λ
        μ' = -(∂f/∂p)ᵀ λ
    Returns (loss, dL/du0, dL/dp).  The gradient differs from the discrete
    adjoint by the discretization error O(dt^order) — which is why it
    stays: an independent oracle for the discrete adjoint, agreeing with it
    as dt → 0 without sharing a code path with it."""
    res = solve_fixed(f, tab, u0, p, t0, dt, n_steps, save_every=n_steps)
    u_f = res.u_final
    dL_duf, loss = torch.func.grad_and_value(loss_of_uf)(u_f)
    tf_ = t0 + dt * n_steps
    n = u0.shape[0]

    def aug_rhs(state, p_, s):
        # backward pseudo-time s in [0, tf - t0]; physical time t = tf - s
        t = tf_ - s
        u = state[:n]
        lam = state[n:2 * n]
        du, vjp = torch.func.vjp(lambda uu, pp: f(uu, pp, t), u, p_)
        dlam, dmu = vjp(lam)
        return torch.cat([-du, dlam, dmu])

    aug0 = torch.cat([u_f, dL_duf, torch.zeros_like(p)])
    back = solve_fixed(aug_rhs, tab, aug0, p, 0.0, dt, n_steps,
                       save_every=n_steps)
    out = back.u_final
    return loss, out[n:2 * n], out[2 * n:]
