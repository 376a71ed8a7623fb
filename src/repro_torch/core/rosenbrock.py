"""Rosenbrock stiff ensemble engine — tableau-generic W-methods (paper
§5.1.3), the PyTorch counterpart of `repro.core.rosenbrock` in lanes mode.

One engine, driven by a `RosenbrockTableau` (γ, a, C, b, b̂, c, d), runs
Rosenbrock23 (3 stages), Rodas4 (6) and Rodas5P (8).  Per step it factors
W = I − γh·J once and back-substitutes s times:

    g_i   = u + Σ_{j<i} a_ij U_j
    W U_i = γh f(g_i, t + c_i h) + γ Σ_{j<i} C_ij U_j + γ d_i h² f_t
    u1    = u + Σ b_i U_i,    err = Σ btilde_i U_i

With ``w_reuse`` (lazy W) J, the factored W and the dt it was factored at
are carried across steps and refreshed per lane only when the
`WReusePolicy` asks, with a secant touch-up of J in between.

The Jacobian comes from the problem's analytic ``jac(u, p, t)`` when it has
one, else from `torch.func.jacfwd`.  The linear solves (``linsolve=``):
``"torch"`` the library's batched LU (`torch.linalg.lu_factor_ex` /
`lu_solve`, standing where the reference's LAPACK ``"jnp"`` stands),
``"lanes"`` the lanes LU body inline (`repro_torch.kernels.lu.kernel`), and
``"cuda"`` one launch of the batched LU kernel per stage solve
(`repro_torch.kernels.lu.ops.batched_solve`, the reference's
``"pallas"``).  The fused CUDA kernel `csrc/rosenbrock_ensemble.cu` runs
this loop with the lanes LU, one thread per trajectory; this module is its
plain twin.

Only lanes mode is ported: u (n, B) with per-lane t, dt and masks.  The
scalar mode and the bounded reverse-differentiable loop
(``bounded_steps``/``checkpoint_every``) wait for ROADMAP queue 1 item 9,
events for item 7.
"""
from __future__ import annotations

from typing import Optional

import torch

from .controller import (STATUS_DTMIN_EXHAUSTED, PIController, WReusePolicy,
                         hairer_norm, pi_propose, sum_left_to_right,
                         w_dt_blame, w_mark_stale, w_refresh)
from .events import hermite_interp
from .solvers import SolveResult
from .tableaus import RosenbrockTableau

LINSOLVES = ("torch", "lanes", "cuda")


def _scalar_mode():
    return NotImplementedError(
        "the scalar (per-trajectory) Rosenbrock mode is not ported yet: "
        "ROADMAP queue 1 item 9 (core/loops.py); use lanes=True")


def _jac_lanes(f, u, p, t, jac=None):
    """Per-lane Jacobian: u (n, B) -> J (B, n, n).

    The analytic hook is component style and returns (n, n, B); without it
    the Jacobian is `vmap(jacfwd(f))` over the lane axis."""
    if jac is not None:
        return jac(u, p, t).movedim(-1, 0)
    t_ax = 0 if t.dim() else None
    return torch.func.vmap(torch.func.jacfwd(f), in_dims=(-1, -1, t_ax))(
        u, p, t)


# ---------------------------------------------------------------------------
# lazy-W adapters: build / factor / resolve / masked select per linsolve
# mode.  The factored state is a nest of tensors, so it can be carried
# across steps and refreshed per lane under a mask.
# ---------------------------------------------------------------------------

def _w_build(J, dt, gam):
    """W = I − γ·dt·J, (B, n, n), the same expression as the eager step."""
    n = J.shape[-1]
    eye = torch.eye(n, dtype=J.dtype, device=J.device)[None]
    return eye - (dt * gam)[:, None, None] * J


def _w_factor(W, mode):
    """Factor W (B, n, n) for `_w_resolve`.  ``"cuda"`` carries W itself:
    a factorization cannot persist across a kernel launch, so each resolve
    launches the batched kernel (J reuse still saves the Jacobians;
    ``nfact`` then counts W rebuilds)."""
    if mode == "torch":
        LU, piv, _ = torch.linalg.lu_factor_ex(W)
        return LU, piv
    if mode == "lanes":
        from repro_torch.kernels.lu.kernel import lu_factor_lanes
        return lu_factor_lanes(W.permute(1, 2, 0))
    if mode == "cuda":
        return W
    raise ValueError(f"unknown linsolve mode {mode!r}; have {LINSOLVES}")


def _w_resolve(fac, rhs, mode):
    """Back-substitute one right-hand side rhs (n, B) against `_w_factor`."""
    if mode == "torch":
        LU, piv = fac
        return torch.linalg.lu_solve(LU, piv, rhs.T[..., None])[..., 0].T
    if mode == "lanes":
        from repro_torch.kernels.lu.kernel import lu_resolve_lanes
        return lu_resolve_lanes(fac, rhs)
    if mode == "cuda":
        from repro_torch.kernels.lu.ops import batched_solve
        return batched_solve(fac, rhs.T, backend="cuda").T
    raise ValueError(f"unknown linsolve mode {mode!r}; have {LINSOLVES}")


def _secant_update(J, du, dF, gain, mask):
    """Extrapolated-secant (Broyden) touch-up of the cached Jacobian:
    J ← J + gain·(ΔF − J·Δu)·Δuᵀ/(Δuᵀ·Δu) on lanes where `mask` holds, Δu ≠ 0
    and the correction is finite.  J (B, n, n), du and dF (n, B).  The dot
    products are summed left to right, as the kernel sums them."""
    nn = sum_left_to_right(du * du, 0)                     # (B,)
    Jdu = sum_left_to_right(J * du.T[:, None, :], -1).T    # (n, B)
    r = dF - Jdu
    corr = (r.T[:, :, None] * du.T[:, None, :]
            / torch.where(nn > 0, nn, torch.ones_like(nn))[:, None, None])
    ok = mask & (nn > 0) & torch.isfinite(corr).flatten(1).all(dim=1)
    return torch.where(ok[:, None, None], J + gain * corr, J)


def _tree_where(mask_of, new, old):
    if isinstance(new, (list, tuple)):
        return type(new)(_tree_where(mask_of, a, b) for a, b in zip(new, old))
    return torch.where(mask_of(new), new, old)


def _w_select(mask, fac_new, fac_old, mode):
    """Per-lane masked refresh of the factored state, mask (B,).  The
    ``"lanes"`` leaves keep the lane axis last; the others lead with it."""
    if mode == "lanes":
        mask_of = lambda a: mask
    else:
        mask_of = lambda a: mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return _tree_where(mask_of, fac_new, fac_old)


def rosenbrock_nf_per_step(rtab: RosenbrockTableau) -> int:
    """RHS evaluations per step: one per stage, plus f(u1) for Hermite dense
    output unless the tableau ships interpolation weights or its last stage
    argument already is u1 (ROS23W).  Jacobian and f_t passes are not
    counted."""
    extra = 0 if (rtab.interp_h is not None or rtab.fnew_from_last_stage) \
        else 1
    return rtab.stages + extra


def rosenbrock_step(f, rtab: RosenbrockTableau, u, p, t, dt, *, lanes=True,
                    linsolve="torch", jac=None):
    """One s-stage W-method step on a lane tile u (n, B), t and dt (B,).

    Returns (u_new, err, F0, F_new, kds): F_new is f(u_new, t + dt) (the
    last stage's value when the tableau's last stage argument is u1, None
    when the tableau interpolates from its own stages); kds are the dense
    output vectors kd_l = Σ_j interp_h[l, j] U_j (empty when none)."""
    if not lanes:
        raise _scalar_mode()
    J = _jac_lanes(f, u, p, t, jac)
    fac = _w_factor(_w_build(J, dt, float(rtab.gamma)), linsolve)
    return _stage_loop(f, rtab, u, p, t, dt,
                       lambda rhs: _w_resolve(fac, rhs, linsolve))


def _stage_loop(f, rtab: RosenbrockTableau, u, p, t, dt, solve, F0=None):
    """The s stage solves against an already factored W (`solve` maps a
    right-hand side to its solution); shared by the eager step and the
    lazy-W loop, which passes the f(u) it already has as `F0`.  Terms with
    a zero coefficient are skipped, and the products γ·C_ij and γ·d_i are
    taken in double precision first, as the reference folds them."""
    s = rtab.stages
    gam = float(rtab.gamma)
    a, C, d = rtab.a, rtab.C, rtab.d
    dtb = dt[None]
    Td = torch.func.jvp(lambda tt: f(u, p, tt), (t,),
                        (torch.ones_like(t),))[1]          # df/dt
    if F0 is None:
        F0 = f(u, p, t)
    Us = []
    F_last = F0
    for i in range(s):
        if i == 0:
            Fi = F0
        else:
            g = u
            for j in range(i):
                if a[i, j] != 0.0:
                    g = g + float(a[i, j]) * Us[j]
            Fi = f(g, p, t + float(rtab.c[i]) * dt)
        rhs = (gam * dtb) * Fi
        for j in range(i):
            if C[i, j] != 0.0:
                rhs = rhs + float(gam * C[i, j]) * Us[j]
        if d[i] != 0.0:
            rhs = rhs + float(gam * d[i]) * dtb * dtb * Td
        Us.append(solve(rhs))
        F_last = Fi
    u_new = u
    err = torch.zeros_like(u)
    for i in range(s):
        if rtab.b[i] != 0.0:
            u_new = u_new + float(rtab.b[i]) * Us[i]
        if rtab.btilde[i] != 0.0:
            err = err + float(rtab.btilde[i]) * Us[i]
    if rtab.interp_h is not None:
        kds = []
        for row in rtab.interp_h:
            kd = torch.zeros_like(u)
            for j in range(s):
                if row[j] != 0.0:
                    kd = kd + float(row[j]) * Us[j]
            kds.append(kd)
        return u_new, err, F0, None, tuple(kds)
    F_new = F_last if rtab.fnew_from_last_stage else f(u_new, p, t + dt)
    return u_new, err, F0, F_new, ()


def _dense_eval(rtab, th, u_old, u_cand, F0, F_new, kds, dtb):
    """Dense output at pre-broadcast theta `th`: the tableau's
    stiffly-accurate weights when it ships them,
        u(θ) = (1−θ)·u0 + θ·u1 + θ(1−θ)·(kd1 + θ·kd2 + ...),
    else cubic Hermite on (u0, F0, u1, F_new)."""
    if rtab.interp_h is not None:
        inner = kds[-1]
        for kd in kds[-2::-1]:
            inner = kd + th * inner
        return (1.0 - th) * u_old + th * u_cand + th * (1.0 - th) * inner
    return hermite_interp(u_old, F0, u_cand, F_new, dtb, th, lanes=False)


def _policy(w_reuse) -> Optional[WReusePolicy]:
    if w_reuse is None or w_reuse is False:
        return None
    return w_reuse if isinstance(w_reuse, WReusePolicy) else WReusePolicy()


def solve_rosenbrock(f, rtab: RosenbrockTableau, u0, p, t0, tf, dt0, *,
                     rtol=1e-6, atol=1e-6, saveat=None, max_iters=100_000,
                     lanes=True, linsolve="torch", jac=None,
                     controller: Optional[PIController] = None, event=None,
                     w_reuse=None, bounded_steps=None,
                     checkpoint_every=None) -> SolveResult:
    """Adaptive s-stage Rosenbrock solve of a lane tile u0 (n, B), p (m, B),
    with dense output onto `saveat`.

    `jac` is the analytic Jacobian hook ((u, p, t) -> (n, n, B)); None takes
    it by `jacfwd`.  ``w_reuse`` None/False steps eagerly (one Jacobian and
    one factorization per attempt); True takes the default `WReusePolicy`,
    an instance customizes it.  The result's ``njac``/``nfact`` count the
    Jacobians and factorizations per lane (eager: both equal the attempts).
    Every lane steps until it reaches tf; finished lanes step at dt = 0,
    an exact no-op."""
    if not lanes:
        raise _scalar_mode()
    if event is not None:
        raise NotImplementedError(
            "events on the stiff family are not ported yet: ROADMAP queue 1 "
            "item 7 (core/events.py)")
    if bounded_steps is not None or checkpoint_every is not None:
        raise NotImplementedError(
            "bounded_steps/checkpoint_every (the reverse-differentiable "
            "loop) are not ported yet: ROADMAP queue 1 item 9 "
            "(core/loops.py)")
    policy = _policy(w_reuse)
    dtype, dev = u0.dtype, u0.device
    q = min(rtab.order, rtab.embedded_order)  # order the estimator measures
    ctrl = controller or PIController.for_order(q)
    nf_step = rosenbrock_nf_per_step(rtab)
    gam = float(rtab.gamma)
    B = u0.shape[-1]
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    t0 = as_t(t0)
    tf = as_t(tf)
    saveat = as_t([tf.item()] if saveat is None else saveat)
    S = saveat.shape[0]
    pre = (saveat <= t0).reshape(S, 1, 1)
    us0 = torch.where(pre, u0[None], torch.zeros((S,) + tuple(u0.shape),
                                                 dtype=dtype, device=dev))
    zeros_i = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)

    def jac_eval(u, t):
        return _jac_lanes(f, u, p, t, jac)

    c = dict(t=t0.expand(B).clone(), u=u0, dt=as_t(dt0).expand(B).clone(),
             enorm_prev=torch.ones((B,), dtype=dtype, device=dev),
             done=torch.zeros((B,), dtype=torch.bool, device=dev), us=us0,
             naccept=zeros_i(), nreject=zeros_i(), status=zeros_i(), iters=0)
    if policy is not None:
        # lazy-W state: what the freshness controller needs to decide, per
        # lane, whether this step may ride on the last step's linear algebra
        J0 = jac_eval(u0, c["t"])
        c.update(J=J0, fac=_w_factor(_w_build(J0, c["dt"], gam), linsolve),
                 dt_fact=c["dt"], age=zeros_i(),
                 jac_stale=torch.zeros((B,), dtype=torch.bool, device=dev),
                 u_prev=u0, F_prev=torch.zeros_like(u0),
                 was_accept=torch.zeros((B,), dtype=torch.bool, device=dev),
                 njac=zeros_i() + 1, nfact=zeros_i() + 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    eps_end = 1e-7 * torch.clamp(tf.abs(), min=1.0)

    while c["iters"] < max_iters and not bool(c["done"].all()):
        t, u, dt = c["t"], c["u"], c["dt"]
        active = ~c["done"]
        dt_step = torch.where(active, torch.minimum(dt, tf - t), zero)
        if policy is None:
            u_cand, err, F0, F_new, kds = rosenbrock_step(
                f, rtab, u, p, t, dt_step, linsolve=linsolve, jac=jac)
        else:
            need_jac, drift_fact = w_refresh(policy, gam, dt_step,
                                             c["dt_fact"], c["jac_stale"])
            need_jac = need_jac & active
            F0 = f(u, p, t)
            if policy.secant:
                upd = c["was_accept"] & ~need_jac & active
                J_base = _secant_update(c["J"], u - c["u_prev"],
                                        F0 - c["F_prev"], policy.secant, upd)
            else:
                upd = torch.zeros_like(active)
                J_base = c["J"]
            need_fact = (drift_fact | upd) & active
            # between refreshes dt freezes at dt_fact, so the factored W is
            # reused as it is
            dt_step = torch.where(
                need_fact, dt_step,
                torch.where(active, torch.minimum(c["dt_fact"], tf - t),
                            zero))
            J, fac, dt_fact = J_base, c["fac"], c["dt_fact"]
            if bool(need_fact.any()):
                J_new = jac_eval(u, t) if bool(need_jac.any()) else J
                J = torch.where(need_jac[:, None, None], J_new, J)
                fac_new = _w_factor(_w_build(J, dt_step, gam), linsolve)
                fac = _w_select(need_fact, fac_new, fac, linsolve)
                dt_fact = torch.where(need_fact, dt_step, dt_fact)
            u_cand, err, _, F_new, kds = _stage_loop(
                f, rtab, u, p, t, dt_step,
                lambda rhs: _w_resolve(fac, rhs, linsolve), F0=F0)
        enorm = hairer_norm(err, u, u_cand, atol, rtol, dim=0)
        finite = torch.isfinite(u_cand).all(dim=0)
        accept = (enorm <= 1.0) & finite & active
        dt_next, enorm_prev = pi_propose(ctrl, dt, enorm, c["enorm_prev"],
                                         accept)
        if policy is not None and not policy.secant:
            dt_next = w_dt_blame(accept, need_jac, dt_step, dt_next)
        t_new = torch.where(accept, t + dt_step, t)
        u_new = torch.where(accept[None], u_cand, u)

        # dense-output grid save (skipped when no lane can cross a point)
        us = c["us"]
        if bool((accept & (saveat.max() > t.min())).any()):
            eps = 1e-7 * torch.clamp(t_new.abs(), min=1.0)
            crossed = ((saveat[:, None] > t[None]) &
                       (saveat[:, None] <= t_new[None] + eps[None]) &
                       accept[None])
            step = torch.where(dt_step == 0, torch.ones_like(dt_step),
                               dt_step)
            theta = torch.clamp((saveat[:, None] - t[None]) / step[None],
                                0.0, 1.0)
            vals = _dense_eval(rtab, theta[:, None, :], u[None],
                               u_cand[None],
                               None if F0 is None else F0[None],
                               None if F_new is None else F_new[None],
                               tuple(kd[None] for kd in kds),
                               dt_step[None, None, :])
            us = torch.where(crossed[:, None, :], vals, us)

        # dt pinned at the controller floor and still rejecting: the retry
        # is identical, so the lane terminates.  On the lazy path a
        # rejection taken on a reused J is exempt: its retry refreshes J.
        hopeless = active & ~accept & ~(dt_step > ctrl.dtmin)
        if policy is not None:
            hopeless = hopeless & need_jac
        status = torch.where(hopeless, STATUS_DTMIN_EXHAUSTED, c["status"])
        done = c["done"] | hopeless | (t_new >= tf - eps_end)
        out = dict(t=t_new, u=u_new, dt=dt_next, enorm_prev=enorm_prev,
                   done=done, us=us,
                   naccept=c["naccept"] + accept.to(torch.int32),
                   nreject=c["nreject"] + (active & ~accept).to(torch.int32),
                   status=status.to(torch.int32), iters=c["iters"] + 1)
        if policy is not None:
            age = (torch.where(need_jac, 0, c["age"])
                   + accept.to(torch.int32))
            out.update(
                J=J, fac=fac, dt_fact=dt_fact, age=age.to(torch.int32),
                jac_stale=w_mark_stale(policy, accept, enorm,
                                       c["enorm_prev"], age, need_jac),
                u_prev=torch.where(accept[None], u, c["u_prev"]),
                F_prev=torch.where(accept[None], F0, c["F_prev"]),
                was_accept=accept,
                njac=c["njac"] + need_jac.to(torch.int32),
                nfact=c["nfact"] + need_fact.to(torch.int32))
        c = out

    nsteps = c["naccept"] + c["nreject"]
    status = torch.where(c["status"] > 0, c["status"],
                         torch.where(c["done"], 0, 1).to(torch.int32))
    return SolveResult(
        ts=saveat, us=c["us"], t_final=c["t"], u_final=c["u"],
        naccept=c["naccept"], nreject=c["nreject"],
        status=status.to(torch.int32), nf=nsteps * nf_step,
        njac=c["njac"] if policy is not None else nsteps,
        nfact=c["nfact"] if policy is not None else nsteps)
