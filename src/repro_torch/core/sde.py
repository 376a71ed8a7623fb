"""SDE steppers (paper §3.2, §5.2.2, §6.8), fixed-dt and adaptive — the
port of `repro.core.sde`, in PyTorch.

Methods (the paper's GPU kernel set):
  em         — GPUEM: Euler-Maruyama, Ito; diagonal AND general (n×m) noise.
  platen_w2  — GPUSIEA role: explicit weak-order-2 Platen scheme, diagonal
               noise only.
  heun_strat — Stratonovich Heun.
  milstein   — strong order 1.0, diagonal noise; its derivative term comes
               from `torch.func.jvp` on the user's diffusion.

All steppers are shape-polymorphic: u (n,) for one trajectory or (n, B)
lanes; the same definition runs under `torch.func.vmap`, over the lanes of
the whole ensemble, and as the plain version of the CUDA kernel
(`repro_torch.kernels.em`).

Adaptive stepping (`sde_solve_adaptive`) controls the local error with an
embedded pair (`SDE_EMBEDDED`: em, milstein) or by step doubling (every
stepper), and draws its increments from the virtual Brownian tree
(`repro_torch.kernels.rng.brownian_bridge_point`), so a rejected step
replays its path bitwise.  It runs in lanes mode, the plain version of the
adaptive CUDA kernel (`repro_torch.kernels.em.adaptive`).  Both loops take
events (`repro_torch.core.events`), located on the piecewise-linear path
output.  Under ``bounded_steps`` the adaptive loop is the bounded,
checkpointed form of `repro_torch.core.loops.solver_loop` (reverse mode);
the counter-RNG noise is a pure function of integers, so a recomputed
segment replays its path bitwise.  `sde_resume_init` and `sde_resume_body`
are the fixed-dt loop with per-lane (k, t0, dt, n_steps, lane) in the carry,
the substrate of the resumable segment engine
(`core.ensemble.make_resumable_engine`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from .controller import (STATUS_DTMIN_EXHAUSTED, PIController, hairer_norm,
                         pi_propose, sum_left_to_right)
from .events import handle_event, linear_interp
from .loops import checkpointed_fori, solver_loop
from .problem import EnsembleProblem, SDEProblem
from .solvers import SolveResult

Tensor = torch.Tensor


def _sqrt_dt(dt, dtype):
    return torch.sqrt(torch.as_tensor(dt, dtype=dtype))


def apply_noise(g_val, dW, noise: str):
    """g(u)·dW with g_val (n,[B]) diagonal or (n,m,[B]) general; dW (m,[B])."""
    if noise == "diagonal":
        return g_val * dW
    # general: contract the noise axis (axis 1 of g_val), each product and
    # sum rounded on its own, left to right, as a kernel thread computes it
    # (a library contraction may fuse or reorder them)
    return sum_left_to_right(g_val * dW.unsqueeze(0), 1)


def em_step(f, g, u, p, t, dt, dW, noise="diagonal"):
    """X' = X + f dt + g dW  (Ito; strong 0.5 / weak 1)."""
    return u + f(u, p, t) * dt + apply_noise(g(u, p, t), dW, noise)


def heun_strat_step(f, g, u, p, t, dt, dW, noise="diagonal"):
    """Stratonovich Heun (strong 0.5 / weak 1 in Stratonovich sense)."""
    du1 = f(u, p, t) * dt + apply_noise(g(u, p, t), dW, noise)
    ub = u + du1
    du2 = f(ub, p, t + dt) * dt + apply_noise(g(ub, p, t + dt), dW, noise)
    return u + 0.5 * (du1 + du2)


def platen_w2_step(f, g, u, p, t, dt, dW, noise="diagonal"):
    """Explicit weak-order-2 Platen scheme, diagonal noise (Kloeden & Platen
    (15.1.1)/(14.2.4) family). Supporting values:
        ubar = u + a dt + b dW ;  u± = u + a dt ± b sqrt(dt)
        u'   = u + dt/2 (a(ubar)+a(u))
                 + dW/4 (b(u+)+b(u-)+2 b(u))
                 + (dW^2-dt)/(4 sqrt(dt)) (b(u+)-b(u-))
    """
    if noise != "diagonal":
        raise ValueError("platen_w2 supports diagonal noise only (as the "
                         "paper's GPUSIEA)")
    a0 = f(u, p, t)
    b0 = g(u, p, t)
    sdt = _sqrt_dt(dt, u.dtype)
    drift = u + a0 * dt
    ubar = drift + b0 * dW
    up = drift + b0 * sdt
    um = drift - b0 * sdt
    t1 = t + dt
    a1 = f(ubar, p, t1)
    bp = g(up, p, t1)
    bm = g(um, p, t1)
    return (u + 0.5 * dt * (a1 + a0)
            + 0.25 * dW * (bp + bm + 2.0 * b0)
            + 0.25 * (dW * dW - dt) / sdt * (bp - bm))


def milstein_step(f, g, u, p, t, dt, dW, noise="diagonal"):
    """Milstein (diagonal noise): strong order 1.0.
        X' = X + a dt + b dW + 1/2 ((∂b/∂x)·b) (dW² - dt)
    The derivative term is forward-mode AD on the user's diffusion
    (`torch.func.jvp`).  Exact for componentwise diffusions g_i(u_i)."""
    if noise != "diagonal":
        raise ValueError("milstein currently supports diagonal noise")
    a0 = f(u, p, t)
    b0, db = torch.func.jvp(lambda uu: g(uu, p, t), (u,), (g(u, p, t),))
    return u + a0 * dt + b0 * dW + 0.5 * db * (dW * dW - dt)


# ----------------------------------------------------------------------------
# embedded error pairs (RSwM-style rejection sampling, no step doubling)
# ----------------------------------------------------------------------------

def em_embedded_step(f, g, u, p, t, dt, dW, noise="diagonal"):
    """Euler–Maruyama propagation + embedded tamed-Milstein-difference error:

        err = 1/2 ((∂b/∂x)·b) (dW² - dt)  +  (a - a/(1 + dt|a|)) dt

    The pair propagates the plain EM solution.  Diagonal noise only (use
    ``error_est="doubling"`` for general noise)."""
    if noise != "diagonal":
        raise ValueError("em embedded pair supports diagonal noise only; "
                         "use error_est='doubling' for general noise")
    a0 = f(u, p, t)
    b0, db = torch.func.jvp(lambda uu: g(uu, p, t), (u,), (g(u, p, t),))
    err = (0.5 * db * (dW * dW - dt)
           + (a0 - a0 / (1.0 + dt * a0.abs())) * dt)
    return u + a0 * dt + b0 * dW, err


def milstein_embedded_step(f, g, u, p, t, dt, dW, noise="diagonal"):
    """Milstein propagation + deterministic embedded companion error: the
    drift-taming difference ``(a - a/(1 + dt|a|)) dt`` plus the rms of the
    leading neglected Itô–Taylor term, ``|∂((∂b)·b)·b| · dt^1.5 / sqrt(6)``,
    from a JVP nested in a JVP (`torch.func.jvp`).  nf_per_attempt stays 1:
    the extra work is diffusion JVPs only."""
    if noise != "diagonal":
        raise ValueError("milstein currently supports diagonal noise")
    a0 = f(u, p, t)

    def db_of(uu):
        bb = g(uu, p, t)
        return torch.func.jvp(lambda w: g(w, p, t), (uu,), (bb,))[1]

    b0 = g(u, p, t)
    db, ddb = torch.func.jvp(db_of, (u,), (b0,))   # (∂b)·b, ∂((∂b)·b)·b
    u_new = u + a0 * dt + b0 * dW + 0.5 * db * (dW * dW - dt)
    dt15 = dt * _sqrt_dt(dt, u.dtype)
    # sqrt(6) as a tensor on u's device: PyTorch's CUDA division by a CPU
    # scalar multiplies by its rounded reciprocal instead
    sqrt6 = torch.sqrt(torch.tensor(6.0, dtype=u.dtype, device=u.device))
    err = ((a0 - a0 / (1.0 + dt * a0.abs())) * dt
           + ddb.abs() * dt15 / sqrt6)
    return u_new, err


class EmbeddedPair(NamedTuple):
    """An SDE embedded error pair as registered on a `MethodSpec`.

    fn:             (f, g, u, p, t, dt, dW, noise) -> (u_prop, err)
    est_order:      dt-order of the estimator (PI controller exponents)
    nf_per_attempt: drift evaluations charged to `nf` per attempted step
    """
    fn: Callable
    est_order: int
    nf_per_attempt: int


# name -> EmbeddedPair.  Steppers absent here support error_est="doubling"
# only (the registry derives the capability tuple from this).
SDE_EMBEDDED = {
    "em": EmbeddedPair(em_embedded_step, est_order=1, nf_per_attempt=1),
    # the estimator's leading term is O(dt^1.5); est_order=1 is the
    # conservative integer controller exponent for it
    "milstein": EmbeddedPair(milstein_embedded_step, est_order=1,
                             nf_per_attempt=1),
}


SDE_STEPPERS = {
    "em": em_step,
    "heun_strat": heun_strat_step,
    "platen_w2": platen_w2_step,
    "siea": platen_w2_step,  # paper-facing alias
    "milstein": milstein_step,
}


def sde_nf_per_step(method: str) -> int:
    """Drift evaluations per step (the nf work proxy): em and milstein
    evaluate the drift once, the two-stage schemes twice."""
    return 1 if method in ("em", "milstein") else 2


def sde_save_grid(t0, dt, n_steps: int, save_every: int, dtype,
                  device=None):
    """The fixed-step snapshot times: t0 + dt*save_every*(1..S)."""
    return (torch.tensor(t0, dtype=dtype, device=device)
            + torch.tensor(dt, dtype=dtype, device=device) * save_every
            * torch.arange(1, n_steps // save_every + 1, dtype=dtype,
                           device=device))


def _sde_snapshot(us, u, k: int, save_every: int):
    """Snapshot write for step k (shared by the fixed-dt loop bodies):
    step k fills slot (k+1)/save_every - 1 when save_every divides k+1.
    ``us=None`` writes nothing (the checkpointed loops collect their
    snapshots out of place)."""
    if us is not None and (k + 1) % save_every == 0:
        us[(k + 1) // save_every - 1] = u
    return us


def sde_step_and_save(stepper, f, g, noise: str, u, us, p, t0, dt, k: int,
                      z, save_every: int):
    """ONE fixed-dt step + snapshot write — the loop body every SDE path
    shares (vmap, lanes, the kernel's plain version).  Layout-polymorphic:
    u (n,)/(n, B) with us (S, n)/(S, n, B); z is the N(0,1) draw for step
    k.  t = t0 + k·dt is computed from k, never accumulated."""
    dtv = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
    t = t0 + k * dtv
    u = stepper(f, g, u, p, t, dtv, z * torch.sqrt(dtv), noise)
    us = _sde_snapshot(us, u, k, save_every)
    return u, us


def sde_event_state0(cshape, t0, dtype, device=None):
    """Initial per-control-element event and termination state of the
    event-aware fixed-dt loop body: (done, t_out, naccept, event_t,
    event_count)."""
    return dict(done=torch.zeros(cshape, dtype=torch.bool, device=device),
                t_out=torch.full(cshape, t0, dtype=dtype, device=device),
                naccept=torch.zeros(cshape, dtype=torch.int32, device=device),
                event_t=torch.full(cshape, float("inf"), dtype=dtype,
                                   device=device),
                event_count=torch.zeros(cshape, dtype=torch.int32,
                                        device=device))


def sde_step_save_event(stepper, f, g, noise: str, ev, u, us, estate, p, t0,
                        dt, k: int, z, save_every: int):
    """Event-aware variant of `sde_step_and_save` — the shared fixed-dt loop
    body with per-lane termination (paper §6.6 on the SDE family).

    Event times are located by bisection on the piecewise-linear path
    output.  Terminal hits freeze the lane (its snapshots keep the frozen
    state); a non-terminal affect is applied at the event point and
    integration resumes at the step's grid end (the fixed grid is never
    rewound).  `estate` is the dict of `sde_event_state0`: t_out reports the
    event time of a terminal hit, else the grid time, and naccept counts the
    steps a lane was active.  Layout-polymorphic like the no-event body."""
    dtv = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
    t = t0 + k * dtv
    lanes = u.dim() == 2
    active = ~estate["done"]
    u_new = stepper(f, g, u, p, t, dtv, z * torch.sqrt(dtv), noise)

    def interp_fn(theta):
        return linear_interp(u, u_new, theta, lanes=lanes)

    u_next, t_next, ev_t, ev_n, term = handle_event(
        ev, interp_fn, u, u_new, p, t, dtv, t + dtv, active,
        estate["event_t"], estate["event_count"], lanes=lanes)
    act_e = active[None] if lanes else active
    u = torch.where(act_e, u_next, u)
    # terminal: report the located event time; otherwise the grid time
    t_out = torch.where(term, t_next, torch.where(active, t + dtv,
                                                  estate["t_out"]))
    us = _sde_snapshot(us, u, k, save_every)
    estate = dict(done=estate["done"] | term, t_out=t_out,
                  naccept=estate["naccept"] + active.to(torch.int32),
                  event_t=ev_t, event_count=ev_n)
    return u, us, estate


def sde_resume_init(u0, p, t0, dt, n_steps, lane):
    """Fresh per-lane resume carry of the fixed-dt SDE loop (lanes mode).

    u0 (n, B); p (k, B); t0, dt numbers or (B,); n_steps a number or (B,)
    per-lane step counts; lane a number or (B,) GLOBAL lane indices (uint32
    values, held as int64): the counter-RNG stream key.  The key travels
    with the carry, so a recycled slot keeps its request's noise stream:
    `sde_resume_body` draws step k of lane g from
    counter_normals_threefry(seed, k, g, row) as
    `repro_torch.kernels.em.ref.solve_lanes` does."""
    dtype, device = u0.dtype, u0.device
    cshape = (u0.shape[-1],)

    def lane_of(v, dt_):
        return torch.as_tensor(v, dtype=dt_, device=device).expand(
            cshape).clone()

    tv = lane_of(t0, dtype)
    i32 = lambda v: torch.full(cshape, v, dtype=torch.int32, device=device)
    return dict(
        u=u0, p=p, k=i32(0), n_steps=lane_of(n_steps, torch.int32),
        t0=tv, dt=lane_of(dt, dtype), lane=lane_of(lane, torch.int64),
        done=torch.zeros(cshape, dtype=torch.bool, device=device),
        t_out=tv.clone(), naccept=i32(0), nf=i32(0), status=i32(0),
        event_t=torch.full(cshape, float("inf"), dtype=dtype, device=device),
        event_count=i32(0),
        iters=torch.zeros((), dtype=torch.int32, device=device))


def sde_resume_body(f, g, method: str, noise: str, m_noise: int, seed,
                    event=None):
    """The per-lane resumable fixed-dt SDE step over the carry of
    `sde_resume_init`: the operations of `sde_step_and_save` (or
    `sde_step_save_event`) with per-lane (k, t0, dt, n_steps, lane) for the
    shared numbers, and no snapshot buffer (serving returns final states).
    Done lanes are write-masked, so a mixed-progress tile is an exact no-op
    on its finished lanes; active lanes compute the fresh loop's
    expressions on the same (seed; step, lane, row) counters, so recycling
    is bitwise invisible."""
    from repro_torch.kernels.rng import counter_normals_threefry
    stepper = SDE_STEPPERS[method]
    nfps = sde_nf_per_step(method)

    def body(c):
        u, p = c["u"], c["p"]
        B = u.shape[-1]
        active = ~c["done"]
        k, dtv = c["k"], c["dt"]
        t = c["t0"] + k * dtv
        lane = c["lane"][None, :].expand(m_noise, B)
        rows = torch.arange(m_noise, dtype=torch.int64,
                            device=u.device)[:, None].expand(m_noise, B)
        z = counter_normals_threefry(seed, k, lane, rows, u.dtype)
        u_new = stepper(f, g, u, p, t, dtv, z * torch.sqrt(dtv), noise)
        if event is not None:
            def interp_fn(theta):
                return linear_interp(u, u_new, theta, lanes=True)

            u_next, t_next, ev_t, ev_n, term = handle_event(
                event, interp_fn, u, u_new, p, t, dtv, t + dtv, active,
                c["event_t"], c["event_count"], lanes=True)
        else:
            u_next, t_next = u_new, t + dtv
            ev_t, ev_n = c["event_t"], c["event_count"]
            term = torch.zeros_like(active)
        t_out = torch.where(term, t_next,
                            torch.where(active, t + dtv, c["t_out"]))
        k_new = k + active.to(torch.int32)
        return dict(
            u=torch.where(active[None], u_next, u), p=p, k=k_new,
            n_steps=c["n_steps"], t0=c["t0"], dt=dtv, lane=c["lane"],
            done=c["done"] | term | (k_new >= c["n_steps"]), t_out=t_out,
            naccept=c["naccept"] + active.to(torch.int32),
            nf=c["nf"] + active.to(torch.int32) * nfps,
            status=c["status"], event_t=ev_t, event_count=ev_n,
            iters=c["iters"] + 1)

    return body


def sde_solve_fixed(prob: SDEProblem, u0, p, t0, dt, n_steps: int, key,
                    method: str = "em", save_every: int = 1,
                    noise_table: Optional[Tensor] = None,
                    remat: bool = False) -> SolveResult:
    """Fixed-dt SDE integration of one trajectory (n,) or lanes (n, B),
    noise from `noise_table` (n_steps, m[, B]) of N(0,1) draws, or, as the
    reference draws it, step k from ``jax.random.normal(fold_in(key, k),
    (m,) + u0.shape[1:])`` (`repro_torch.kernels.rng.jax_normal`; `key` is
    a raw jax key's two words or a seed).  As in the reference, t is
    accumulated step by step here (t_final = t0 + dt + ... + dt).

    ``remat=True`` runs the same steps through
    `repro_torch.core.loops.checkpointed_fori`: the primal is bitwise the
    same, and the backward pass replays each segment's noise from its
    carry instead of keeping every step."""
    from repro_torch.kernels.rng import jax_fold_in, jax_normal
    if n_steps % save_every != 0:
        raise ValueError(f"save_every={save_every} must divide "
                         f"n_steps={n_steps}")
    S = n_steps // save_every
    stepper = SDE_STEPPERS[method]
    dtype = u0.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=u0.device)
    sdt = _sqrt_dt(dt, dtype)
    table = (None if noise_table is None
             else torch.as_tensor(noise_table, device=u0.device))
    nshape = (prob.noise_dim(),) + tuple(u0.shape[1:])

    def step(k, c):
        u, t, snaps = c
        if table is not None:
            z = table[k].to(dtype)
        else:
            z = jax_normal(jax_fold_in(key, k), nshape, dtype, u0.device)
        u = stepper(prob.f, prob.g, u, p, t, dt, z * sdt, prob.noise)
        if (k + 1) % save_every == 0:
            snaps = snaps + (u,)
        return u, t + dt, snaps

    c = (u0, torch.as_tensor(t0, dtype=dtype, device=u0.device), ())
    if remat:
        c = checkpointed_fori(0, n_steps, step, c)
    else:
        for k in range(n_steps):
            c = step(k, c)
    u, t, us = c
    ts = (torch.as_tensor(t0, dtype=dtype, device=u0.device)
          + dt * save_every * torch.arange(1, S + 1, dtype=dtype,
                                           device=u0.device))
    i64 = lambda v: torch.tensor(v, device=u0.device)
    return SolveResult(ts=ts, us=torch.stack(us), t_final=t, u_final=u,
                       naccept=i64(n_steps), nreject=i64(0), status=i64(0),
                       nf=i64(n_steps * (2 if method != "em" else 1)))


# ----------------------------------------------------------------------------
# adaptive driver: embedded-pair or step-doubling error + virtual Brownian
# tree (RSwM-style rejection-safe noise)
# ----------------------------------------------------------------------------

def default_bridge_depth(t0, tf, dt0, min_depth: int = 6,
                         max_depth: int = 22) -> int:
    """Dyadic resolution of the virtual Brownian tree for adaptive stepping.

    Depth D puts the finest grid at (tf-t0)/2**D; the controller can shrink
    steps to 2 grid cells, so the default gives ~64x refinement headroom
    below dt0 (steps at the floor force-accept — raise the depth for very
    tight tolerances).  Pure Python: the depth is part of the launch,
    identical on every strategy and backend."""
    n0 = max(1.0, (float(tf) - float(t0)) / float(dt0))
    return int(min(max_depth, max(min_depth, math.ceil(math.log2(n0)) + 6)))


def sde_solve_adaptive(f, g, stepper, noise: str, u0, p, t0, tf, dt0, *,
                       seed: int, lane_idx, m_noise: int, saveat=None,
                       rtol=1e-2, atol=1e-4, max_iters: int = 100_000,
                       event=None, lanes: bool = False,
                       depth: Optional[int] = None, order: float = 0.5,
                       nf_per_step: int = 1, error_est: str = "doubling",
                       embedded: Optional[Callable] = None,
                       est_order: Optional[int] = None,
                       nf_per_attempt: Optional[int] = None,
                       controller: Optional[PIController] = None,
                       bounded_steps: Optional[int] = None,
                       checkpoint_every: Optional[int] = None) -> SolveResult:
    """Adaptive SDE integration with per-lane dt control.

    * **Local error** per attempted step, by ``error_est``: ``"embedded"``
      (the pair `embedded`, one stepper pass and one Brownian-tree descent
      per attempt) or ``"doubling"`` (one step of dt against two of dt/2 on
      the same path, the finer propagated, the difference scaled by the
      Richardson factor 1/(2^order - 1); three stepper passes and two
      descents, any stepper).
    * **Rejection-safe noise**: W comes from the virtual Brownian tree, a
      pure function of (seed; lane, row, dyadic index), so a rejected step
      retried with a smaller dt sees the same path bitwise.  Steps are whole
      cells of the depth-`depth` dyadic grid (an even count for doubling);
      a step the controller wants below the floor force-accepts.
    * **saveat** output by linear interpolation over accepted steps.

    lanes=True integrates u0 (n, B) with per-lane control and lane_idx (B,)
    the GLOBAL trajectory indices (the noise stream's key); lanes=False
    integrates one trajectory u0 (n,) with a scalar lane_idx, as one lane.
    The body follows the reference expression by expression: t = t0 +
    idx·h_res from the integer index on every attempt, the carried W(idx),
    the clip order of the cell count, `hopeless` lanes ending with
    STATUS_DTMIN_EXHAUSTED, and nf charged per attempt.

    **Events** run the shared machinery on the piecewise-linear output.
    A terminal hit freezes the lane at the located event time (``t_final``
    reports it, saves stop there); a non-terminal hit applies the affect
    and resumes on the first dyadic grid point at or after the event time,
    whose W the tree replays exactly.  With an event the result is
    (SolveResult, {"event_t", "event_count"}).

    ``bounded_steps`` runs that many loop bodies in checkpointed segments
    of ``checkpoint_every`` (`repro_torch.core.loops.solver_loop`) with the
    error norm detached: the pathwise discrete adjoint.  A bound too small
    reports status 1.
    """
    from repro_torch.kernels import rng

    if error_est not in ("embedded", "doubling"):
        raise ValueError(f"unknown error_est {error_est!r} "
                         "(use 'embedded' or 'doubling')")
    use_pair = error_est == "embedded"
    if use_pair and embedded is None:
        raise ValueError("error_est='embedded' needs an embedded pair fn "
                         "(see repro_torch.core.sde.SDE_EMBEDDED)")
    if depth is None:
        raise ValueError("sde_solve_adaptive needs a `depth` "
                         "(see default_bridge_depth)")
    if not lanes:
        # one trajectory as one lane: the Hairer norm of n components is
        # the same mean either way
        lane = torch.as_tensor(lane_idx, dtype=torch.int64).reshape(1)
        out = sde_solve_adaptive(
            f, g, stepper, noise, u0[:, None], p[:, None], t0, tf, dt0,
            seed=seed, lane_idx=lane, m_noise=m_noise, saveat=saveat,
            rtol=rtol, atol=atol, max_iters=max_iters, event=event,
            lanes=True, depth=depth, order=order, nf_per_step=nf_per_step,
            error_est=error_est, embedded=embedded, est_order=est_order,
            nf_per_attempt=nf_per_attempt, controller=controller,
            bounded_steps=bounded_steps, checkpoint_every=checkpoint_every)
        res = out[0] if event is not None else out
        res = SolveResult(ts=res.ts, us=res.us[..., 0],
                          t_final=res.t_final[0], u_final=res.u_final[:, 0],
                          naccept=res.naccept[0], nreject=res.nreject[0],
                          status=res.status[0], nf=res.nf[0])
        if event is not None:
            return res, {k: v[0] for k, v in out[1].items()}
        return res
    if est_order is None:
        est_order = max(1, int(round(order)))
    if nf_per_attempt is None:
        nf_per_attempt = 3 * nf_per_step
    ctrl = controller or PIController.for_order(int(est_order))
    dtype, dev = u0.dtype, u0.device
    n, B = u0.shape
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    t0, tf = as_t(t0), as_t(tf)
    n_total = 2 ** depth
    h_res = (tf - t0) / n_total
    t_total = tf - t0
    lane_m = (torch.as_tensor(lane_idx, dtype=torch.int64, device=dev)
              .reshape(1, B) & rng.M32).expand(m_noise, B)
    rows = torch.arange(m_noise, dtype=torch.int64,
                        device=dev)[:, None].expand(m_noise, B)

    def w_at(idx_c):             # (..., B) grid indices -> (..., m, B)
        return rng.brownian_bridge_point(
            seed, idx_c.unsqueeze(-2), lane_m, rows, depth=depth,
            t_total=t_total, dtype=dtype)

    saveat = as_t([tf] if saveat is None else saveat).reshape(-1)
    S = saveat.shape[0]
    i32 = lambda: torch.zeros(B, dtype=torch.int32, device=dev)
    c0 = dict(
        us=torch.where((saveat <= t0)[:, None, None], u0[None],
                       torch.zeros((S, n, B), dtype=dtype, device=dev)),
        w_l=torch.zeros((m_noise, B), dtype=dtype, device=dev),  # W(0) = 0
        idx=torch.zeros(B, dtype=torch.int64, device=dev), u=u0,
        dt=as_t(dt0).expand(B),
        enorm_prev=torch.ones(B, dtype=dtype, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        t_out=t0.expand(B), naccept=i32(), nreject=i32(), nf=i32(),
        status=i32(),
        event_t=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        event_count=i32(), iters=0)
    min_cells = 1 if use_pair else 2
    richardson = 1.0 / (2.0 ** order - 1.0)

    def body(c):
        u, w_l, event_t, event_count = (c["u"], c["w_l"], c["event_t"],
                                        c["event_count"])
        active = ~c["done"]
        idx = torch.where(active, c["idx"], 0)
        t = t0 + idx.to(dtype) * h_res
        # quantize the proposed dt to whole dyadic cells; doubling needs an
        # even count so its half steps land on grid points
        want = (torch.minimum(c["dt"], t_total) / h_res).to(torch.int64)
        # below the floor no finer path exists at this depth: force-accept
        at_floor = want < min_cells
        m = want if use_pair else (want >> 1) << 1
        m = torch.minimum(torch.clamp(m, min=min_cells), n_total - idx)
        dt_step = m.to(dtype) * h_res

        # W(idx) is carried: it is last step's right end on accept and
        # unchanged on reject (the tree is a pure function of idx).  The
        # doubling estimator's midpoint descends the tree beside the right
        # end, in one batch.
        mh = m >> 1
        if use_pair:
            w_r = w_at(idx + m)
        else:
            w_r, w_m = w_at(torch.stack([idx + m, idx + mh]))
        dWf = w_r - w_l
        if use_pair:
            u_2, err = embedded(f, g, u, p, t, dt_step, dWf, noise)
        else:
            dt_half = mh.to(dtype) * h_res
            t_mid = t0 + (idx + mh).to(dtype) * h_res
            dW1, dW2 = w_m - w_l, w_r - w_m
            # one coarse step against two half steps on the same path; the
            # finer propagates, its error rescaled by 1/(2^q - 1)
            u_c = stepper(f, g, u, p, t, dt_step, dWf, noise)
            u_h = stepper(f, g, u, p, t, dt_half, dW1, noise)
            u_2 = stepper(f, g, u_h, p, t_mid, dt_half, dW2, noise)
            err = (u_2 - u_c) * richardson
        enorm = hairer_norm(err, u, u_2, atol, rtol, dim=0)
        if bounded_steps is not None:
            # pathwise discrete adjoint: the controller chain is primal
            # only (dt is consumed as an integer cell count anyway), and the
            # Hairer norm's sqrt stays out of the backward pass
            enorm = enorm.detach()
        finite = torch.isfinite(u_2).all(dim=0)
        accept = ((enorm <= 1.0) | at_floor) & finite & active
        dt_next, enorm_prev = pi_propose(ctrl, dt_step, enorm,
                                         c["enorm_prev"], accept)
        idx_new = torch.where(accept, idx + m, idx)
        t_new = t0 + idx_new.to(dtype) * h_res

        if event is not None:
            def interp_fn(theta):
                return linear_interp(u, u_2, theta, lanes=True)

            u_ev, t_ev, ev_t, ev_n, term = handle_event(
                event, interp_fn, u, u_2, p, t, dt_step, t_new, accept,
                event_t, event_count, lanes=True)
            # a non-terminal hit: the affected state lives at the event
            # time, so the lane resumes on the first grid point at or after
            # it (the tree replays W there exactly)
            hit_nt = (ev_n > event_count) & ~term
            cells = torch.minimum(torch.clamp(torch.ceil(
                (t_ev - t) / h_res - 1e-6).to(torch.int64), min=1), m)
            idx_new = torch.where(hit_nt, idx + cells, idx_new)
            t_new = t0 + idx_new.to(dtype) * h_res
            event_t, event_count = ev_t, ev_n
        else:
            u_ev, t_ev = u_2, t_new
            term = hit_nt = torch.zeros_like(accept)
        u_next = torch.where(accept[None], u_ev, u)
        # reported time: the event time of a terminal hit, else the grid
        t_out = torch.where(term, t_ev, torch.where(accept, t_new,
                                                    c["t_out"]))
        t_lim = torch.where(term, t_ev, t_new)

        # linear dense save on the accepted step, up to t_lim
        eps = 1e-7 * torch.clamp(t_lim.abs(), min=1.0)
        crossed = ((saveat[:, None] > t[None]) & (saveat[:, None]
                                                  <= (t_lim + eps)[None])
                   & accept[None])
        theta = torch.clamp((saveat[:, None] - t[None]) / dt_step[None],
                            0.0, 1.0)
        vals = u[None] + theta[:, None, :] * (u_2 - u)[None]
        us = torch.where(crossed[:, None, :], vals, c["us"])

        # rejecting at the resolution floor (only a non-finite state can)
        # or with dt pinned at the controller floor: the retry is
        # bit-identical, so the lane ends with a distinct status
        hopeless = active & ~accept & (at_floor | ~(dt_step > ctrl.dtmin))
        status = torch.where(hopeless, STATUS_DTMIN_EXHAUSTED, c["status"])
        done = c["done"] | term | (idx_new >= n_total) | hopeless
        w_l = torch.where(accept[None], w_r, w_l)
        if bool(hit_nt.any()):
            # re-anchored lanes restart mid-step: their left W is at idx_new
            w_l = torch.where(hit_nt[None], w_at(idx_new), w_l)
        return dict(
            us=us, w_l=w_l, idx=idx_new, u=u_next, dt=dt_next,
            enorm_prev=enorm_prev, done=done, t_out=t_out,
            naccept=c["naccept"] + accept.to(torch.int32),
            nreject=c["nreject"] + (active & ~accept).to(torch.int32),
            nf=c["nf"] + active.to(torch.int32) * nf_per_attempt,
            status=status, event_t=event_t, event_count=event_count,
            iters=c["iters"] + 1)

    c = solver_loop(
        lambda c: c["iters"] < max_iters and not bool(c["done"].all()),
        body, c0, bounded_steps=bounded_steps,
        checkpoint_every=checkpoint_every)
    status = torch.where(c["status"] > 0, c["status"],
                         torch.where(c["done"], 0, 1).to(torch.int32))
    res = SolveResult(ts=saveat, us=c["us"], t_final=c["t_out"],
                      u_final=c["u"], naccept=c["naccept"],
                      nreject=c["nreject"], status=status, nf=c["nf"])
    if event is not None:
        return res, dict(event_t=c["event_t"], event_count=c["event_count"])
    return res


def solve_sde_ensemble(eprob: EnsembleProblem, key, dt, n_steps=None,
                       method="em", ensemble="kernel", backend="torch",
                       save_every=1, t0=None, tf=None, seed=None,
                       device=None) -> "EnsembleSDEResult":
    """SDE-facing wrapper over the front door
    (`repro_torch.core.ensemble.solve_ensemble_local`), result adapted to
    the SDE-shaped tuple.  `key` is a reference PRNG key as an array (its
    last word is the seed), or pass `seed=`."""
    from .ensemble import solve_ensemble_local

    res = solve_ensemble_local(
        eprob, alg=method, ensemble=ensemble, backend=backend, t0=t0, tf=tf,
        dt0=dt, n_steps=n_steps, save_every=save_every, key=key, seed=seed,
        device=device)
    return EnsembleSDEResult(ts=res.ts, us=res.us, u_final=res.u_final,
                             nf=res.nf)


class EnsembleSDEResult(NamedTuple):
    ts: Any
    us: Any          # (N, S, n)
    u_final: Any     # (N, n)
    nf: Any
