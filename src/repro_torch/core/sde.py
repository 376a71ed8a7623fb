"""SDE steppers (paper §3.2, §5.2.2, §6.8): fixed-dt, kernel-shaped — the
fixed-dt half of `repro.core.sde`, in PyTorch.

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

The adaptive driver, the embedded pairs, events and the resumable bodies
are still to port (ROADMAP queue 1 items 6, 7 and 13).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .problem import EnsembleProblem, SDEProblem
from .solvers import SolveResult

Tensor = torch.Tensor


def _sqrt_dt(dt, dtype):
    return torch.sqrt(torch.as_tensor(dt, dtype=dtype))


def apply_noise(g_val, dW, noise: str):
    """g(u)·dW with g_val (n,[B]) diagonal or (n,m,[B]) general; dW (m,[B])."""
    if noise == "diagonal":
        return g_val * dW
    # general: contract the noise axis (axis 1 of g_val)
    return torch.einsum("nm...,m...->n...", g_val, dW)


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
    step k fills slot (k+1)/save_every - 1 when save_every divides k+1."""
    if (k + 1) % save_every == 0:
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


def sde_solve_fixed(prob: SDEProblem, u0, p, t0, dt, n_steps: int, key,
                    method: str = "em", save_every: int = 1,
                    noise_table: Optional[Tensor] = None) -> SolveResult:
    """Fixed-dt SDE integration of one trajectory (n,) or lanes (n, B),
    noise from `noise_table` (n_steps, m[, B]) of N(0,1) draws.

    The reference's ``key=`` path draws step k from
    ``jax.random.fold_in(key, k)``, a generator the port does not carry; it
    raises here.  The counter-RNG stream of the ensemble paths
    (`solve_ensemble_local(seed=...)`) is ported.  As in the reference, t
    is accumulated step by step here (t_final = t0 + dt + ... + dt)."""
    if noise_table is None:
        raise NotImplementedError(
            "sde_solve_fixed(key=...) draws from jax.random.fold_in, which "
            "the port does not carry (ROADMAP queue 3); pass noise_table=, "
            "or use solve_ensemble_local(seed=...) for the counter-RNG "
            "stream")
    if n_steps % save_every != 0:
        raise ValueError(f"save_every={save_every} must divide "
                         f"n_steps={n_steps}")
    S = n_steps // save_every
    stepper = SDE_STEPPERS[method]
    dtype = u0.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=u0.device)
    sdt = _sqrt_dt(dt, dtype)
    table = torch.as_tensor(noise_table, device=u0.device)
    u = u0
    t = torch.as_tensor(t0, dtype=dtype, device=u0.device)
    us = []
    for k in range(n_steps):
        z = table[k].to(dtype)
        u = stepper(prob.f, prob.g, u, p, t, dt, z * sdt, prob.noise)
        t = t + dt
        if (k + 1) % save_every == 0:
            us.append(u)
    ts = (torch.as_tensor(t0, dtype=dtype, device=u0.device)
          + dt * save_every * torch.arange(1, S + 1, dtype=dtype,
                                           device=u0.device))
    i64 = lambda v: torch.tensor(v, device=u0.device)
    return SolveResult(ts=ts, us=torch.stack(us), t_final=t, u_final=u,
                       naccept=i64(n_steps), nreject=i64(0), status=i64(0),
                       nf=i64(n_steps * (2 if method != "em" else 1)))


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
