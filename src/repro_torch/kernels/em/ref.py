"""Plain PyTorch oracles for the SDE kernels: lanes-mode loops over the whole
ensemble using the SAME stepper definitions and the SAME counter RNG
(`repro_torch.kernels.rng`), so comparison with a kernel is pathwise, not
just statistical — the port of `repro.kernels.em.ref`, plus the plain
version of the adaptive kernel.  ``remat=True`` runs the fixed-dt step loop
through `repro_torch.core.loops.checkpointed_fori` (reverse mode)."""
from __future__ import annotations

import torch

from repro_torch.core.events import without_log
from repro_torch.core.loops import checkpointed_fori
from repro_torch.core.sde import (SDE_EMBEDDED, SDE_STEPPERS,
                                  sde_event_state0, sde_nf_per_step,
                                  sde_solve_adaptive, sde_step_and_save,
                                  sde_step_save_event)
from repro_torch.kernels.rng import M32, counter_normals_threefry


def solve_lanes(f, g, noise: str, m_noise: int, method: str, u0, p, *, t0,
                dt, n_steps: int, save_every: int = 1, seed: int = 0,
                noise_table=None, lane_offset: int = 0, event=None,
                remat: bool = False, checkpoint_every=None):
    """u0 (n, N), p (k, N) lane-major; noise_table (n_steps, m, N) or None
    for the Threefry stream over GLOBAL lane indices (local index +
    lane_offset, mod 2^32).  Returns us (S, n, N), u_final (n, N) and the
    event state of `sde_event_state0` (None without an event).

    ``remat=True`` runs the identical step sequence through
    `checkpointed_fori` (``checkpoint_every`` steps per segment, default
    sqrt(n_steps)), collecting the snapshots out of place: the primal is
    bitwise the same, and the backward pass keeps one carry per segment and
    replays the counter-RNG noise inside segments."""
    stepper = SDE_STEPPERS[method]
    n, N = u0.shape
    dtype, dev = u0.dtype, u0.device
    S = n_steps // save_every
    gl = (torch.arange(N, dtype=torch.int64, device=dev) + lane_offset) & M32
    lane = gl[None].expand(m_noise, N)
    rows = torch.arange(m_noise, dtype=torch.int64,
                        device=dev)[:, None].expand(m_noise, N)
    estate = (sde_event_state0((N,), t0, dtype, dev) if event is not None
              else None)

    def step(k, u, us, estate):
        if noise_table is not None:
            z = noise_table[k].to(dtype)
        else:
            z = counter_normals_threefry(seed, k, lane, rows, dtype)
        if event is None:
            u, us = sde_step_and_save(stepper, f, g, noise, u, us, p, t0, dt,
                                      k, z, save_every)
            return u, us, None
        return sde_step_save_event(stepper, f, g, noise, event, u, us,
                                   estate, p, t0, dt, k, z, save_every)

    if remat:
        def body(k, carry):
            u, estate, snaps = carry
            u, _, estate = step(k, u, None, estate)
            if (k + 1) % save_every == 0:
                snaps = snaps + (u,)
            return u, estate, snaps

        u, estate, snaps = checkpointed_fori(
            0, n_steps, body, (u0, estate, ()),
            checkpoint_every=checkpoint_every)
        return torch.stack(snaps), u, estate
    us = torch.zeros((S, n, N), dtype=dtype, device=dev)
    u = u0
    for k in range(n_steps):
        u, us, estate = step(k, u, us, estate)
    return us, u, estate


def ref_solve(prob, u0s, ps, *, t0, dt, n_steps, method="em", save_every=1,
              seed=0, noise_table=None, lane_offset=0, event=None,
              remat=False, checkpoint_every=None):
    """u0s (N, n), ps (N, m) trajectory-major.  Replays the kernel's exact
    noise stream or a supplied (n_steps, m, N) table; ``remat`` as in
    `solve_lanes`.  Returns (us (S, n, N), uf (n, N), event state or
    None)."""
    return solve_lanes(prob.f, prob.g, prob.noise, prob.noise_dim(), method,
                       u0s.T, ps.T, t0=t0, dt=dt, n_steps=n_steps,
                       save_every=save_every, seed=seed,
                       noise_table=noise_table, lane_offset=lane_offset,
                       event=event, remat=remat,
                       checkpoint_every=checkpoint_every)


def solve_adaptive_lanes(f, g, method: str, u0, p, saveat, *, noise: str,
                         m_noise: int, t0, tf, dt0, rtol, atol,
                         max_iters: int, seed: int, depth: int, order: float,
                         error_est: str, est_order: int, nf_per_attempt: int,
                         lane_offset: int = 0, event=None):
    """The plain version of the adaptive kernel: `sde_solve_adaptive` in
    lanes mode over u0 (n, N), p (k, N), with the GLOBAL lane indices
    lane_offset + arange(N) mod 2^32.  Returns us (S, n, N), u_final
    (n, N), t_final (N,) and stats (6, N) int32 with rows (naccept,
    nreject, status, nf, 0, 0), as the reference's body stacks them."""
    N = u0.shape[1]
    lanes = (torch.arange(N, dtype=torch.int64, device=u0.device)
             + lane_offset) & M32
    pair = SDE_EMBEDDED[method].fn if error_est == "embedded" else None
    res = without_log(sde_solve_adaptive(
        f, g, SDE_STEPPERS[method], noise, u0, p, t0, tf, dt0, seed=seed,
        lane_idx=lanes, m_noise=m_noise, saveat=saveat, rtol=rtol, atol=atol,
        max_iters=max_iters, lanes=True, depth=depth, order=order,
        nf_per_step=sde_nf_per_step(method), error_est=error_est,
        embedded=pair, est_order=est_order, nf_per_attempt=nf_per_attempt,
        event=event), event)
    zero = torch.zeros_like(res.naccept)
    stats = torch.stack([res.naccept, res.nreject, res.status, res.nf, zero,
                         zero])
    return res.us, res.u_final, res.t_final, stats
