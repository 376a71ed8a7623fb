"""Public wrappers for the SDE ensemble kernels — the counterpart of
`repro.kernels.em.ops`, and of the reference front door's inline launch of
the adaptive kernel.

Each binds the problem, the seed and the lane offset into the kernel's
parameters (`sde_body`, `sde_adaptive_body`) and hands the launch to the
generic layer (`run_ensemble_kernel`), with the optional noise table as a
"lanes" extra (fixed dt) or the saveat grid as a "broadcast" extra
(adaptive); CUDA tensors launch the kernel, CPU tensors run its plain
version.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sde import EnsembleSDEResult, sde_save_grid
from repro_torch.kernels.ensemble_kernel import (data_extras,
                                                 run_ensemble_kernel,
                                                 sde_adaptive_body, sde_body)


def seed_from_key(key) -> int:
    """The reference's seed of a PRNG key given as an array: its last word."""
    return int(np.asarray(key).reshape(-1)[-1])


def solve_sde_ensemble_kernel(prob, u0s, ps, *, t0, dt, n_steps,
                              method="em", save_every=1, seed=0,
                              noise_table=None, lane_offset=0, event=None,
                              data=None):
    """Unified-result SDE kernel entry (returns an EnsembleResult).

    u0s (N, n), ps (N, k) trajectory-major on one device; noise_table
    (n_steps, m, N) of N(0,1) draws in u0s's dtype, or None for the
    Threefry stream.  lane_offset shifts the counter-RNG lane indices to
    this shard's GLOBAL trajectory indices.  With a dataset (`data`), f and
    g take it as a fourth argument."""
    body = sde_body(prob.f, prob.g, method, prob.noise, t0=float(t0),
                    dt=float(dt), n_steps=int(n_steps),
                    save_every=int(save_every), m_noise=prob.noise_dim(),
                    seed=int(seed), lane_offset=int(lane_offset),
                    use_table=noise_table is not None, event=event,
                    data=data)
    ts = sde_save_grid(t0, dt, n_steps, save_every, u0s.dtype,
                       device=u0s.device)
    extras = [("lanes", noise_table)] if noise_table is not None else []
    return run_ensemble_kernel(body, u0s, ps, ts=ts,
                               extras=extras + data_extras(data))


def solve_sde_adaptive_kernel(prob, u0s, ps, saveat, *, method, t0, tf,
                              dt0, rtol, atol, max_iters, seed, depth, order,
                              error_est, est_order, nf_per_attempt,
                              lane_offset=0, event=None, data=None):
    """Unified-result adaptive SDE kernel entry (returns an EnsembleResult):
    u0s (N, n), ps (N, k) trajectory-major on one device, saveat (S,) in
    u0s's dtype.  One launch of the adaptive kernel over the ensemble; with
    a dataset (`data`), f and g take it as a fourth argument."""
    body = sde_adaptive_body(
        prob.f, prob.g, method, prob.noise, t0=float(t0), tf=float(tf),
        dt0=float(dt0), rtol=float(rtol), atol=float(atol),
        max_iters=int(max_iters), m_noise=prob.noise_dim(), seed=int(seed),
        depth=int(depth), order=float(order), error_est=error_est,
        est_order=int(est_order), nf_per_attempt=int(nf_per_attempt),
        lane_offset=int(lane_offset), event=event, data=data)
    return run_ensemble_kernel(body, u0s, ps, ts=saveat,
                               extras=[("broadcast", saveat)]
                               + data_extras(data))


def solve_sde_ensemble_cuda(prob, u0s, ps, key, t0, dt, n_steps,
                            method="em", save_every=1, seed=None,
                            noise_table=None) -> EnsembleSDEResult:
    """SDE-shaped entry point, the counterpart of the reference's
    `solve_sde_ensemble_pallas`: `seed=None` takes the key's last word."""
    if seed is None:
        seed = seed_from_key(key) if key is not None else 0
    res = solve_sde_ensemble_kernel(
        prob, u0s, ps, t0=t0, dt=dt, n_steps=n_steps, method=method,
        save_every=save_every, seed=seed, noise_table=noise_table)
    return EnsembleSDEResult(ts=res.ts, us=res.us, u_final=res.u_final,
                             nf=res.nf)
