"""Ensemble-solve launcher: ``python -m repro_torch.launch.solve --problem
lorenz --n 100000 --ensemble kernel``, the port's counterpart of
`repro.launch.solve`.

With ``--mesh local`` the trajectory axis is sharded over the ranks of the
job (the MPI composition of §6.3), e.g. ``torchrun --nproc_per_node=2 -m
repro_torch.launch.solve --mesh local``: NCCL where each rank has a card
of its own, gloo otherwise (``--dist-backend``).  With ``--work-queue``
the Lorenz sweep is over-decomposed into tiles of ``8 * --lane-tile``
trajectories leased from the straggler-tolerant
`repro_torch.dist.fault.WorkQueue` (stateless tiles, safe re-execution).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.de_problems import (crn_problem, gbm_problem,
                                             lorenz_ensemble)
from repro_torch.core import EnsembleProblem
from repro_torch.core.api import ensemble_moments, solve_ensemble


def _backend(name: str) -> str:
    if name != "auto":
        return name
    import os
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return ("nccl" if torch.cuda.is_available()
            and torch.cuda.device_count() >= world else "gloo")


def _work_queue_lorenz(ep, n: int, tile: int, kw) -> np.ndarray:
    """Solve the ensemble tile by tile, each tile leased from a `WorkQueue`
    (straggler-tolerant: an expired lease is re-claimed and re-solved,
    which a stateless tile makes safe).  Returns u_final (n, 3) on the
    host."""
    from repro_torch.dist.fault import WorkQueue
    q = WorkQueue(n, tile=tile)
    u0s, ps = ep.materialize()
    outs = np.zeros((n, 3), np.float32)
    while not q.finished:
        claim = q.claim()
        if claim is None:
            break
        idx, (start, stop), tok = claim
        sub = EnsembleProblem(ep.prob, stop - start, u0s=u0s[start:stop],
                              ps=ps[start:stop])
        res = solve_ensemble(sub, None, **kw)
        outs[start:stop] = res.u_final.detach().cpu().numpy()
        q.complete(idx, tok)
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="lorenz",
                    choices=["lorenz", "gbm", "crn"])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--ensemble", default="kernel",
                    choices=["kernel", "vmap", "array", "auto"])
    ap.add_argument("--backend", default="torch", choices=["torch", "cuda"])
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--lane-tile", type=int, default=1024)
    ap.add_argument("--mesh", default="none", choices=["none", "local"])
    ap.add_argument("--dist-backend", default="auto",
                    choices=["auto", "nccl", "gloo"])
    ap.add_argument("--work-queue", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the solve runs (default: the card)")
    args = ap.parse_args(argv)

    group, rank = None, 0
    if args.mesh == "local":
        from repro_torch.launch.mesh import make_local_group
        group = make_local_group(_backend(args.dist_backend))
        rank = torch.distributed.get_rank(group)

    t0 = time.perf_counter()
    if args.problem == "lorenz":
        ep = lorenz_ensemble(args.n, dtype=torch.float32)
        kw = dict(ensemble=args.ensemble, backend=args.backend,
                  adaptive=args.adaptive, dt0=args.dt, t0=0.0, tf=1.0,
                  lane_tile=args.lane_tile, device=args.device)
        if args.adaptive:
            kw["saveat"] = [1.0]
        else:
            kw.update(n_steps=int(round(1.0 / args.dt)),
                      save_every=int(round(1.0 / args.dt)))
        if args.work_queue:
            u_final = _work_queue_lorenz(ep, args.n, args.lane_tile * 8, kw)
        else:
            res = solve_ensemble(ep, group, **kw)
            u_final = res.u_final.detach().cpu().numpy()
        dt = time.perf_counter() - t0
        if rank == 0:
            print(f"{args.n:,} trajectories in {dt:.2f}s "
                  f"({args.n / dt:,.0f} traj/s)  "
                  f"mean |u_f| = {np.abs(u_final).mean():.4f}")
    else:
        prob = gbm_problem() if args.problem == "gbm" else crn_problem(
            tspan=(0.0, 10.0))
        ep = EnsembleProblem(prob, args.n)
        n_steps = int(round(prob.tspan[1] / args.dt))
        res = solve_ensemble(ep, group, alg="em", ensemble="kernel",
                             backend=args.backend, dt0=args.dt,
                             n_steps=n_steps, save_every=n_steps, seed=0,
                             device=args.device)
        us = res.u_final
        if group is not None:
            n_local = args.n // torch.distributed.get_world_size(group)
            us = us[rank * n_local:(rank + 1) * n_local]
        mean, var = ensemble_moments(us, group)
        dt = time.perf_counter() - t0
        if rank == 0:
            print(f"{args.n:,} SDE paths in {dt:.2f}s  E[X_T] = "
                  f"{mean.cpu().numpy()}  Var = {var.cpu().numpy()}")
    if group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
