"""Quickstart on the PyTorch port: the paper's headline workflow through
the port's front door, the twin of examples/quickstart.py.

Define a DE once in component-style PyTorch; `solve_ensemble_local`
dispatches a registered method (explicit RK such as "tsit5", the stiff
"rosenbrock23", SDE steppers such as "em") through an execution strategy
(``ensemble="array" | "vmap" | "kernel"``) and backend (``backend="torch"``,
the lanes twin, or ``"cuda"``, the hand-written kernels).  The Lorenz
system and the Van der Pol oscillator below are defined inline, as the
reference's quickstart defines them, and registered nowhere: on
``backend="cuda"`` the automated translation (`repro_torch.translate`)
traces each into a device functor and compiles the kernel for it at
first use (seconds; the library is kept under ``build/repro_torch/gen/``):

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--n 1024]

On a CUDA device (the default) ``backend="cuda"`` launches the kernels; with
``--device cpu`` it runs their plain versions.  ``ensemble="auto"`` tunes
once and caches the winner (`repro_torch.core.autotune`).  The serving
section drives `repro_torch.serve.EnsembleService` (continuous batching
over resumable slots) on a background thread.
"""
import argparse
import math
import time

import torch

from repro_torch.configs import de_problems as dp
from repro_torch.core import (EnsembleProblem, Event, ODEProblem,
                              SDEProblem, solve_ensemble_local)
from repro_torch.core.sensitivity import (ensemble_value_and_grad,
                                          suggest_adjoint_steps)


def lorenz(u, p, t):
    s, r, b = p[0], p[1], p[2]
    return torch.stack([s * (u[1] - u[0]),
                        r * u[0] - u[1] - u[0] * u[2],
                        u[0] * u[1] - b * u[2]])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev, N = args.device, args.n
    f32, f64 = torch.float32, torch.float64

    # --- ODE: a Lorenz parameter ensemble three ways -------------------------
    prob = ODEProblem(lorenz, torch.tensor([1.0, 0.0, 0.0], dtype=f32),
                      torch.tensor([10.0, 21.0, 8 / 3], dtype=f32),
                      (0.0, 1.0))
    rho = torch.linspace(0.0, 21.0, N, dtype=f32)
    ps = torch.stack([torch.full((N,), 10.0), rho,
                      torch.full((N,), 8 / 3)], dim=1)
    ens = EnsembleProblem(prob, N, ps=ps)
    saveat = torch.linspace(0.0, 1.0, 11, dtype=f32)
    for strategy, backend in (("array", "torch"), ("vmap", "torch"),
                              ("kernel", "cuda")):
        t0 = time.perf_counter()
        res = solve_ensemble_local(ens, alg="tsit5", ensemble=strategy,
                                   backend=backend, t0=0.0, tf=1.0,
                                   dt0=1e-3, saveat=saveat, rtol=1e-6,
                                   atol=1e-6, device=dev)
        _sync(dev)
        print(f"{strategy:>7}/{backend}: {time.perf_counter() - t0:7.2f}s   "
              f"RHS evals = {int(res.nf):>10,}   "
              f"u_final[-1] = {res.u_final[-1].tolist()}")
    print("\nSame physics, same answers — the kernel strategy steps every "
          "trajectory\nwith its own dt (paper §5.2), the array strategy "
          "lock-steps the ensemble (§5.1).")

    # --- or let the autotuner pick: ensemble="auto" ---------------------------
    # First sight of a configuration times the pruned candidates (vmap, array,
    # kernel/torch over a lane_tile ladder, kernel/cuda) on a reduced copy of
    # this problem and keeps the winner in ~/.cache/repro/autotune.json
    # (REPRO_AUTOTUNE_CACHE overrides; REPRO_AUTOTUNE=0 disables): later
    # solves are a dictionary lookup, bitwise the explicit winner's
    t0 = time.perf_counter()
    res = solve_ensemble_local(ens, alg="tsit5", ensemble="auto", t0=0.0,
                               tf=1.0, dt0=1e-3, saveat=saveat, rtol=1e-6,
                               atol=1e-6, device=dev)
    _sync(dev)
    print(f"   auto: {time.perf_counter() - t0:7.2f}s  (first-sight tuning "
          f"included; cached for next time)   u_final[-1] = "
          f"{res.u_final[-1].tolist()}")

    # --- stiff family, same front door: W = I - γh·J by per-lane LU ----------
    # the Jacobian the kernel factors is derived from the traced RHS
    vdp = ODEProblem(lambda u, p, t: torch.stack(
        [u[1], p[0] * ((1.0 - u[0] ** 2) * u[1]) - u[0]]),
        torch.tensor([2.0, 0.0], dtype=f64), torch.tensor([10.0], dtype=f64),
        (0.0, 1.0))
    mus = torch.linspace(5.0, 20.0, 64, dtype=f64)
    stiff = EnsembleProblem(vdp, 64, ps=mus[:, None])
    res = solve_ensemble_local(stiff, alg="rosenbrock23", ensemble="kernel",
                               backend="cuda", t0=0.0, tf=1.0, dt0=1e-3,
                               rtol=1e-6, atol=1e-6, device=dev)
    print(f"\nrosenbrock23 kernel: {int(res.naccept.sum()):,} accepted "
          f"steps, u_final[0] = {res.u_final[0].tolist()}")

    # --- SDE family: counter-RNG Euler-Maruyama -------------------------------
    gbm = EnsembleProblem(SDEProblem(
        lambda u, p, t: p[0] * u, lambda u, p, t: p[1] * u,
        torch.full((3,), 0.1, dtype=f32), torch.tensor([1.5, 0.1], dtype=f32),
        (0.0, 1.0)), N)
    res = solve_ensemble_local(gbm, alg="em", ensemble="kernel",
                               backend="cuda", t0=0.0, dt0=1e-3,
                               n_steps=1000, save_every=1000, seed=7,
                               device=dev)
    print(f"em kernel: E[X(1)] = {float(res.u_final[:, 0].mean()):.4f} "
          f"(exact {0.1 * math.exp(1.5):.4f})")

    # --- SDE with events and adaptive dt ---------------------------------------
    # Each path integrates with its own error-controlled dt on the virtual
    # Brownian tree and ends where it crosses the barrier; t_final is the
    # located hitting time.  em's embedded pair is the default estimator;
    # error_est="doubling" runs step doubling for comparison.
    hit_ens = EnsembleProblem(dp.gbm_problem(r=1.5, v=0.2, dtype=f64),
                              min(N, 512))
    kw = dict(alg="em", ensemble="kernel", backend="cuda", t0=0.0, tf=1.0,
              dt0=0.02, adaptive=True, rtol=1e-3, atol=1e-5, seed=7,
              event=dp.gbm_barrier_event(),
              saveat=torch.linspace(0.1, 1.0, 10, dtype=f64), device=dev)
    res = solve_ensemble_local(hit_ens, **kw)
    res_dbl = solve_ensemble_local(hit_ens, error_est="doubling", **kw)
    hit = res.t_final < 1.0
    t_hit = float(torch.where(hit, res.t_final, 0).sum()
                  / hit.sum().clamp_min(1))
    print(f"\nadaptive em + barrier event: {int(hit.sum())}/"
          f"{hit_ens.n_trajectories} paths hit X=0.18, mean hitting time "
          f"{t_hit:.3f},\n  per-path steps min/max = "
          f"{int(res.naccept.min())}/{int(res.naccept.max())}, drift evals: "
          f"embedded pair {int(res.nf)} vs step doubling {int(res_dbl.nf)}")

    # --- events on an ODE: the decay's half point -----------------------------
    dec = EnsembleProblem(dp.linear_decay_problem(), 16,
                          ps=torch.linspace(0.5, 2.0, 16,
                                            dtype=f64)[:, None])
    res = solve_ensemble_local(dec, alg="tsit5", ensemble="kernel",
                               backend="cuda", t0=0.0, tf=3.0, dt0=1e-3,
                               rtol=1e-9, atol=1e-9, saveat=[3.0],
                               event=dp.half_event(), device=dev)
    exact = math.log(2.0) / 0.5
    print(f"decay half point: t_final[0] = {float(res.t_final[0]):.9f} "
          f"(ln 2 / lam = {exact:.9f})")

    # --- data-driven DEs: a lookup table through the same front door ----------
    # The forced oscillator's drive term is a measured curve: a 65-knot
    # UniformTable1D in `prob.data` (paper §6.7).  The lanes strategies close
    # the RHS over the table; the CUDA kernel reads it on the card through
    # the registered data functor, every lookup exact (no hardware texture
    # filtering).
    fprob = dp.forced_oscillator_problem()
    M = min(N, 256)
    amps = torch.linspace(0.5, 1.5, M, dtype=f64)
    fens = EnsembleProblem(fprob, M, u0s=fprob.u0[None] * amps[:, None])
    fres = solve_ensemble_local(fens, alg="tsit5", ensemble="kernel",
                                backend="cuda",
                                saveat=torch.linspace(0.0, 5.0, 6,
                                                      dtype=f64),
                                dt0=1e-2, rtol=1e-7, atol=1e-7, device=dev)
    print(f"\nforced oscillator from a 65-knot force table (kernel/cuda):\n"
          f"  u_final[0] = {fres.u_final[0].tolist()}")
    ev = Event(condition=dp.osc_level_condition, direction=1, terminal=True)
    lvl = EnsembleProblem(fprob, 4, u0s=torch.tensor([[0.0, 2.0]], dtype=f64)
                          * torch.linspace(0.8, 1.2, 4, dtype=f64)[:, None],
                          ps=torch.tensor([[1.0, 0.0]], dtype=f64).expand(
                              4, 2))
    lres = solve_ensemble_local(lvl, alg="tsit5", ensemble="kernel",
                                backend="cuda", dt0=1e-2, rtol=1e-8,
                                atol=1e-8, saveat=[5.0], event=ev,
                                device=dev)
    print(f"  the undamped oscillator reaches x = 1.5 at t = "
          f"{[round(float(t), 6) for t in lres.t_final]}")

    # --- gradients through the kernel: the adjoint (paper §6.6) ---------------
    # sensitivity="adjoint" runs the forward solve on the kernel and, in the
    # backward pass, replays its plain version in checkpointed segments
    # (kernel_adjoint); adaptive stepping needs a bound on the attempts
    gens = dp.lorenz_ensemble(min(N, 64), dtype=f64)
    gkw = dict(alg="tsit5", ensemble="kernel", backend="cuda", t0=0.0,
               tf=1.0, dt0=1e-3, rtol=1e-8, atol=1e-8,
               saveat=torch.linspace(0.25, 1.0, 4, dtype=f64), device=dev)
    bound = suggest_adjoint_steps(gens, **gkw)
    loss, (g_u0, g_p) = ensemble_value_and_grad(
        lambda r: (r.u_final ** 2).sum(), gens, adjoint_steps=bound, **gkw)
    print(f"\nadjoint through the kernel ({bound} bounded attempts): "
          f"L = {float(loss):.6e}, dL/drho[-1] = {float(g_p[-1, 1]):.6e}, "
          f"dL/du0[-1] = {[round(float(v), 6) for v in g_u0[-1]]}")

    # --- serving: async submit/poll with continuous batching ----------------
    # Production traffic is many small heterogeneous requests, not one blob.
    # EnsembleService keeps one slot pool running: finished lanes retire
    # early and are refilled from the queue, and every served result is
    # bitwise a fresh solve_ensemble_local of that request (kernel/torch)
    from repro_torch.serve import EnsembleService
    svc = EnsembleService(slot_width=8, segment_steps=64, device=dev)
    svc.start()                              # pump loop on a background thread
    sigma, beta = 10.0, 8.0 / 3.0
    sprob = ODEProblem(lorenz, torch.tensor([1.0, 0.0, 0.0], dtype=f64),
                       torch.tensor([sigma, 21.0, beta], dtype=f64),
                       (0.0, 2.0))
    tickets = []
    for tf in (0.5, 1.0, 2.0):               # three tenants, three horizons
        rhos = torch.linspace(19.0, 24.0, 4, dtype=f64)
        sps = torch.stack([torch.full((4,), sigma, dtype=f64), rhos,
                           torch.full((4,), beta, dtype=f64)], 1)
        tickets.append(svc.submit(EnsembleProblem(sprob, 4, ps=sps),
                                  alg="tsit5", tf=tf, dt0=1e-2,
                                  tenant=f"tenant-{tf}"))
    for tk in tickets:
        tk.wait(timeout=120.0)               # or poll tk.done, non-blocking
    svc.stop()
    print("\nserved 3 async requests through one continuously-batched "
          "slot pool:")
    for tk, tf in zip(tickets, (0.5, 1.0, 2.0)):
        print(f"  tf={tf}: status={tk.result.status} nf={tk.result.nf} "
              f"latency={tk.latency:.3f}s")
    print(f"  per-tenant accounting: "
          f"{ {t: a['nf'] for t, a in svc.accounting.items()} }")
    return fres


if __name__ == "__main__":
    main()
