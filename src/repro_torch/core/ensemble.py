"""Ensemble execution strategies (paper §5) on a single device — the erk,
rosenbrock and fixed-dt sde families of `repro.core.ensemble`, in PyTorch.

`solve_ensemble_local` is the front door.  Strategies (``ensemble=``):

  "array"       EnsembleGPUArray semantics (§5.1): the whole ensemble is ONE
                state matrix stepped in lock-step with a single global dt
                chosen by an ensemble-wide error norm.
  "array_eager" As above, stepped from Python with scalar control on the
                host: every tensor op is its own dispatch and every step a
                host-device synchronisation.
  "vmap"        The per-trajectory baseline: JAX's vmap of a while loop
                lowers to masked lock-step iteration over the whole batch
                with per-trajectory dt, and that is what runs here (the
                lanes engine over all N at once; every trajectory pays the
                steps of the slowest).
  "kernel"      The paper's contribution (§5.2): the whole integration fused
                per trajectory.
                backend="torch" — the lanes engine in PyTorch ops, one tile
                                  of `lane_tile` trajectories at a time
                                  (default: one tile of all N).
                backend="cuda"  — the hand-written CUDA kernel
                                  (`repro_torch.kernels.tsit5`), one thread
                                  per trajectory.  On CPU tensors it runs
                                  its plain twin.

The rosenbrock family (stiff, paper §5.1.3) runs the lanes engine
`repro_torch.core.rosenbrock` with per-lane step control on every
strategy: "vmap" over the whole batch with the library LU, "array" as one
tile and "kernel"/"torch" in tiles, both with the chosen ``linsolve``, and
"kernel"/"cuda" as the fused CUDA kernel (`repro_torch.kernels.rosenbrock`)
with the lanes LU inline.

The sde family (fixed dt, the paper's counter-RNG kernels, §5.2.2) runs
"vmap" (`torch.func.vmap` of the per-trajectory loop), "array" and
"kernel"/"torch" (the lanes loop over the whole ensemble) and
"kernel"/"cuda" (`repro_torch.kernels.em`).  Every strategy draws the same
(seed; step, row, GLOBAL lane) Threefry stream, so their paths agree.

Entry points run on the card: ``device=None`` means ``"cuda"``, and a
machine without CUDA raises unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .controller import PIController, initial_dt
from .methods import MethodSpec, get_method
from .problem import EnsembleProblem, ODEProblem, SDEProblem
from .solvers import (AdaptiveOptions, interp_step, rk_step, solve_adaptive,
                      solve_fixed)

Tensor = torch.Tensor


class EnsembleResult(NamedTuple):
    ts: Tensor        # (S,)
    us: Tensor        # (N, S, n)
    u_final: Tensor   # (N, n)
    t_final: Tensor   # (N,)
    naccept: Tensor   # per-trajectory, or one count for lock-step strategies
    nreject: Tensor
    nf: Tensor        # total RHS evaluations
    status: Tensor
    njac: Any = 0
    nfact: Any = 0


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; asking for CUDA without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev


def _pad_to(x, n_target):
    """Edge-pad the leading (trajectory) axis to n_target rows."""
    pad = n_target - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])


def _tile_lanes(u0s, ps, lane_tile):
    """(N, k)-major tensors -> (T, B, k) tiles for the torch lanes path;
    ``lane_tile=None`` is one tile of the whole ensemble."""
    N = u0s.shape[0]
    B = N if lane_tile is None else max(1, min(int(lane_tile), N))
    T = -(-N // B)
    u0p = _pad_to(u0s, T * B).reshape(T, B, u0s.shape[1])
    psp = _pad_to(ps, T * B).reshape(T, B, ps.shape[1])
    return u0p, psp, T, B


def _untile(tiles, N, n):
    """Invert _tile_lanes on the lanes-mode SolveResults of the tiles."""
    lanes = lambda name: torch.cat([getattr(r, name) for r in tiles], dim=-1)

    def total(name):
        # per-lane work counters -> total over the real lanes; the erk
        # engine leaves njac/nfact at 0
        if not torch.is_tensor(getattr(tiles[0], name)):
            return 0
        return lanes(name)[:N].sum()

    return EnsembleResult(
        ts=tiles[0].ts, us=lanes("us")[..., :N].permute(2, 0, 1),
        u_final=lanes("u_final")[:, :N].T,
        t_final=lanes("t_final")[:N],
        naccept=lanes("naccept")[:N], nreject=lanes("nreject")[:N],
        nf=lanes("nf")[:N].sum(), status=lanes("status").max(),
        njac=total("njac"), nfact=total("nfact"))


# ----------------------------------------------------------------------------
# strategy: vmap (the per-trajectory baseline the paper beats)
# ----------------------------------------------------------------------------

def solve_vmap(prob: ODEProblem, u0s, ps, tab, t0, tf, dt0, saveat,
               rtol, atol, adaptive, max_iters) -> EnsembleResult:
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive)
    res = solve_adaptive(prob.f, tab, u0s.T, ps.T, t0, tf, dt0,
                         saveat=saveat, opts=opts, lanes=True)
    return EnsembleResult(ts=saveat, us=res.us.permute(2, 0, 1),
                          u_final=res.u_final.T, t_final=res.t_final,
                          naccept=res.naccept, nreject=res.nreject,
                          nf=res.nf.sum(), status=res.status.max())


# ----------------------------------------------------------------------------
# strategy: array (EnsembleGPUArray semantics: lock-step global dt)
# ----------------------------------------------------------------------------

def solve_array(prob: ODEProblem, u0s, ps, tab, t0, tf, dt0, saveat,
                rtol, atol, adaptive, max_iters) -> EnsembleResult:
    # (n, N) state with scalar control: ONE dt + an ensemble-wide norm
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive)
    res = solve_adaptive(prob.f, tab, u0s.T, ps.T, t0, tf, dt0,
                         saveat=saveat, opts=opts, lanes=False)
    N = u0s.shape[0]
    return EnsembleResult(
        ts=saveat, us=res.us.permute(2, 0, 1),           # (S,n,N)->(N,S,n)
        u_final=res.u_final.T, t_final=res.t_final.expand(N),
        naccept=res.naccept, nreject=res.nreject,
        nf=res.nf * N,  # every global step evaluates f for all N columns
        status=res.status)


def solve_array_eager(prob: ODEProblem, u0s, ps, tab, t0, tf, dt0, saveat,
                      rtol, atol, adaptive, max_steps=100_000) -> EnsembleResult:
    """Python-driven lock-step loop with per-op dispatch and host-side step
    control: the eager array-abstraction overhead the paper measures."""
    ctrl = PIController.for_order(tab.embedded_order)
    U, P = u0s.T, ps.T
    t, dt = float(t0), float(dt0)
    enorm_prev = 1.0
    saveat_np = saveat.cpu().numpy()
    S = len(saveat_np)
    us = torch.zeros((S,) + tuple(U.shape), dtype=U.dtype, device=U.device)
    sidx = 0
    naccept = nreject = 0
    while t < float(tf) - 1e-12 and (naccept + nreject) < max_steps:
        dt_step = min(dt, float(tf) - t)
        k1 = prob.f(U, P, t)
        U_new, err, ks = rk_step(prob.f, tab, U, P, t, dt_step, k1)
        if adaptive:
            scale = atol + torch.maximum(U.abs(), U_new.abs()) * rtol
            enorm = float(torch.sqrt(torch.mean((err / scale) ** 2)))
            accept = enorm <= 1.0
            e = max(enorm, 1e-10)
            if accept:
                fac = float(np.clip(ctrl.safety * e ** (-ctrl.beta1)
                                    * max(enorm_prev, 1e-10) ** ctrl.beta2,
                                    ctrl.qmin, ctrl.qmax))
                enorm_prev = e
            else:
                fac = float(np.clip(ctrl.safety * e ** (-ctrl.beta1),
                                    ctrl.qmin, 1.0))
            dt = dt_step * fac
        else:
            accept = True
        if accept:
            t_new = t + dt_step
            while sidx < S and saveat_np[sidx] <= t_new + 1e-12:
                theta = np.clip((saveat_np[sidx] - t) / dt_step, 0.0, 1.0)
                us[sidx] = interp_step(
                    prob.f, tab, U, U_new, ks, P, t, dt_step,
                    torch.tensor(theta, dtype=U.dtype, device=U.device))
                sidx += 1
            U = U_new
            t = t_new
            naccept += 1
        else:
            nreject += 1
    N = u0s.shape[0]
    i64 = lambda v: torch.tensor(v, device=U.device)
    return EnsembleResult(
        ts=saveat, us=us.permute(2, 0, 1), u_final=U.T,
        t_final=torch.full((N,), t, dtype=U.dtype, device=U.device),
        naccept=i64(naccept), nreject=i64(nreject),
        nf=i64((naccept + nreject) * tab.stages * N),
        status=i64(0 if t >= float(tf) - 1e-9 else 1))


# ----------------------------------------------------------------------------
# strategy: kernel (paper §5.2) — fused whole-integration per trajectory
# ----------------------------------------------------------------------------

def solve_kernel_torch(prob: ODEProblem, u0s, ps, tab, t0, tf, dt0, saveat,
                       rtol, atol, adaptive, max_iters,
                       lane_tile=None) -> EnsembleResult:
    """The fused-integration lanes path in PyTorch ops: trajectories are
    packed into (n, B) tiles and each tile runs its own loop to completion
    (per-lane dt/accept masks) — the control structure of the kernel, so
    this backend doubles as its oracle."""
    N, n = u0s.shape
    u0p, psp, T, B = _tile_lanes(u0s, ps, lane_tile)
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive)
    tiles = [solve_adaptive(prob.f, tab, u0p[i].T, psp[i].T, t0, tf, dt0,
                            saveat=saveat, opts=opts, lanes=True)
             for i in range(T)]
    return _untile(tiles, N, n)


def solve_kernel_fixed(prob: ODEProblem, u0s, ps, tab, t0, dt, n_steps,
                       save_every) -> EnsembleResult:
    """Fixed-dt fused path over (n, N) lanes: every step accepted, a
    snapshot every `save_every` steps."""
    N, n = u0s.shape
    res = solve_fixed(prob.f, tab, u0s.T, ps.T, t0, dt, n_steps, save_every)
    return EnsembleResult(
        ts=res.ts, us=res.us.permute(2, 0, 1), u_final=res.u_final.T,
        t_final=res.t_final.expand(N), naccept=res.naccept.expand(N),
        nreject=torch.zeros((N,), dtype=torch.int32, device=u0s.device),
        nf=res.nf * N, status=res.status)


# ----------------------------------------------------------------------------
# family dispatch: erk
# ----------------------------------------------------------------------------

def _solve_erk(spec: MethodSpec, prob, u0s, ps, *, ensemble, backend, t0, tf,
               dt0, saveat, rtol, atol, adaptive, n_steps, save_every,
               lane_tile, max_iters):
    tab = spec.tableau
    if adaptive is None:
        adaptive = True   # family default: embedded-error stepping
    if not spec.adaptive:
        adaptive = False  # e.g. rk4: no embedded error estimate
    explicit_saveat = saveat is not None
    if not adaptive and n_steps is None:
        n_steps = int(round((tf - t0) / dt0))
    dtype, device = u0s.dtype, u0s.device
    if saveat is None:
        if not adaptive and ensemble == "kernel":
            # the fixed-step kernel paths save on the save_every step grid
            if n_steps % save_every != 0:
                raise ValueError(
                    f"save_every={save_every} must divide n_steps={n_steps}")
            saveat = t0 + dt0 * save_every * torch.arange(
                1, n_steps // save_every + 1, dtype=torch.float64)
        else:
            saveat = [tf]
    saveat = torch.as_tensor(saveat, dtype=dtype, device=device)

    if ensemble == "vmap":
        return solve_vmap(prob, u0s, ps, tab, t0, tf, dt0, saveat, rtol, atol,
                          adaptive, max_iters)
    if ensemble == "array":
        return solve_array(prob, u0s, ps, tab, t0, tf, dt0, saveat, rtol,
                           atol, adaptive, max_iters)
    if ensemble == "array_eager":
        return solve_array_eager(prob, u0s, ps, tab, t0, tf, dt0, saveat,
                                 rtol, atol, adaptive)
    if ensemble == "kernel":
        if backend == "cuda":
            from repro_torch.kernels.tsit5 import ops as erk_ops
            return erk_ops.solve_ensemble_cuda(
                prob, u0s, ps, tab, t0, tf, dt0, saveat, rtol, atol,
                adaptive, max_iters=max_iters)
        if backend != "torch":
            raise ValueError(f"unknown backend {backend!r} "
                             "(use 'torch' or 'cuda')")
        if not adaptive and not explicit_saveat:
            return solve_kernel_fixed(prob, u0s, ps, tab, t0, dt0, n_steps,
                                      save_every)
        return solve_kernel_torch(prob, u0s, ps, tab, t0, tf, dt0, saveat,
                                  rtol, atol, adaptive, max_iters,
                                  lane_tile=lane_tile)
    raise ValueError(f"unknown ensemble strategy {ensemble!r}")


# ----------------------------------------------------------------------------
# family dispatch: rosenbrock (stiff, paper §5.1.3 + §7)
# ----------------------------------------------------------------------------

def _solve_rosenbrock(spec: MethodSpec, prob: ODEProblem, u0s, ps, *,
                      ensemble, backend, t0, tf, dt0, saveat, rtol, atol,
                      lane_tile, max_iters, linsolve, w_reuse):
    from .rosenbrock import LINSOLVES, solve_rosenbrock

    rtab = spec.rtableau
    if not spec.adaptive:
        # btilde == 0: no embedded error estimate, and the stiff engine has
        # no fixed-dt path
        raise ValueError(
            f"rosenbrock method {spec.name!r} has no embedded error weights "
            "(btilde == 0); the stiff engine requires an adaptive pair")
    if linsolve not in LINSOLVES:
        raise ValueError(f"unknown linsolve {linsolve!r}; have {LINSOLVES}")
    if w_reuse is None:
        w_reuse = spec.w_reuse
    jac = prob.jac
    saveat = torch.as_tensor([tf] if saveat is None else saveat,
                             dtype=u0s.dtype, device=u0s.device)
    N, n = u0s.shape
    kw = dict(rtol=rtol, atol=atol, saveat=saveat, max_iters=max_iters,
              jac=jac, w_reuse=w_reuse)

    if ensemble == "vmap":
        # the reference vmaps its per-trajectory solver, whose refresh
        # predicates are psum-reduced over the batch: the lanes engine over
        # the whole batch with the library LU computes the same
        res = solve_rosenbrock(prob.f, rtab, u0s.T, ps.T, t0, tf, dt0,
                               linsolve="torch", **kw)
        return _untile([res], N, n)
    if ensemble == "kernel" and backend == "cuda":
        from repro_torch.kernels.rosenbrock.ops import solve_rosenbrock_cuda
        return solve_rosenbrock_cuda(prob, u0s, ps, rtab, t0=t0, tf=tf,
                                     dt0=dt0, **kw)
    if ensemble == "kernel" and backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (use 'torch' or "
                         "'cuda')")
    if ensemble in ("array", "kernel"):
        # "array": the whole ensemble as one lanes tile.  A lock-step
        # scalar-dt Rosenbrock would need an (N·n)-sized Jacobian, so the
        # array strategy keeps one state matrix with per-lane control, as
        # the reference's does
        u0p, psp, T, _ = _tile_lanes(
            u0s, ps, None if ensemble == "array" else lane_tile)
        tiles = [solve_rosenbrock(prob.f, rtab, u0p[i].T, psp[i].T, t0, tf,
                                  dt0, linsolve=linsolve, **kw)
                 for i in range(T)]
        return _untile(tiles, N, n)
    raise NotImplementedError(
        f"rosenbrock methods do not support ensemble={ensemble!r} "
        "(use 'vmap', 'array' or 'kernel')")


# ----------------------------------------------------------------------------
# family dispatch: sde (fixed-dt counter-RNG steppers, paper §5.2.2)
# ----------------------------------------------------------------------------

def _solve_sde(spec: MethodSpec, prob: SDEProblem, u0s, ps, *, ensemble,
               backend, t0, tf, dt0, saveat, n_steps, save_every, key, seed,
               noise_table, adaptive, lane_offset) -> EnsembleResult:
    from repro_torch.kernels.em.ops import (seed_from_key,
                                            solve_sde_ensemble_kernel)
    from repro_torch.kernels.em.ref import ref_solve
    from repro_torch.kernels.rng import check_u32
    from .sde import SDE_STEPPERS, sde_nf_per_step, sde_save_grid

    if prob.noise not in spec.noise:
        raise ValueError(
            f"method {spec.name!r} supports noise {spec.noise}, "
            f"problem has {prob.noise!r}")
    if adaptive:
        raise NotImplementedError(
            "adaptive SDE stepping is not ported yet: ROADMAP queue 1 item 6 "
            "(core/sde.py sde_solve_adaptive, the virtual Brownian tree)")
    if saveat is not None:
        raise NotImplementedError(
            "fixed-dt SDE snapshots land on the save_every grid (pass "
            "n_steps/save_every); saveat-grid output needs adaptive=True, "
            "which is ROADMAP queue 1 item 6")
    if seed is None:
        seed = seed_from_key(key) if key is not None else 0
    seed = check_u32("seed", seed)
    lane_offset = check_u32("lane_offset", lane_offset)
    if n_steps is None:
        n_steps = int(round((tf - t0) / dt0))
    if n_steps % save_every != 0:
        raise ValueError(f"save_every={save_every} must divide "
                         f"n_steps={n_steps}")
    N, n = u0s.shape
    m = prob.noise_dim()
    dtype, dev = u0s.dtype, u0s.device
    table = None
    if noise_table is not None:
        table = torch.as_tensor(noise_table, device=dev).to(dtype).contiguous()
        if tuple(table.shape) != (n_steps, m, N):
            raise ValueError(f"noise_table must be (n_steps, m, N) = "
                             f"{(n_steps, m, N)}, got {tuple(table.shape)}")
    nfps = sde_nf_per_step(spec.name)
    ts = sde_save_grid(t0, dt0, n_steps, save_every, dtype, device=dev)
    common = dict(t0=t0, dt=dt0, n_steps=n_steps, save_every=save_every,
                  seed=seed, lane_offset=lane_offset)

    if ensemble == "kernel" and backend == "cuda":
        return solve_sde_ensemble_kernel(prob, u0s, ps, method=spec.name,
                                         noise_table=table, **common)
    if ensemble == "kernel" and backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (use 'torch' or "
                         "'cuda')")
    if ensemble in ("array", "kernel"):
        # the lanes loop over the WHOLE ensemble, replaying the kernel's
        # exact counter stream; for fixed dt the §5.1 array semantics and
        # per-lane stepping agree
        us, uf = ref_solve(prob, u0s, ps, method=spec.name,
                           noise_table=table, **common)
        return _assemble_sde_result(ts, us.permute(2, 0, 1), uf.T, N,
                                    n_steps, nfps, t0, dt0, dtype)
    if ensemble == "vmap":
        us, uf = _sde_vmap(prob, SDE_STEPPERS[spec.name], u0s, ps,
                           table=table, **common)
        return _assemble_sde_result(ts, us, uf, N, n_steps, nfps, t0, dt0,
                                    dtype)
    raise NotImplementedError(
        f"sde methods do not support ensemble={ensemble!r} "
        "(use 'vmap', 'array' or 'kernel')")


def _sde_vmap(prob: SDEProblem, stepper, u0s, ps, *, t0, dt, n_steps,
              save_every, seed, lane_offset, table):
    """`torch.func.vmap` of the per-trajectory fixed-count loop (the
    reference's vmap strategy): each trajectory draws its own column of the
    counter stream, or of the table.  Returns us (N, S, n), u_final (N, n)."""
    from repro_torch.kernels.rng import M32, counter_normals_threefry
    from .sde import sde_step_and_save

    m = prob.noise_dim()
    S = n_steps // save_every
    rows = torch.arange(m, dtype=torch.int64, device=u0s.device)

    def one(u0, p, lane, table_col):
        # zeros_like keeps the snapshot buffer batched under vmap, so the
        # in-place snapshot writes are allowed
        us = torch.zeros_like(u0)[None].repeat(S, 1)
        u = u0
        for k in range(n_steps):
            if table_col is not None:
                z = table_col[k]
            else:
                z = counter_normals_threefry(seed, k, lane.expand(m), rows,
                                             u.dtype)
            u, us = sde_step_and_save(stepper, prob.f, prob.g, prob.noise, u,
                                      us, p, t0, dt, k, z, save_every)
        return us, u

    lanes = (torch.arange(u0s.shape[0], dtype=torch.int64,
                          device=u0s.device) + lane_offset) & M32
    if table is not None:
        return torch.func.vmap(one)(u0s, ps, lanes, table.permute(2, 0, 1))
    return torch.func.vmap(lambda u0, p, lane: one(u0, p, lane, None))(
        u0s, ps, lanes)


def _assemble_sde_result(ts, us, uf, N, n_steps, nf_per_step, t0, dt,
                         dtype) -> EnsembleResult:
    dev = us.device
    return EnsembleResult(
        ts=ts, us=us, u_final=uf,
        t_final=torch.full((N,), t0 + n_steps * dt, dtype=dtype, device=dev),
        naccept=torch.full((N,), n_steps, dtype=torch.int32, device=dev),
        nreject=torch.zeros((N,), dtype=torch.int32, device=dev),
        nf=torch.tensor(n_steps * nf_per_step * N, device=dev),
        status=torch.tensor(0, dtype=torch.int32, device=dev))


# ----------------------------------------------------------------------------
# front door
# ----------------------------------------------------------------------------

def solve_ensemble_local(eprob: EnsembleProblem, alg="tsit5",
                         ensemble: str = "kernel", backend: str = "torch",
                         t0=None, tf=None, dt0=1e-2, saveat=None,
                         rtol=1e-6, atol=1e-6, adaptive=None,
                         n_steps=None, save_every=1, lane_tile=None,
                         max_iters=100_000, event=None, key=None, seed=None,
                         noise_table=None, linsolve="torch", lane_offset=0,
                         w_reuse=None, sensitivity=None,
                         device=None) -> EnsembleResult:
    """Single-device ensemble solve of an explicit-RK, Rosenbrock or
    fixed-dt SDE method through any strategy and backend.

    Args:
      eprob: `EnsembleProblem` wrapping an `ODEProblem` or `SDEProblem`,
        with the per-trajectory (u0s, ps) variations.
      alg: a registry name (``"tsit5"``, ``"dopri5"``, ``"rodas5p"``,
        ``"rodas4"``, ``"rosenbrock23"``, ``"em"``, ``"platen_w2"``, ...),
        a `MethodSpec`, or a bare `Tableau` or `RosenbrockTableau`.
      ensemble: ``"vmap"``, ``"array"``, ``"array_eager"`` (erk only) or
        ``"kernel"``.
      backend: ``"torch"`` (the lanes twin) or ``"cuda"`` (the hand-written
        kernels: tsit5 and dopri5 on an RHS registered with `device_rhs`;
        em, heun_strat, platen_w2 and milstein on a drift/diffusion pair
        registered with `device_sde`; rosenbrock23, rodas4 and rodas5p on
        an RHS registered with `device_stiff`) — kernel strategy only.
      t0, tf, dt0: time span (defaults from ``prob.tspan``) and initial
        step.  ``dt0=None`` derives it from Hairer's two-evaluation
        heuristic per trajectory, takes the ensemble minimum, and counts the
        2·N probe evaluations in ``nf``.
      saveat: snapshot time grid (S,), interpolated by dense output.
      rtol, atol: adaptive error-control tolerances.
      adaptive: None picks the method's default; False forces fixed dt.
      n_steps, save_every: fixed-dt step count and snapshot stride.
      lane_tile: trajectories per tile of the ``"torch"`` kernel backend
        (None: one tile); the CUDA kernel runs one thread per trajectory.
      max_iters: adaptive-loop iteration cap (status 1 when exhausted).
      key, seed: the SDE noise stream's seed (a 32-bit int); ``seed=None``
        takes the last word of a reference PRNG ``key`` given as an array,
        else 0.  Every strategy replays the same Threefry stream.
      noise_table: (n_steps, m, N) pre-drawn N(0,1) increments to use in
        place of the stream (pathwise tests against the reference).
      linsolve: the stiff family's W solves — ``"torch"`` (the library's
        batched LU), ``"lanes"`` (the lanes LU body inline) or ``"cuda"``
        (one launch of the batched LU kernel per stage solve).  ``"vmap"``
        always takes ``"torch"`` and ``"kernel"``/``"cuda"`` always inlines
        the LU, as the reference's vmap and Pallas kernel do.
      lane_offset: GLOBAL index of the first trajectory, so SDE shards
        draw disjoint streams.
      w_reuse: the stiff family's lazy-W path: None takes the method's
        default (eager), True the default `WReusePolicy`, or a policy.  A
        truthy value on a non-stiff method raises.
      event, sensitivity: later slices of the port; they raise
        `NotImplementedError` naming the ROADMAP item.
      device: where the solve runs.  None means ``"cuda"``.

    Returns:
      `EnsembleResult` with trajectory-major ``us (N, S, n)``.
    """
    if event is not None:
        raise NotImplementedError(
            "events are not ported yet: ROADMAP queue 1 item 7 "
            "(core/events.py)")
    if sensitivity is not None:
        raise NotImplementedError(
            "sensitivities are not ported yet: ROADMAP queue 1 item 9 "
            "(core/loops.py and core/sensitivity.py)")
    if ensemble == "auto":
        raise NotImplementedError(
            "ensemble='auto' is not ported yet: ROADMAP queue 1 item 11 "
            "(core/autotune.py)")
    spec = get_method(alg)
    prob = eprob.prob
    if getattr(prob, "data", None) is not None:
        raise NotImplementedError(
            "data-driven problems are not ported yet: ROADMAP queue 1 item 8 "
            "(core/interp.py)")
    dev = resolve_device(device)
    u0s, ps = eprob.materialize()
    u0s = u0s.to(dev).contiguous()
    ps = ps.to(device=dev, dtype=u0s.dtype).contiguous()
    t0 = prob.tspan[0] if t0 is None else t0
    tf = prob.tspan[1] if tf is None else tf

    if w_reuse and spec.family != "rosenbrock":
        # only a truthy request is an error: w_reuse=False/None stays a no-op
        raise ValueError(
            "w_reuse controls the Rosenbrock lazy-W path; "
            f"{spec.name!r} ({spec.family}) has no W = I − γh·J to reuse")

    if spec.family == "sde":
        if dt0 is None:
            raise ValueError(
                "dt0=None (automatic initial step) is erk/rosenbrock only; "
                "SDE stepping needs an explicit dt0")
        if not isinstance(prob, SDEProblem):
            raise TypeError(
                f"method {spec.name!r} is an SDE stepper but the problem is "
                f"{type(prob).__name__}")
        return _solve_sde(spec, prob, u0s, ps, ensemble=ensemble,
                          backend=backend, t0=t0, tf=tf, dt0=dt0,
                          saveat=saveat, n_steps=n_steps,
                          save_every=save_every, key=key, seed=seed,
                          noise_table=noise_table, adaptive=adaptive,
                          lane_offset=lane_offset)
    if isinstance(prob, SDEProblem):
        raise TypeError(
            f"problem {prob.name!r} is stochastic; pick an sde method "
            f"(e.g. alg='em'), not {spec.name!r}")

    auto_dt_nf = 0
    if dt0 is None:
        order = max(1, int(round(spec.order)))
        h = initial_dt(prob.f, u0s.T, ps.T, t0, tf, order, atol, rtol)
        dt0 = float(h.min())
        auto_dt_nf = 2 * u0s.shape[0]

    if spec.family == "rosenbrock":
        res = _solve_rosenbrock(spec, prob, u0s, ps, ensemble=ensemble,
                                backend=backend, t0=t0, tf=tf, dt0=dt0,
                                saveat=saveat, rtol=rtol, atol=atol,
                                lane_tile=lane_tile, max_iters=max_iters,
                                linsolve=linsolve, w_reuse=w_reuse)
    else:
        res = _solve_erk(spec, prob, u0s, ps, ensemble=ensemble,
                         backend=backend, t0=t0, tf=tf, dt0=dt0,
                         saveat=saveat, rtol=rtol, atol=atol,
                         adaptive=adaptive, n_steps=n_steps,
                         save_every=save_every, lane_tile=lane_tile,
                         max_iters=max_iters)
    if auto_dt_nf:
        res = res._replace(nf=res.nf + auto_dt_nf)
    return res
