"""Ensemble execution strategies (paper §5) on a single device — the erk,
rosenbrock and sde families of `repro.core.ensemble`, in PyTorch.

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
With ``adaptive=True`` it runs `core.sde.sde_solve_adaptive` (embedded
pair or step doubling on the virtual Brownian tree) in lanes mode on
"vmap" and "array" (the whole batch) and "kernel"/"torch" (tiles), and
the adaptive CUDA kernel (`repro_torch.kernels.em.adaptive`) on
"kernel"/"cuda"; every strategy draws the same (seed; lane, row, dyadic
index) tree, so their paths agree.

Gradients (paper §6.6, ``sensitivity=``): ``"adjoint"`` swaps the loops
for their bounded, checkpointed form (`core.loops`) and differentiates the
realized step sequence by reverse mode; on "kernel"/"cuda" the forward
solve runs the kernel and the backward pass replays the plain version
(`repro_torch.kernels.ensemble_kernel.kernel_adjoint`).  ``"forward"``
rides `torch.func.jvp` through the plain loops (`core.sensitivity`).

A data-driven problem (``prob.data``, paper §6.7) runs on every strategy:
its dataset is closed over the callbacks once (`bind_problem_data`) for the
lanes and vmap paths, while the CUDA kernels take the raw 4-argument
callbacks and the tables as kernel arguments, read on the card by the data
functor the RHS is registered with.

Entry points run on the card: ``device=None`` means ``"cuda"``, and a
machine without CUDA raises unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .controller import PIController, initial_dt
from .events import without_log
from .interp import data_flatten, data_unflatten
from .methods import MethodSpec, get_method
from .problem import (EnsembleProblem, ODEProblem, SDEProblem,
                      bind_problem_data)
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
               rtol, atol, adaptive, max_iters, event=None,
               bounded_steps=None, checkpoint_every=None) -> EnsembleResult:
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive, bounded_steps=bounded_steps,
                           checkpoint_every=checkpoint_every)
    res = without_log(solve_adaptive(prob.f, tab, u0s.T, ps.T, t0, tf, dt0,
                                     saveat=saveat, opts=opts, event=event,
                                     lanes=True), event)
    return EnsembleResult(ts=saveat, us=res.us.permute(2, 0, 1),
                          u_final=res.u_final.T, t_final=res.t_final,
                          naccept=res.naccept, nreject=res.nreject,
                          nf=res.nf.sum(), status=res.status.max())


# ----------------------------------------------------------------------------
# strategy: array (EnsembleGPUArray semantics: lock-step global dt)
# ----------------------------------------------------------------------------

def solve_array(prob: ODEProblem, u0s, ps, tab, t0, tf, dt0, saveat,
                rtol, atol, adaptive, max_iters, bounded_steps=None,
                checkpoint_every=None) -> EnsembleResult:
    # (n, N) state with scalar control: ONE dt + an ensemble-wide norm
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive, bounded_steps=bounded_steps,
                           checkpoint_every=checkpoint_every)
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
                       rtol, atol, adaptive, max_iters, lane_tile=None,
                       event=None, bounded_steps=None,
                       checkpoint_every=None) -> EnsembleResult:
    """The fused-integration lanes path in PyTorch ops: trajectories are
    packed into (n, B) tiles and each tile runs its own loop to completion
    (per-lane dt/accept masks) — the control structure of the kernel, so
    this backend doubles as its oracle."""
    N, n = u0s.shape
    u0p, psp, T, B = _tile_lanes(u0s, ps, lane_tile)
    opts = AdaptiveOptions(rtol=rtol, atol=atol, max_iters=max_iters,
                           adaptive=adaptive, bounded_steps=bounded_steps,
                           checkpoint_every=checkpoint_every)
    tiles = [without_log(solve_adaptive(prob.f, tab, u0p[i].T, psp[i].T, t0,
                                        tf, dt0, saveat=saveat, opts=opts,
                                        event=event, lanes=True), event)
             for i in range(T)]
    return _untile(tiles, N, n)


def solve_kernel_fixed(prob: ODEProblem, u0s, ps, tab, t0, dt, n_steps,
                       save_every, remat=False,
                       checkpoint_every=None) -> EnsembleResult:
    """Fixed-dt fused path over (n, N) lanes: every step accepted, a
    snapshot every `save_every` steps (``remat``: `solve_fixed`'s
    checkpointed form)."""
    N, n = u0s.shape
    res = solve_fixed(prob.f, tab, u0s.T, ps.T, t0, dt, n_steps, save_every,
                      remat=remat, checkpoint_every=checkpoint_every)
    return EnsembleResult(
        ts=res.ts, us=res.us.permute(2, 0, 1), u_final=res.u_final.T,
        t_final=res.t_final.expand(N), naccept=res.naccept.expand(N),
        nreject=torch.zeros((N,), dtype=torch.int32, device=u0s.device),
        nf=res.nf * N, status=res.status)


# ----------------------------------------------------------------------------
# sensitivity plumbing shared by the family dispatchers
# ----------------------------------------------------------------------------

def _resolve_adjoint(sensitivity, adaptive, adjoint_steps, n_steps):
    """(bounded_steps, remat) for the engines under sensitivity='adjoint'.

    Adaptive stepping has no static iteration count, so reverse mode needs
    an explicit ``adjoint_steps`` bound (probe the forward solve:
    ``naccept + nreject``; a bound that turns out too small reports
    ``status == 1``).  Fixed-dt stepping derives the bound from ``n_steps``
    (one attempt per step) and asks the fixed-step paths for checkpointed
    segments instead."""
    if sensitivity != "adjoint":
        return None, False
    if adjoint_steps is not None:
        return int(adjoint_steps), True
    if adaptive:
        raise ValueError(
            "sensitivity='adjoint' with adaptive stepping needs an explicit "
            "adjoint_steps bound on the attempt count (run the forward solve "
            "once and use naccept + nreject plus margin; a too-small bound "
            "surfaces as status == 1, never as a wrong gradient)")
    # fixed-accept stepping: exactly one attempt per step
    return int(n_steps) + 1, True


def _kernel_run(run, replay, sensitivity, u0s, ps, leaves):
    """A kernel branch's result: `run` alone, or under `kernel_adjoint`
    with `replay` (the family's bounded plain path) for the backward
    pass."""
    if sensitivity == "adjoint":
        from repro_torch.kernels.ensemble_kernel import kernel_adjoint
        return kernel_adjoint(run, replay)(u0s, ps, *leaves)
    return run(u0s, ps, *leaves)


def _bind_leaves(raw_prob, tree, leaves, prob):
    """The problem with its callbacks closed over tables rebuilt from
    `leaves` (a kernel replay's grad-requiring copies), or `prob` (bound
    over the problem's own tables, if any) without leaves."""
    if not leaves:
        return prob
    return bind_problem_data(raw_prob, data_unflatten(tree, leaves))


# ----------------------------------------------------------------------------
# family dispatch: erk
# ----------------------------------------------------------------------------

def _solve_erk(spec: MethodSpec, prob, u0s, ps, *, ensemble, backend, t0, tf,
               dt0, saveat, rtol, atol, adaptive, n_steps, save_every,
               lane_tile, max_iters, event, sensitivity=None,
               adjoint_steps=None, checkpoint_every=None, raw_prob=None):
    # `prob` arrives with any dataset closed over its callbacks; the CUDA
    # branch takes the raw 4-argument callbacks and the tables instead
    data = getattr(raw_prob, "data", None)
    leaves, tree = data_flatten(data)
    tab = spec.tableau
    if adaptive is None:
        adaptive = True   # family default: embedded-error stepping
    if not spec.adaptive:
        adaptive = False  # e.g. rk4: no embedded error estimate
    explicit_saveat = saveat is not None
    if not adaptive and n_steps is None:
        n_steps = int(round((tf - t0) / dt0))
    bounded, remat = _resolve_adjoint(sensitivity, adaptive, adjoint_steps,
                                      n_steps)
    ck = dict(bounded_steps=bounded, checkpoint_every=checkpoint_every)
    dtype, device = u0s.dtype, u0s.device
    if saveat is None:
        if not adaptive and ensemble == "kernel" and event is None:
            # the fixed-step kernel paths save on the save_every step grid
            if n_steps % save_every != 0:
                raise ValueError(
                    f"save_every={save_every} must divide n_steps={n_steps}")
            saveat = t0 + dt0 * save_every * torch.arange(
                1, n_steps // save_every + 1, dtype=torch.float64)
        else:
            saveat = [tf]
    if ensemble == "kernel" and backend == "cuda":
        # the grid as given: the kernel path reads it on the host before it
        # moves to the card (`kernels/tsit5/ops.py::save_grid`)
        from repro_torch.kernels.tsit5 import ops as erk_ops
        kprob = raw_prob if data is not None else prob

        def run(u, p, *lv):
            return erk_ops.solve_ensemble_cuda(
                kprob, u, p, tab, t0, tf, dt0, saveat, rtol, atol,
                adaptive, max_iters=max_iters, event=event,
                data=data_unflatten(tree, lv) if data is not None
                else None)

        def replay(u, p, *lv):
            return solve_kernel_torch(
                _bind_leaves(raw_prob, tree, lv, prob), u, p, tab, t0,
                tf, dt0, torch.as_tensor(saveat, dtype=dtype, device=device),
                rtol, atol, adaptive, max_iters, event=event, **ck)

        return _kernel_run(run, replay, sensitivity, u0s, ps, leaves)
    saveat = torch.as_tensor(saveat, dtype=dtype, device=device)

    if ensemble == "vmap":
        return solve_vmap(prob, u0s, ps, tab, t0, tf, dt0, saveat, rtol, atol,
                          adaptive, max_iters, event, **ck)
    if ensemble == "array":
        if event is not None:
            # the reference's lock-step loop cannot carry per-trajectory
            # event state either (it fails on the carry's shape)
            raise ValueError(
                "events need per-trajectory control; the erk array strategy "
                "steps every trajectory with one dt (use 'vmap' or 'kernel')")
        return solve_array(prob, u0s, ps, tab, t0, tf, dt0, saveat, rtol,
                           atol, adaptive, max_iters, **ck)
    if ensemble == "array_eager":
        if event is not None:
            raise NotImplementedError(
                "events are not supported on the array_eager strategy")
        return solve_array_eager(prob, u0s, ps, tab, t0, tf, dt0, saveat,
                                 rtol, atol, adaptive)
    if ensemble == "kernel":
        if backend != "torch":
            raise ValueError(f"unknown backend {backend!r} "
                             "(use 'torch' or 'cuda')")
        if not adaptive and event is None and not explicit_saveat:
            return solve_kernel_fixed(prob, u0s, ps, tab, t0, dt0, n_steps,
                                      save_every, remat=remat,
                                      checkpoint_every=checkpoint_every)
        # fixed dt with a saveat or an event: the lanes path with
        # adaptive=False
        return solve_kernel_torch(prob, u0s, ps, tab, t0, tf, dt0, saveat,
                                  rtol, atol, adaptive, max_iters,
                                  lane_tile=lane_tile, event=event, **ck)
    raise ValueError(f"unknown ensemble strategy {ensemble!r}")


# ----------------------------------------------------------------------------
# family dispatch: rosenbrock (stiff, paper §5.1.3 + §7)
# ----------------------------------------------------------------------------

def _solve_rosenbrock(spec: MethodSpec, prob: ODEProblem, u0s, ps, *,
                      ensemble, backend, t0, tf, dt0, saveat, rtol, atol,
                      lane_tile, max_iters, linsolve, w_reuse, event,
                      sensitivity=None, adjoint_steps=None,
                      checkpoint_every=None, raw_prob=None):
    from .rosenbrock import LINSOLVES, solve_rosenbrock

    data = getattr(raw_prob, "data", None)
    leaves, tree = data_flatten(data)
    # the stiff engine is always adaptive: the adjoint needs the explicit
    # attempt bound
    bounded, _ = _resolve_adjoint(sensitivity, True, adjoint_steps, None)
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
              jac=jac, w_reuse=w_reuse, event=event)
    ck = dict(bounded_steps=bounded, checkpoint_every=checkpoint_every)

    def lanes_run(u, p, *lv, tile=lane_tile):
        # the lanes engine in tiles; `lv` are the table leaves when it
        # replays a data-driven kernel solve under kernel_adjoint
        bp = _bind_leaves(raw_prob, tree, lv, prob)
        u0p, psp, T, _ = _tile_lanes(u, p, tile)
        tiles = [without_log(solve_rosenbrock(
            bp.f, rtab, u0p[i].T, psp[i].T, t0, tf, dt0, linsolve=linsolve,
            **dict(kw, jac=bp.jac), **ck), event) for i in range(T)]
        return _untile(tiles, N, n)

    if ensemble == "vmap":
        # the reference vmaps its per-trajectory solver, whose refresh
        # predicates are psum-reduced over the batch: the lanes engine over
        # the whole batch with the library LU computes the same
        res = solve_rosenbrock(prob.f, rtab, u0s.T, ps.T, t0, tf, dt0,
                               linsolve="torch", **kw, **ck)
        return _untile([without_log(res, event)], N, n)
    if ensemble == "kernel" and backend == "cuda":
        from repro_torch.kernels.rosenbrock.ops import solve_rosenbrock_cuda
        kprob = raw_prob if data is not None else prob

        def run(u, p, *lv):
            return solve_rosenbrock_cuda(
                kprob, u, p, rtab, t0=t0, tf=tf, dt0=dt0,
                data=data_unflatten(tree, lv) if data is not None else None,
                **dict(kw, jac=kprob.jac))

        return _kernel_run(run, lanes_run, sensitivity, u0s, ps, leaves)
    if ensemble == "kernel" and backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (use 'torch' or "
                         "'cuda')")
    if ensemble in ("array", "kernel"):
        # "array": the whole ensemble as one lanes tile.  A lock-step
        # scalar-dt Rosenbrock would need an (N·n)-sized Jacobian, so the
        # array strategy keeps one state matrix with per-lane control, as
        # the reference's does
        return lanes_run(u0s, ps,
                         tile=None if ensemble == "array" else lane_tile)
    raise NotImplementedError(
        f"rosenbrock methods do not support ensemble={ensemble!r} "
        "(use 'vmap', 'array' or 'kernel')")


# ----------------------------------------------------------------------------
# family dispatch: sde (fixed-dt counter-RNG steppers, paper §5.2.2)
# ----------------------------------------------------------------------------

def _solve_sde(spec: MethodSpec, prob: SDEProblem, u0s, ps, *, ensemble,
               backend, t0, tf, dt0, saveat, n_steps, save_every, lane_tile,
               key, seed, noise_table, event, adaptive, rtol, atol, max_iters,
               lane_offset, brownian_depth, error_est, sensitivity=None,
               adjoint_steps=None, checkpoint_every=None,
               raw_prob=None) -> EnsembleResult:
    from repro_torch.kernels.em.ops import (seed_from_key,
                                            solve_sde_ensemble_kernel)
    from repro_torch.kernels.em.ref import ref_solve
    from repro_torch.kernels.rng import check_u32
    from .sde import SDE_STEPPERS, sde_nf_per_step, sde_save_grid

    if prob.noise not in spec.noise:
        raise ValueError(
            f"method {spec.name!r} supports noise {spec.noise}, "
            f"problem has {prob.noise!r}")
    if adaptive is None:
        adaptive = False  # family default: the paper's kernels are fixed-dt
    if adaptive and not spec.adaptive:
        raise ValueError(
            f"method {spec.name!r} has no adaptive step control; "
            "pass adaptive=False or pick an adaptive-capable stepper")
    if not adaptive and error_est is not None:
        raise ValueError(
            "error_est selects the adaptive SDE error estimator; it has no "
            "meaning for fixed-dt stepping (pass adaptive=True)")
    if seed is None:
        seed = seed_from_key(key) if key is not None else 0
    seed = check_u32("seed", seed)
    lane_offset = check_u32("lane_offset", lane_offset)
    if adaptive:
        return _solve_sde_adaptive(
            spec, prob, u0s, ps, ensemble=ensemble, backend=backend, t0=t0,
            tf=tf, dt0=dt0, saveat=saveat, lane_tile=lane_tile, seed=seed,
            noise_table=noise_table, rtol=rtol, atol=atol,
            max_iters=max_iters, lane_offset=lane_offset,
            brownian_depth=brownian_depth, error_est=error_est, event=event,
            sensitivity=sensitivity, adjoint_steps=adjoint_steps,
            checkpoint_every=checkpoint_every, raw_prob=raw_prob)
    if saveat is not None:
        raise NotImplementedError(
            "fixed-dt SDE snapshots land on the save_every grid (pass "
            "n_steps/save_every); use adaptive=True for saveat-grid output")
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
    _, remat = _resolve_adjoint(sensitivity, False, adjoint_steps, n_steps)
    common = dict(t0=t0, dt=dt0, n_steps=n_steps, save_every=save_every,
                  seed=seed, lane_offset=lane_offset, event=event)
    data = getattr(raw_prob, "data", None)
    leaves, tree = data_flatten(data)

    def ref_run(u, p, *lv):
        # the lanes loop over the WHOLE ensemble, replaying the kernel's
        # exact counter stream; for fixed dt the §5.1 array semantics and
        # per-lane stepping agree.  `lv` are the table leaves when it
        # replays a data-driven kernel solve under kernel_adjoint.
        bp = _bind_leaves(raw_prob, tree, lv, prob)
        us, uf, estate = ref_solve(bp, u, p, method=spec.name,
                                   noise_table=table, remat=remat,
                                   checkpoint_every=checkpoint_every,
                                   **common)
        return _assemble_sde_result(ts, us.permute(2, 0, 1), uf.T, N,
                                    n_steps, nfps, t0, dt0, dtype, estate)

    if ensemble == "kernel" and backend == "cuda":
        kprob = raw_prob if data is not None else prob

        def run(u, p, *lv):
            return solve_sde_ensemble_kernel(
                kprob, u, p, method=spec.name, noise_table=table,
                data=data_unflatten(tree, lv) if data is not None else None,
                **common)

        return _kernel_run(run, ref_run, sensitivity, u0s, ps, leaves)
    if ensemble == "kernel" and backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (use 'torch' or "
                         "'cuda')")
    if ensemble in ("array", "kernel"):
        return ref_run(u0s, ps)
    if ensemble == "vmap":
        us, uf, estate = _sde_vmap(prob, SDE_STEPPERS[spec.name], u0s, ps,
                                   table=table, remat=remat,
                                   checkpoint_every=checkpoint_every,
                                   **common)
        return _assemble_sde_result(ts, us, uf, N, n_steps, nfps, t0, dt0,
                                    dtype, estate)
    raise NotImplementedError(
        f"sde methods do not support ensemble={ensemble!r} "
        "(use 'vmap', 'array' or 'kernel')")


def resolve_adaptive_sde(spec: MethodSpec, noise: str, *, error_est=None,
                         brownian_depth=None, t0, tf, dt0) -> dict:
    """The adaptive SDE estimator, resolved as the reference's front door
    resolves it: ``error_est`` (the registered embedded pair wherever it
    applies, on diagonal noise, doubling everywhere else), the stepper's
    ``order``, the controller's ``est_order``, ``nf_per_attempt`` and the
    tree ``depth``.  Raises on a combination the front door refuses."""
    from .sde import default_bridge_depth, sde_nf_per_step

    if error_est is None:
        error_est = ("embedded"
                     if ("embedded" in spec.error_est
                         and noise == "diagonal") else "doubling")
    if error_est not in spec.error_est:
        raise ValueError(
            f"method {spec.name!r} supports error_est {spec.error_est}, "
            f"got {error_est!r}")
    if error_est == "embedded" and noise != "diagonal":
        raise ValueError(
            "embedded SDE pairs are diagonal-noise only (Levy-area-free "
            "estimators); pass error_est='doubling' for general noise")
    pair = spec.embedded if error_est == "embedded" else None
    return dict(
        error_est=error_est, order=spec.order,
        est_order=(pair.est_order if pair is not None
                   else max(1, int(round(spec.order)))),
        nf_per_attempt=(pair.nf_per_attempt if pair is not None
                        else 3 * sde_nf_per_step(spec.name)),
        depth=(brownian_depth if brownian_depth is not None
               else default_bridge_depth(t0, tf, dt0)))


def _solve_sde_adaptive(spec: MethodSpec, prob: SDEProblem, u0s, ps, *,
                        ensemble, backend, t0, tf, dt0, saveat, lane_tile,
                        seed, noise_table, rtol, atol, max_iters,
                        lane_offset, brownian_depth, error_est,
                        event, sensitivity=None, adjoint_steps=None,
                        checkpoint_every=None,
                        raw_prob=None) -> EnsembleResult:
    """The adaptive branch of `_solve_sde`: estimator, tree depth and saveat
    resolved as the reference resolves them, then the lanes engine or the
    adaptive kernel."""
    from repro_torch.kernels.em.ops import solve_sde_adaptive_kernel
    from repro_torch.kernels.rng import M32
    from .sde import SDE_STEPPERS, sde_nf_per_step, sde_solve_adaptive

    if noise_table is not None:
        raise NotImplementedError(
            "adaptive SDE draws from the virtual Brownian tree; "
            "noise_table injection is fixed-dt only")
    kw = dict(resolve_adaptive_sde(spec, prob.noise, error_est=error_est,
                                   brownian_depth=brownian_depth, t0=t0,
                                   tf=tf, dt0=dt0),
              seed=seed, rtol=rtol, atol=atol, max_iters=max_iters,
              event=event)
    saveat = torch.as_tensor([tf] if saveat is None else saveat,
                             dtype=u0s.dtype, device=u0s.device)
    N, n = u0s.shape
    bounded, _ = _resolve_adjoint(sensitivity, True, adjoint_steps, None)
    data = getattr(raw_prob, "data", None)
    leaves, tree = data_flatten(data)

    def lanes_run(u, p, *lv, tile=lane_tile):
        # "vmap": torch.func.vmap cannot batch a data-dependent loop, so the
        # lanes engine runs over the whole batch (what JAX's vmap of a while
        # loop lowers to); "array": the whole ensemble as one lanes tile with
        # per-lane control, as the reference's; "kernel"/"torch": tiles of
        # `lane_tile`.  Per-lane results do not depend on the tiling.  `lv`
        # are the table leaves when it replays a data-driven kernel solve.
        bp = _bind_leaves(raw_prob, tree, lv, prob)
        u0p, psp, T, B = _tile_lanes(u, p, tile)
        lanes = ((torch.arange(T * B, dtype=torch.int64, device=u.device)
                  + lane_offset) & M32).reshape(T, B)
        tiles = [without_log(sde_solve_adaptive(
            bp.f, bp.g, SDE_STEPPERS[spec.name], prob.noise, u0p[i].T,
            psp[i].T, t0, tf, dt0, lane_idx=lanes[i], lanes=True,
            m_noise=prob.noise_dim(), saveat=saveat,
            nf_per_step=sde_nf_per_step(spec.name),
            embedded=(spec.embedded.fn if kw["error_est"] == "embedded"
                      else None), bounded_steps=bounded,
            checkpoint_every=checkpoint_every, **kw), event)
            for i in range(T)]
        return _untile(tiles, N, n)

    if ensemble == "kernel" and backend == "cuda":
        kprob = raw_prob if data is not None else prob

        def run(u, p, *lv):
            return solve_sde_adaptive_kernel(
                kprob, u, p, saveat, method=spec.name, t0=t0, tf=tf, dt0=dt0,
                lane_offset=lane_offset,
                data=data_unflatten(tree, lv) if data is not None else None,
                **kw)

        return _kernel_run(run, lanes_run, sensitivity, u0s, ps, leaves)
    if ensemble == "kernel" and backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (use 'torch' or "
                         "'cuda')")
    if ensemble in ("vmap", "array", "kernel"):
        return lanes_run(u0s, ps,
                         tile=lane_tile if ensemble == "kernel" else None)
    raise NotImplementedError(
        f"sde methods do not support ensemble={ensemble!r} "
        "(use 'vmap', 'array' or 'kernel')")


def _sde_vmap(prob: SDEProblem, stepper, u0s, ps, *, t0, dt, n_steps,
              save_every, seed, lane_offset, table, event, remat=False,
              checkpoint_every=None):
    """`torch.func.vmap` of the per-trajectory fixed-count loop (the
    reference's vmap strategy): each trajectory draws its own column of the
    counter stream, or of the table.  Returns us (N, S, n), u_final (N, n)
    and the per-trajectory event state (None without an event).

    ``remat=True`` runs the same per-trajectory steps one `vmap` per step
    inside `checkpointed_fori` (a checkpoint cannot sit inside `vmap`)."""
    from repro_torch.kernels.rng import M32, counter_normals_threefry
    from .loops import checkpointed_fori
    from .sde import (sde_event_state0, sde_step_and_save,
                      sde_step_save_event)

    m = prob.noise_dim()
    S = n_steps // save_every
    rows = torch.arange(m, dtype=torch.int64, device=u0s.device)
    lanes = (torch.arange(u0s.shape[0], dtype=torch.int64,
                          device=u0s.device) + lane_offset) & M32
    tcols = table.permute(2, 0, 1) if table is not None else None

    def draw(k, lane, table_col, dtype):
        if table_col is not None:
            return table_col[k]
        return counter_normals_threefry(seed, k, lane.expand(m), rows, dtype)

    if remat:
        def one_step(k, u, p, lane, table_col, estate):
            z = draw(k, lane, table_col, u.dtype)
            if event is None:
                return sde_step_and_save(stepper, prob.f, prob.g, prob.noise,
                                         u, None, p, t0, dt, k, z,
                                         save_every)[0]
            u, _, estate = sde_step_save_event(
                stepper, prob.f, prob.g, prob.noise, event, u, None, estate,
                p, t0, dt, k, z, save_every)
            return u, estate

        def body(k, carry):
            u, estate, snaps = carry
            if event is None:
                u = torch.func.vmap(
                    lambda uu, pp, ll, tc: one_step(k, uu, pp, ll, tc, None),
                    in_dims=(0, 0, 0, None if tcols is None else 0))(
                        u, ps, lanes, tcols)
            else:
                u, estate = torch.func.vmap(
                    lambda uu, pp, ll, tc, es: one_step(k, uu, pp, ll, tc,
                                                        es),
                    in_dims=(0, 0, 0, None if tcols is None else 0, 0))(
                        u, ps, lanes, tcols, estate)
            if (k + 1) % save_every == 0:
                snaps = snaps + (u,)
            return u, estate, snaps

        estate0 = (sde_event_state0((u0s.shape[0],), t0, u0s.dtype,
                                    u0s.device) if event is not None
                   else None)
        u, estate, snaps = checkpointed_fori(
            0, n_steps, body, (u0s, estate0, ()),
            checkpoint_every=checkpoint_every)
        return torch.stack(snaps, dim=1), u, estate

    def one(u0, p, lane, table_col):
        # zeros_like keeps the snapshot buffer batched under vmap, so the
        # in-place snapshot writes are allowed
        us = torch.zeros_like(u0)[None].repeat(S, 1)
        u = u0
        estate = (sde_event_state0((), t0, u0.dtype, u0.device)
                  if event is not None else None)
        for k in range(n_steps):
            z = draw(k, lane, table_col, u.dtype)
            if event is None:
                u, us = sde_step_and_save(stepper, prob.f, prob.g, prob.noise,
                                          u, us, p, t0, dt, k, z, save_every)
            else:
                u, us, estate = sde_step_save_event(
                    stepper, prob.f, prob.g, prob.noise, event, u, us, estate,
                    p, t0, dt, k, z, save_every)
        # vmap returns tensors only: no event state without an event
        return (us, u) if estate is None else (us, u, estate)

    if table is not None:
        out = torch.func.vmap(one)(u0s, ps, lanes, tcols)
    else:
        out = torch.func.vmap(lambda u0, p, lane: one(u0, p, lane, None))(
            u0s, ps, lanes)
    return out if event is not None else out + (None,)


def _assemble_sde_result(ts, us, uf, N, n_steps, nf_per_step, t0, dt,
                         dtype, estate=None) -> EnsembleResult:
    dev = us.device
    if estate is None:
        t_final = torch.full((N,), t0 + n_steps * dt, dtype=dtype, device=dev)
        naccept = torch.full((N,), n_steps, dtype=torch.int32, device=dev)
    else:
        # terminal events freeze lanes early: the true per-lane step count
        # and the located event time, not the nominal grid end
        t_final = estate["t_out"].to(dtype).expand(N)
        naccept = estate["naccept"].expand(N)
    return EnsembleResult(
        ts=ts, us=us, u_final=uf, t_final=t_final, naccept=naccept,
        nreject=torch.zeros((N,), dtype=torch.int32, device=dev),
        nf=torch.tensor(n_steps * nf_per_step * N, device=dev),
        status=torch.tensor(0, dtype=torch.int32, device=dev))


# ----------------------------------------------------------------------------
# resumable segment engine (the continuous-batching substrate: serve/, dist/)
# ----------------------------------------------------------------------------

class ResumableEngine:
    """A fixed-width slot stepper over one per-lane resume body.

    Wraps a per-lane resume body (`core.solvers.erk_resume_body`,
    `core.sde.sde_resume_body`) in a bounded loop over a B-wide carry whose
    per-lane constants (p, tf or n_steps, lane, ...) live in the carry, on
    one device.  `step_segment(carry, refill_mask, refill)` first merges the
    refill columns into the carry (`torch.where` over the lane axis, so the
    code path does not depend on which slots refill), then advances every
    active lane by at most `segment_steps` attempts while any lane is
    active.  The body is an exact no-op on a done lane, so mixed-progress
    slots cost only their width; the serving layer harvests done lanes
    between segments and refills their slots from the request queue.

    The reference's engine is a jitted ``while_loop``, with no Pallas
    kernel in it; this one is the lanes engine in PyTorch ops on the
    carry's device (one host check of the ``done`` mask an attempt)."""

    def __init__(self, init_fn, body_fn, segment_steps: int = 64,
                 device=None):
        self.segment_steps = int(segment_steps)
        self.device = resolve_device(device)
        self._init = init_fn
        self._body = body_fn

    def _tensor(self, x):
        return (torch.as_tensor(x, device=self.device)
                if isinstance(x, (np.ndarray, torch.Tensor)) else x)

    def fresh(self, *args):
        """A full-width carry, every column a fresh lane: the pool's first
        state, and (merged through `step_segment`) the refill columns;
        columns that do not refill are computed on filler values and
        dropped by the merge.  Array arguments move to the engine's device
        with their dtypes."""
        return self._init(*(self._tensor(a) for a in args))

    def step_segment(self, carry, refill_mask, refill):
        """Merge `refill`'s columns where `refill_mask` (B,) is set, then
        run one bounded segment.  An all-False mask with ``refill=carry``
        is a pure advance."""
        mask = torch.as_tensor(refill_mask, dtype=torch.bool,
                               device=self.device)
        merge = bool(mask.any())
        c = {}
        for k, old in carry.items():
            if k == "iters":
                # segment-local bound; per-request budgets are enforced
                # by the caller from naccept + nreject
                c[k] = torch.zeros((), dtype=torch.int32, device=self.device)
            elif merge:
                c[k] = torch.where(mask[None] if old.dim() == 2 else mask,
                                   refill[k], old)
            else:
                c[k] = old
        it = 0
        while it < self.segment_steps and not bool(c["done"].all()):
            c = self._body(c)
            it += 1
        return c

    def export_carry(self, carry):
        """The carry gathered to the host (see `export_resume_carry`)."""
        return export_resume_carry(carry)

    def import_carry(self, host_carry):
        """An exported carry back on this engine's device."""
        return import_resume_carry(host_carry, device=self.device)


def export_resume_carry(carry) -> dict:
    """A resumable carry gathered to the host as numpy, dtypes kept.

    The carry is the whole per-lane solver state (u, t, dt, counters, the
    per-lane constants p, tf or n_steps and the lane index, the done and
    status flags), so an exported carry is a restart point: back on a
    device and continued by the same engine, it replays exactly the
    remaining body applications.  `repro_torch.dist.elastic` snapshots it
    through `repro_torch.checkpoint.ckpt`, so a restore may go to any shard
    count."""
    return {k: v.detach().cpu().numpy() for k, v in carry.items()}


def import_resume_carry(host_carry: dict, device=None) -> dict:
    """Inverse of `export_resume_carry`: numpy carry -> tensors on
    `resolve_device(device)` (the card unless the caller asks for the CPU).
    Dtypes are kept exactly (a bitwise resume depends on it)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in host_carry.items()}


def make_resumable_engine(spec: MethodSpec, prob, *, adaptive=None,
                          rtol=1e-6, atol=1e-6, event=None, seed=0,
                          m_noise=None, segment_steps: int = 64,
                          device=None) -> ResumableEngine:
    """The (init, body) pair of a resumable method in a `ResumableEngine`
    on `resolve_device(device)`.

    erk: ``engine.fresh(u0, p, t0, tf, dt0)``, u0 (n, B), p (k, B), the rest
         numbers or (B,).  The body is `solve_adaptive`'s own
         (`_make_adaptive_body`) with p and tf in the carry.
    sde (fixed dt): ``engine.fresh(u0, p, t0, dt, n_steps, lane)``,
         per-lane step counts and GLOBAL lane indices; the noise replays the
         (seed; step, lane, row) Threefry counters of the fresh paths.

    Raises ValueError for a method declaring ``resumable=False``
    (rosenbrock's lazy-W refresh gates couple lanes: the service runs it as
    coalesced one-shot batches, `repro_torch.serve.slots.BatchPool`) and
    for adaptive SDE stepping.
    """
    if not spec.resumable:
        raise ValueError(
            f"method {spec.name!r} declares resumable=False; serve it via "
            "coalesced one-shot batches (repro_torch.serve.slots.BatchPool)")
    if spec.family == "sde":
        from .sde import sde_resume_body, sde_resume_init
        if adaptive:
            raise ValueError(
                "adaptive SDE stepping is not slot-resumable (Brownian-tree "
                "left-endpoint state is dt-path dependent); fixed-dt only")
        if m_noise is None:
            m_noise = prob.noise_dim()
        body = sde_resume_body(prob.f, prob.g, spec.name, prob.noise,
                               m_noise, seed, event=event)
        return ResumableEngine(sde_resume_init, body, segment_steps, device)
    if spec.family == "erk":
        from .solvers import erk_resume_body, erk_resume_init
        tab = spec.tableau
        if adaptive is None:
            adaptive = spec.adaptive
        opts = AdaptiveOptions(rtol=rtol, atol=atol, adaptive=adaptive)
        body = erk_resume_body(prob.f, tab, opts, event=event)

        def init(u0, p, t0, tf, dt0):
            return erk_resume_init(prob.f, tab, u0, p, t0, tf, dt0)

        return ResumableEngine(init, body, segment_steps, device)
    raise ValueError(f"no resumable engine for family {spec.family!r}")


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
                         brownian_depth=None, error_est=None,
                         w_reuse=None, sensitivity=None, adjoint_steps=None,
                         checkpoint_every=None,
                         device=None) -> EnsembleResult:
    """Single-device ensemble solve of an explicit-RK, Rosenbrock or SDE
    method through any strategy and backend.

    Args:
      eprob: `EnsembleProblem` wrapping an `ODEProblem` or `SDEProblem`,
        with the per-trajectory (u0s, ps) variations.  A problem's
        ``data`` (`core.interp` tables its callbacks take as a fourth
        argument) runs on every strategy; the CUDA kernels read it through
        the data functor the RHS is registered with, and a method declaring
        ``data_rhs=False`` is refused.
      alg: a registry name (``"tsit5"``, ``"dopri5"``, ``"rodas5p"``,
        ``"rodas4"``, ``"rosenbrock23"``, ``"em"``, ``"platen_w2"``, ...),
        a `MethodSpec`, or a bare `Tableau` or `RosenbrockTableau`.
      ensemble: ``"vmap"``, ``"array"``, ``"array_eager"`` (erk only),
        ``"kernel"`` or ``"auto"``: measured dispatch, strategy, backend
        and lane_tile from the profile cache, or timed on this problem at
        first sight (`repro_torch.core.autotune`).
      backend: ``"torch"`` (the lanes twin) or ``"cuda"`` (the hand-written
        kernels: tsit5 and dopri5 on an RHS registered with `device_rhs`;
        em, heun_strat, platen_w2 and milstein, fixed-dt or adaptive, on a
        drift/diffusion pair registered with `device_sde`; rosenbrock23,
        rodas4 and rodas5p on an RHS registered with `device_stiff`) —
        kernel strategy only.
      t0, tf, dt0: time span (defaults from ``prob.tspan``) and initial
        step.  ``dt0=None`` derives it from Hairer's two-evaluation
        heuristic per trajectory, takes the ensemble minimum, and counts the
        2·N probe evaluations in ``nf``.
      saveat: snapshot time grid (S,), interpolated by dense output.
      rtol, atol: adaptive error-control tolerances.
      adaptive: None picks the method's default; False forces fixed dt;
        True on an SDE stepper runs adaptive steps on the virtual Brownian
        tree.
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
      brownian_depth: dyadic depth of the adaptive-SDE Brownian tree
        (None: `core.sde.default_bridge_depth`).
      error_est: the adaptive-SDE error estimator — ``"embedded"`` (the
        method's pair; the default where one ships and the noise is
        diagonal) or ``"doubling"``.
      w_reuse: the stiff family's lazy-W path: None takes the method's
        default (eager), True the default `WReusePolicy`, or a policy.  A
        truthy value on a non-stiff method raises.
      event: a `repro_torch.core.events.Event` — zero-crossing detection,
        bisection on the method's dense output, the affect and per-lane
        termination, on every family and strategy but ``"array_eager"``
        (and the erk ``"array"`` strategy's lock-step dt).  Terminal events
        record the located event time in ``t_final``.  The CUDA kernels
        run an event registered with `device_event`.
      sensitivity: gradients through the solve (paper §6.6).  None: a
        plain solve.  ``"forward"``: the plain loops, which
        `torch.func.jvp` crosses (`core.sensitivity.forward_sensitivity`);
        refused on ``backend="cuda"``.  ``"adjoint"``: the loops become
        their bounded, checkpointed form (`core.loops`) with the step-size
        controller detached, so `torch.autograd` gives the discrete adjoint
        of the realized step sequence with O(sqrt-steps) memory; on
        ``backend="cuda"`` the kernel runs the forward solve and the
        backward pass replays the plain version
        (`kernels.ensemble_kernel.kernel_adjoint`).  Gradients reach u0s,
        ps and a problem's table values; refused on ``"array_eager"`` and
        on a method declaring ``differentiable=False``.
      adjoint_steps: the bound on the adaptive attempt count for
        ``sensitivity="adjoint"`` (required for adaptive stepping:
        `core.sensitivity.suggest_adjoint_steps`); a bound too small
        reports ``status == 1``.  Fixed dt takes ``n_steps + 1``.
      checkpoint_every: loop iterations per checkpointed segment of the
        adjoint (default sqrt of the bound).
      device: where the solve runs.  None means ``"cuda"``.

    Returns:
      `EnsembleResult` with trajectory-major ``us (N, S, n)``.
    """
    spec = get_method(alg)
    if ensemble == "auto":
        # measured dispatch (`core.autotune`): a profile-cache hit, or a
        # one-off measurement of the capability-pruned candidates on this
        # problem
        from .autotune import resolve_auto
        dec = resolve_auto(eprob, spec, t0=t0, tf=tf, dt0=dt0, saveat=saveat,
                           rtol=rtol, atol=atol, adaptive=adaptive,
                           n_steps=n_steps, save_every=save_every,
                           max_iters=max_iters, event=event, key=key,
                           seed=seed, noise_table=noise_table,
                           error_est=error_est, w_reuse=w_reuse,
                           linsolve=linsolve, sensitivity=sensitivity,
                           device=device)
        ensemble, backend = dec.strategy, dec.backend
        if lane_tile is None:
            lane_tile = dec.lane_tile   # an explicit tile always wins
    if event is not None and not spec.events:
        raise ValueError(
            f"method {spec.name!r} declares events=False; pick a method whose "
            "MethodSpec supports event handling")
    if sensitivity is not None:
        # the rules of methods.valid_dispatch(sensitivity=...), with the
        # reference's words
        if sensitivity not in ("forward", "adjoint"):
            raise ValueError(f"unknown sensitivity {sensitivity!r} "
                             "(use 'forward' or 'adjoint')")
        if sensitivity not in spec.sensitivity:
            raise ValueError(
                f"method {spec.name!r} declares differentiable=False; its "
                "engines do not satisfy the AD contract")
        if ensemble == "array_eager":
            raise ValueError(
                "sensitivity through ensemble='array_eager' is not possible: "
                "the eager loop is host-driven python, not traceable")
        if sensitivity == "forward" and backend == "cuda":
            raise ValueError(
                "forward sensitivities ride jvp through the while-loop "
                "engines; the CUDA kernels support sensitivity='adjoint' "
                "(autograd.Function boundary) only — use backend='torch' for "
                "jvp")
    prob = eprob.prob
    dev = resolve_device(device)
    # data-driven RHS (`prob.data`, the texture-memory analogue): validate
    # it against the method, then bind the dataset over the callbacks once;
    # the CUDA branches receive `raw_prob` (4-argument callbacks) and pass
    # the tables as kernel arguments
    raw_prob = prob
    if getattr(prob, "data", None) is not None:
        if not spec.data_rhs:
            raise ValueError(
                f"method {spec.name!r} declares data_rhs=False; its engines "
                "cannot consume data-driven problems (prob.data)")
        leaves, tree = data_flatten(prob.data)
        raw_prob = dataclasses.replace(prob, data=data_unflatten(
            tree, [leaf.to(dev) for leaf in leaves]))
        prob = bind_problem_data(raw_prob)
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
                          save_every=save_every, lane_tile=lane_tile,
                          key=key, seed=seed, noise_table=noise_table,
                          adaptive=adaptive, rtol=rtol, atol=atol,
                          max_iters=max_iters, lane_offset=lane_offset,
                          brownian_depth=brownian_depth, error_est=error_est,
                          event=event, sensitivity=sensitivity,
                          adjoint_steps=adjoint_steps,
                          checkpoint_every=checkpoint_every,
                          raw_prob=raw_prob)
    if error_est is not None:
        raise ValueError(
            "error_est selects the adaptive SDE error estimator; "
            f"{spec.name!r} ({spec.family}) embeds via its tableau")
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
                                linsolve=linsolve, w_reuse=w_reuse,
                                event=event, sensitivity=sensitivity,
                                adjoint_steps=adjoint_steps,
                                checkpoint_every=checkpoint_every,
                                raw_prob=raw_prob)
    else:
        res = _solve_erk(spec, prob, u0s, ps, ensemble=ensemble,
                         backend=backend, t0=t0, tf=tf, dt0=dt0,
                         saveat=saveat, rtol=rtol, atol=atol,
                         adaptive=adaptive, n_steps=n_steps,
                         save_every=save_every, lane_tile=lane_tile,
                         max_iters=max_iters, event=event,
                         sensitivity=sensitivity,
                         adjoint_steps=adjoint_steps,
                         checkpoint_every=checkpoint_every,
                         raw_prob=raw_prob)
    if auto_dt_nf:
        res = res._replace(nf=res.nf + auto_dt_nf)
    return res
