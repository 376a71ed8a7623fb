"""Distributed ensemble solving — the paper's MPI composition (§6.3),
`repro.core.api` over a `torch.distributed` process group.

The trajectory axis is embarrassingly parallel: each rank of the group
solves its contiguous block of the ensemble through the fused local solve
(no collective inside it, the property the paper's CUDA-aware-MPI demo
exploits), and only the results' assembly and the moment reductions
(`ensemble_moments`) communicate.  The reference splits the axis over a
mesh with `shard_map`; here the caller runs one process a rank (e.g. with
``torchrun``, `repro_torch.launch.mesh.make_local_group`) and calls
`solve_ensemble` from every rank with the same problem.
"""
from __future__ import annotations

import dataclasses

import torch

from .ensemble import EnsembleResult, solve_ensemble_local
from .interp import data_flatten, data_unflatten
from .problem import EnsembleProblem

TUNE_ARGS = ("t0", "tf", "dt0", "saveat", "rtol", "atol", "adaptive",
             "n_steps", "save_every", "max_iters", "event", "key", "seed",
             "noise_table", "error_est", "w_reuse", "linsolve", "sensitivity",
             "device")


def _dist():
    import torch.distributed as dist
    return dist


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """`x` on a device the group's backend communicates from: the card for
    NCCL, the host for gloo."""
    if _dist().get_backend(group) == "nccl":
        return x if x.is_cuda else x.cuda()
    return x.cpu()


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    w = _wire(x.detach().clone(), group)
    _dist().all_reduce(w, op=op, group=group)
    return w.to(x.device)


class _Gather(torch.autograd.Function):
    """All-gather of each rank's block along the leading (trajectory) axis,
    in rank order.  Every rank differentiates the same global loss, so its
    block's cotangent is its slice of the global cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        dist = _dist()
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        w = _wire(x.detach().contiguous(), group)
        parts = [torch.empty_like(w)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, w, group=group)
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.n
        return g[lo:lo + ctx.n], None


class _Replicated(torch.autograd.Function):
    """A value every rank reads whole: rank 0's, broadcast; its gradient is
    the sum of every rank's contribution."""

    @staticmethod
    def forward(ctx, x, group):
        dist = _dist()
        ctx.group = group
        w = _wire(x.detach().clone().contiguous(), group)
        dist.broadcast(w, src=_src(group), group=group)
        return w.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, _dist().ReduceOp.SUM, ctx.group), None


def _src(group) -> int:
    """The global rank of the group's rank 0."""
    dist = _dist()
    return 0 if group is None or group is dist.group.WORLD \
        else dist.get_global_rank(group, 0)


def _group(group):
    return _dist().group.WORLD if group is True else group


def solve_ensemble(eprob: EnsembleProblem, group=None,
                   **kw) -> EnsembleResult:
    """Solve an ensemble, sharded over the ranks of `group`.

    ``group=None`` is `solve_ensemble_local`.  Otherwise (a process group,
    or True for the default group) every rank of the group calls it with
    the same problem and keywords: N must divide by the world size, and
    rank r solves trajectories [r·N/W, (r+1)·N/W) with every keyword of
    `solve_ensemble_local` (``alg``, ``ensemble``, ``backend``, ...).

    SDE counter-RNG streams are global: each rank's ``lane_offset`` (its
    first trajectory's global index, plus the caller's) is threaded into
    the local solve, so rank r draws the (seed; step, row, r·N/W + i)
    stream and the sharded solve equals the local one bit for bit.

    Dataset tables (``prob.data``) are broadcast from rank 0, never
    sharded: every rank solves its block against the same dataset.

    ``ensemble="auto"`` is resolved before the solve on rank 0 alone, on a
    local-block-sized slice (each rank solves N/W trajectories, the N whose
    crossover matters), and rank 0's decision is broadcast, so every rank
    dispatches one program.

    The result is global on every rank: the per-trajectory fields (us,
    u_final, t_final, and naccept/nreject where the strategy counts per
    trajectory) are all-gathered in rank order; nf, njac, nfact and batch
    counts are summed, status is the largest.  With
    ``sensitivity="adjoint"`` the gather is differentiable: a loss over the
    global result differentiates into this rank's own block of u0s and ps,
    and into the table values summed over the ranks.
    """
    if group is None:
        return solve_ensemble_local(eprob, **kw)
    dist = _dist()
    group = _group(group)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    u0s, ps = eprob.materialize()
    N = u0s.shape[0]
    assert N % world == 0, (
        f"trajectories {N} must divide over {world} ranks")
    n_local = N // world
    prob = eprob.prob
    base_offset = kw.pop("lane_offset", 0)

    data = getattr(prob, "data", None)
    if data is not None:
        leaves, tree = data_flatten(data)
        prob = dataclasses.replace(prob, data=data_unflatten(
            tree, [_Replicated.apply(leaf, group) for leaf in leaves]))

    if kw.get("ensemble") == "auto":
        from .autotune import Decision, broadcast_decision, resolve_auto
        from .methods import get_method
        if rank == 0:
            sub = EnsembleProblem(prob, n_local, u0s=u0s[:n_local],
                                  ps=ps[:n_local])
            dec = resolve_auto(sub, get_method(kw.get("alg", "tsit5")),
                               **{k: v for k, v in kw.items()
                                  if k in TUNE_ARGS})
        else:
            dec = Decision("kernel", "cuda", None, source="broadcast")
        dec = broadcast_decision(dec, group)
        kw = dict(kw, ensemble=dec.strategy, backend=dec.backend)
        if kw.get("lane_tile") is None:
            kw["lane_tile"] = dec.lane_tile

    lo = rank * n_local
    sub = EnsembleProblem(prob, n_local, u0s=u0s[lo:lo + n_local],
                          ps=ps[lo:lo + n_local])
    res = solve_ensemble_local(sub, lane_offset=base_offset + lo, **kw)

    SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX

    def gather(x):
        return _Gather.apply(x, group)

    def total(x, op=SUM):
        return _all_reduce(x, op, group) if torch.is_tensor(x) else x

    per_traj = torch.is_tensor(res.naccept) and res.naccept.dim() > 0
    counts = gather if per_traj else total
    return res._replace(
        us=gather(res.us), u_final=gather(res.u_final),
        t_final=gather(res.t_final), naccept=counts(res.naccept),
        nreject=counts(res.nreject), nf=total(res.nf),
        status=total(res.status, MAX), njac=total(res.njac),
        nfact=total(res.nfact))


def ensemble_moments(us, group=None):
    """Mean and variance over the trajectory axis: ``us`` (N, ...) whole,
    or, with a `group`, this rank's block of it (the SDE Monte-Carlo
    reduction, §6.8).

    The variance is the centered two-pass form (all-reduce the mean first,
    then the squared deviations): the one-pass ``E[X²] − mean²`` loses
    about 2·log10(mean/std) digits to cancellation, all of them for an f32
    GBM ensemble at large drift.  The clamp at 0 guards the rounding of
    the centered sum."""
    if group is None:
        return us.mean(dim=0), torch.clamp_min(us.var(dim=0, unbiased=False),
                                               0)
    dist = _dist()
    group = _group(group)
    SUM = dist.ReduceOp.SUM
    s1 = _all_reduce(us.sum(dim=0), SUM, group)
    n = _all_reduce(torch.tensor(float(us.shape[0]), dtype=us.dtype,
                                 device=us.device), SUM, group)
    mean = s1 / n
    d = us - mean[None]
    s2c = _all_reduce((d * d).sum(dim=0), SUM, group)
    return mean, torch.clamp_min(s2c / n, 0)


def solve_ensemble_elastic(eprob: EnsembleProblem, alg="tsit5", *,
                           ckpt_dir: str, n_shards: int = 2,
                           resume: bool = False, chaos=None, **kw):
    """Fault-tolerant segmented ensemble solve — the elastic face of the
    front door (`repro.core.api.solve_ensemble_elastic`).

    Wraps `repro_torch.dist.elastic.ElasticSupervisor`: the run advances in
    bounded segments with periodic host-gathered carry snapshots through
    the atomic checkpoint layer, survives shard loss by re-sharding the
    unfinished tiles over the survivors (degradation ladder down to a
    single host, then a partial result with per-lane
    ``status == STATUS_SHARD_LOST``), and ``resume=True`` restores the
    newest snapshot — onto ANY `n_shards`, in the same process or a
    relaunched one.  A killed-and-resumed run is bitwise identical to an
    uninterrupted one (tests/test_torch_elastic.py SIGKILLs a run).

    Returns `repro_torch.dist.elastic.ElasticResult` (host numpy per-lane
    finals + a fault-history report), not an `EnsembleResult`: elasticity
    is a host-side supervision loop by construction.

    Keyword args beyond the supervisor's (tile_width, segment_steps,
    snapshot_every, max_failures, backoff_*, backend, device, ...) mirror
    `solve_ensemble_local` (t0, tf, dt0, n_steps, adaptive, rtol, atol,
    event, seed, lane_offset, max_iters, ...).
    """
    from repro_torch.dist.elastic import ElasticSupervisor
    sup = ElasticSupervisor(eprob, alg, ckpt_dir=ckpt_dir,
                            n_shards=n_shards, chaos=chaos, **kw)
    return sup.run(resume=resume)
