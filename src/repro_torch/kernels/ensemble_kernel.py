"""Launch-and-assemble layer of the fused ensemble kernels — the PyTorch
counterpart of `repro.kernels.ensemble_kernel` for the erk, rosenbrock,
fixed-dt sde and adaptive sde families.

The reference's TPU factory tiles lanes into VMEM blocks; on the H100 each
trajectory is one CUDA thread, so there is no tile to choose here.  What
stays is the layout contract — trajectory-major (N, n) in, lane-major
(n, N) through the kernel, an `EnsembleResult` out — and the saveat-
segmented multi-launch driver with its ``save_chunks=`` API.  A dataset
(``prob.data``) reaches a body as "table" extras, one per leaf in
`data_flatten`'s order, at the tail of the extras; `_data_binder` rebuilds
the tables from them and the body hands them to its wrapper.  The
segment count keeps the reference's rule (`save_chunk_count`), so the port
splits a save grid exactly where the reference does and returns the same
numbers.

`kernel_adjoint` carries reverse mode across the kernel boundary: the
kernels write their outputs through raw pointers, outside autograd, so a
launch refuses inputs that require grad unless it runs inside it.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.interp import data_flatten, data_unflatten

# the reference's §5.2 budget: half of a 16 MB TPU VMEM, in 128-lane tiles;
# kept only so that `save_chunk_count` segments as the reference does
DEFAULT_SEGMENT_BUDGET = 8 * 1024 * 1024
LANE_WIDTH = 128


def erk_work_words(n_state: int, n_param: int, stages: int) -> int:
    """Per-trajectory working words of the erk loop (state, stages, params,
    control)."""
    return (stages + 4) * n_state + n_param + 16


def save_chunk_count(n_state: int, n_param: int, n_save: int, *,
                     itemsize: int = 4, work_words: Optional[int] = None) -> int:
    """How many saveat segments the staged driver runs (1 = no staging):
    the reference's count, so both packages segment alike."""
    if work_words is None:
        work_words = 12 * n_state + n_param + 16
    per_lane_words = DEFAULT_SEGMENT_BUDGET // (LANE_WIDTH * itemsize)
    max_saves = (per_lane_words - work_words) // (2 * n_state)
    if max_saves >= n_save:
        return 1
    return int(-(-n_save // max(1, max_saves)))


def _data_binder(data) -> Callable:
    """``bind(extras) -> dataset``: the tables rebuilt from the last
    ``len(leaves)`` extras (the "table" extras of `data`'s leaves), or None
    without data — the reference's `_data_binder`."""
    if data is None:
        return lambda extras: None
    leaves, tree = data_flatten(data)
    k = len(leaves)
    return lambda extras: data_unflatten(
        tree, tuple(extras[len(extras) - k:]) if k else ())


def data_extras(data) -> list:
    """The "table" extras of a dataset: one per leaf, in `data_flatten`'s
    order (none without data)."""
    return [("table", leaf) for leaf in data_flatten(data)[0]]


def erk_body(f, tab, *, t0: float, tf: float, dt0: float, rtol: float,
             atol: float, adaptive: bool, max_iters: int,
             event=None, data=None) -> Callable:
    """The kernel's parameters bound into one launch:
    ``body(u0 (n, N), p (m, N), extras) -> (us, u_final, t_final, stats)``
    in the lane-major layout; extras[0] is the saveat grid (S,), which the
    caller has checked to ascend on the host
    (`kernels.tsit5.ops.solve_ensemble_cuda`).  Every body takes an
    optional `Event`, detected, located and applied inside the kernel's
    loop, and an optional dataset (`data`, whose leaves are the last
    extras; `f` then takes it as a fourth argument)."""
    from repro_torch.kernels.tsit5.kernel import _erk_ensemble
    bind = _data_binder(data)

    def body(u0, p, extras):
        return _erk_ensemble(f, tab, u0, p, extras[0], t0=t0, tf=tf,
                             dt0=dt0, rtol=rtol, atol=atol,
                             adaptive=adaptive, max_iters=max_iters,
                             event=event, data=bind(extras),
                             grid_checked=True)

    return body


def erk_staged_body(f, tab, *, dt0: float, rtol: float, atol: float,
                    adaptive: bool, max_iters: int, data=None) -> Callable:
    """K2's launches of K1 over the segments of a save grid:
    ``body(u0 (n, N), p (m, N), ts (S,), segments) -> (us, u_final,
    t_final, stats (k, 6, N))`` (`kernels.tsit5.kernel.erk_ensemble_staged`;
    no event: a terminated lane cannot thread between segments)."""
    from repro_torch.kernels.tsit5.kernel import erk_ensemble_staged

    def body(u0, p, ts, segments):
        return erk_ensemble_staged(f, tab, u0, p, ts, segments, dt0=dt0,
                                   rtol=rtol, atol=atol, adaptive=adaptive,
                                   max_iters=max_iters, data=data)

    return body


def rosenbrock_body(f, rtab, *, jac, t0: float, tf: float, dt0: float,
                    rtol: float, atol: float, max_iters: int,
                    w_reuse, event=None, data=None) -> Callable:
    """s-stage Rosenbrock stiff integration (rosenbrock23, rodas4, rodas5p)
    with the per-lane LU of W = I − γh·J inline, eager or lazy-W
    (`w_reuse`); `jac` is the problem's analytic Jacobian hook.  extras[0]
    is the saveat grid (S,); a dataset's leaves are the last extras."""
    from repro_torch.kernels.rosenbrock.kernel import rosenbrock_ensemble
    bind = _data_binder(data)

    def body(u0, p, extras):
        return rosenbrock_ensemble(f, rtab, u0, p, extras[0], jac=jac, t0=t0,
                                   tf=tf, dt0=dt0, rtol=rtol, atol=atol,
                                   max_iters=max_iters, w_reuse=w_reuse,
                                   event=event, data=bind(extras))

    return body


def sde_body(f, g, method: str, noise: str, *, t0: float, dt: float,
             n_steps: int, save_every: int, m_noise: int, seed: int,
             lane_offset: int, use_table: bool, event=None,
             data=None) -> Callable:
    """Fixed-dt SDE integration with the in-kernel Threefry stream keyed by
    (seed; step, noise-row, lane_offset + lane), or a pre-drawn table:
    extras[0] ("lanes", (n_steps, m, N)) when `use_table`.  `method` names
    the stepper (`core.sde.SDE_STEPPERS`); a dataset's leaves are the last
    extras."""
    from repro_torch.kernels.em.kernel import sde_ensemble
    bind = _data_binder(data)

    def body(u0, p, extras):
        return sde_ensemble(f, g, method, u0, p, noise=noise,
                            m_noise=m_noise, t0=t0, dt=dt, n_steps=n_steps,
                            save_every=save_every, seed=seed,
                            lane_offset=lane_offset,
                            table=extras[0] if use_table else None,
                            event=event, data=bind(extras))

    return body


def sde_adaptive_body(f, g, method: str, noise: str, *, t0: float, tf: float,
                      dt0: float, rtol: float, atol: float, max_iters: int,
                      m_noise: int, seed: int, depth: int, order: float,
                      error_est: str, est_order: int, nf_per_attempt: int,
                      lane_offset: int, event=None, data=None) -> Callable:
    """Adaptive SDE integration with embedded-pair or step-doubling error
    control on the virtual Brownian tree of depth `depth`, keyed by
    (seed; lane_offset + lane, row, dyadic index).  `method` names the
    stepper (`core.sde.SDE_STEPPERS`); extras[0] is the saveat grid (S,),
    and a dataset's leaves are the last extras."""
    from repro_torch.kernels.em.adaptive import sde_adaptive_ensemble
    bind = _data_binder(data)

    def body(u0, p, extras):
        return sde_adaptive_ensemble(
            f, g, method, u0, p, extras[0], noise=noise, m_noise=m_noise,
            t0=t0, tf=tf, dt0=dt0, rtol=rtol, atol=atol,
            max_iters=max_iters, seed=seed, depth=depth, order=order,
            error_est=error_est, est_order=est_order,
            nf_per_attempt=nf_per_attempt, lane_offset=lane_offset,
            event=event, data=bind(extras))

    return body


# extras are (kind, tensor) with kind:
#   "broadcast" — identical for every lane (the saveat grid)
#   "lanes"     — (..., N), one column per trajectory (noise tables)
#   "table"     — one dataset leaf, read by every lane: passed contiguous
#                 in its own shape (the reference flattens it to a (1, K)
#                 row for a VMEM block and reshapes it in the body)
Extra = Tuple[str, torch.Tensor]


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a kernel launch: the kernels write
    their outputs outside autograd, so a loss would silently miss the
    solve's share of a gradient (the reference's `jax.grad` fails on a bare
    `pallas_call` for the same reason).  Inside `kernel_adjoint` the
    launch runs with grad disabled and passes."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{what}: an input requires grad, and the CUDA kernels are not "
            "differentiable by themselves; pass sensitivity=\"adjoint\" (the "
            "kernel_adjoint boundary, which replays the plain version in the "
            "backward pass) or detach the inputs")


def _lane_extras(extras: Sequence[Extra], N: int) -> tuple:
    """The extras as the bodies take them: contiguous tensors, in order."""
    ex = []
    for kind, arr in extras:
        if kind not in ("broadcast", "lanes", "table"):
            raise ValueError(f"unknown extra kind {kind!r}")
        arr = torch.as_tensor(arr).contiguous()
        if kind == "lanes" and arr.shape[-1] != N:
            raise ValueError(f"a 'lanes' extra needs N={N} columns, got "
                             f"shape {tuple(arr.shape)}")
        ex.append(arr)
    return tuple(ex)


def _result(ts, us, uf, t_fin, stats):
    """An EnsembleResult from a lane-major launch's outputs, stats (6, N)
    the per-lane counters."""
    from repro_torch.core.ensemble import EnsembleResult
    return EnsembleResult(
        ts=ts, us=us.permute(2, 0, 1), u_final=uf.T, t_final=t_fin,
        naccept=stats[0], nreject=stats[1], nf=stats[3].sum(),
        status=stats[2].max(), njac=stats[4].sum(), nfact=stats[5].sum())


def run_ensemble_kernel(body: Callable, u0s, ps, *, ts,
                        extras: Sequence[Extra] = ()):
    """Launch `body` over the ensemble and assemble an EnsembleResult.

    u0s (N, n), ps (N, m) trajectory-major; ts (S,) the result's save-time
    grid; `extras` reach the body, in order, as contiguous tensors.  Inputs
    that require grad are refused (`refuse_grad`) on every device, the
    plain version included, as the kernel path must not be differentiated
    outside `kernel_adjoint`."""
    refuse_grad("the ensemble kernel", u0s, ps,
                *(arr for _, arr in extras))
    ex = _lane_extras(extras, u0s.shape[0])
    return _result(ts, *body(u0s.T.contiguous(), ps.T.contiguous(), ex))


def save_segments(host: Sequence[float], save_chunks: int, t0: float,
                  tf: float):
    """``(t0s, tfs, starts)`` of the staged driver's segments of a save
    grid (its values on the host, ascending, all > t0): `save_chunks`
    segments as `np.array_split` cuts them (the first S % k one save
    longer), each restarting at its predecessor's last save (the first at
    t0) and ending at its own last save (the last at tf); ``starts`` has
    k + 1 entries, the last S."""
    S = len(host)
    k = int(max(1, min(save_chunks, S)))
    starts = [i * (S // k) + min(i, S % k) for i in range(k + 1)]
    t0s = [float(t0)] + [float(host[a - 1]) for a in starts[1:-1]]
    tfs = [float(host[b - 1]) for b in starts[1:-1]] + [float(tf)]
    return t0s, tfs, starts


def run_ensemble_kernel_staged(staged_body: Callable, u0s, ps, *, ts,
                               save_chunks: int, t0: float, tf: float,
                               ts_host=None):
    """Segmented launch: the save grid ts (S,) (ascending, all > t0) is
    split into `save_chunks` segments (`save_segments`), one launch each;
    `u_final` and the step counters thread between them, as the
    reference's driver threads them.  ``staged_body(u0 (n, N), p (m, N),
    ts, segments)`` launches them all (`erk_staged_body`: in one call on
    the card) and returns ``(us, u_final, t_final, stats (k, 6, N))``.

    The segment boundaries come from `ts_host`, the grid's values on the
    host (read from ts once where not given), so a grid handed over on the
    host costs no read of the card.  u0 and p go lane-major once; each
    launch's u_final is the next one's u0 as it is, each writes its saves
    into its slice of one (S, n, N) output and its stats into its block
    of one (k, 6, N) output, whose counters are summed (status: the
    largest) on the card.

    Fixed-dt runs whose segment boundaries land on the step grid are
    bitwise-identical to one launch; adaptive runs restart the controller at
    each boundary, so they agree to solver accuracy, not bitwise."""
    refuse_grad("the ensemble kernel", u0s, ps)
    host = (ts.cpu() if ts_host is None else ts_host).tolist()
    segments = save_segments(host, save_chunks, t0, tf)
    us, uf, t_fin, block = staged_body(u0s.T.contiguous(),
                                       ps.T.contiguous(), ts, segments)
    stats = block.sum(dim=0, dtype=torch.int32)
    stats[2] = block.select(1, 2).amax(dim=0)
    return _result(ts, us, uf, t_fin, stats)


# the EnsembleResult fields that cross the `kernel_adjoint` boundary: the
# state outputs carry gradients, the rest are non-differentiable outputs
_DIFF_FIELDS = ("us", "u_final")
_NONDIFF_FIELDS = ("t_final", "naccept", "nreject", "nf", "status", "njac",
                   "nfact")


class _KernelAdjoint(torch.autograd.Function):
    """Forward: the kernel on detached inputs.  Backward: the bounded,
    checkpointed plain version replayed under autograd."""

    @staticmethod
    def forward(ctx, primal_fn, replay_fn, box, u0s, ps, *leaves):
        res = primal_fn(u0s.detach(), ps.detach(),
                        *(leaf.detach() for leaf in leaves))
        box["res"] = res
        ctx.replay_fn = replay_fn
        ctx.save_for_backward(u0s, ps, *leaves)
        tens = [name for name in _NONDIFF_FIELDS
                if torch.is_tensor(getattr(res, name))]
        box["nondiff"] = tens
        outs = [getattr(res, name) for name in _DIFF_FIELDS + tuple(tens)]
        ctx.mark_non_differentiable(*outs[len(_DIFF_FIELDS):])
        return tuple(outs)

    @staticmethod
    def backward(ctx, ct_us, ct_uf, *_):
        # an unused output's cotangent arrives as zeros (materialized)
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(nd)
                  for x, nd in zip(ctx.saved_tensors, need)]
            res = ctx.replay_fn(*xs)
            got = iter(torch.autograd.grad(
                (res.us, res.u_final), [x for x, nd in zip(xs, need) if nd],
                (ct_us, ct_uf), allow_unused=True))
        grads = [next(got) if nd else None for nd in need]
        grads = [torch.zeros_like(x) if nd and g is None else g
                 for x, nd, g in zip(xs, need, grads)]
        return (None, None, None) + tuple(grads)


def kernel_adjoint(primal_fn: Callable, replay_fn: Callable) -> Callable:
    """Reverse mode across the kernel boundary — the port of the
    reference's `jax.custom_vjp` factory, as a `torch.autograd.Function`.

    The kernels write their outputs outside autograd, so the FORWARD solve
    stays on the kernel (``primal_fn``, run on detached inputs with grad
    disabled) and the backward pass re-runs the kernel's plain version
    (``replay_fn`` — the bounded, checkpointed `core.loops.solver_loop`
    path of the same family) under autograd.  The forward pass keeps only
    the inputs; the replay's checkpointed segments bound the backward
    pass's memory (one carry per segment, recompute inside segments), so
    peak memory stays O(sqrt-steps).  SDE replays are exact: the
    counter-RNG noise is a pure function of (seed; step or grid index, row,
    global lane), so the recomputed path is the path the kernel integrated.

    Both callables map ``(u0s, ps, *leaves) -> EnsembleResult``; the
    variadic tail holds a data-driven problem's table leaves, real inputs
    of the Function, so gradients reach measured data too.  Gradients flow
    through the state outputs ``us`` and ``u_final``; the solver statistics
    and ``t_final`` (a terminal event's located time) are
    non-differentiable outputs.  Returns ``run(u0s, ps, *leaves) ->
    EnsembleResult``."""

    def run(u0s, ps, *leaves):
        box = {}
        outs = _KernelAdjoint.apply(primal_fn, replay_fn, box, u0s, ps,
                                    *leaves)
        names = _DIFF_FIELDS + tuple(box["nondiff"])
        return box["res"]._replace(**dict(zip(names, outs)))

    return run
