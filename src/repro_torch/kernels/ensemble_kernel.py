"""Launch-and-assemble layer of the fused ensemble kernels — the PyTorch
counterpart of `repro.kernels.ensemble_kernel` for the erk, rosenbrock and
fixed-dt sde families.

The reference's TPU factory tiles lanes into VMEM blocks; on the H100 each
trajectory is one CUDA thread, so there is no tile to choose here.  What
stays is the layout contract — trajectory-major (N, n) in, lane-major
(n, N) through the kernel, an `EnsembleResult` out — and the saveat-
segmented multi-launch driver with its ``save_chunks=`` API.  The
segment count keeps the reference's rule (`save_chunk_count`), so the port
splits a save grid exactly where the reference does and returns the same
numbers.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

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


def erk_body(f, tab, *, t0: float, tf: float, dt0: float, rtol: float,
             atol: float, adaptive: bool, max_iters: int) -> Callable:
    """The kernel's parameters bound into one launch:
    ``body(u0 (n, N), p (m, N), extras) -> (us, u_final, t_final, stats)``
    in the lane-major layout; extras[0] is the saveat grid (S,)."""
    from repro_torch.kernels.tsit5.kernel import erk_ensemble

    def body(u0, p, extras):
        return erk_ensemble(f, tab, u0, p, extras[0], t0=t0, tf=tf, dt0=dt0,
                            rtol=rtol, atol=atol, adaptive=adaptive,
                            max_iters=max_iters)

    return body


def rosenbrock_body(f, rtab, *, jac, t0: float, tf: float, dt0: float,
                    rtol: float, atol: float, max_iters: int,
                    w_reuse) -> Callable:
    """s-stage Rosenbrock stiff integration (rosenbrock23, rodas4, rodas5p)
    with the per-lane LU of W = I − γh·J inline, eager or lazy-W
    (`w_reuse`); `jac` is the problem's analytic Jacobian hook.  extras[0]
    is the saveat grid (S,)."""
    from repro_torch.kernels.rosenbrock.kernel import rosenbrock_ensemble

    def body(u0, p, extras):
        return rosenbrock_ensemble(f, rtab, u0, p, extras[0], jac=jac, t0=t0,
                                   tf=tf, dt0=dt0, rtol=rtol, atol=atol,
                                   max_iters=max_iters, w_reuse=w_reuse)

    return body


def sde_body(f, g, method: str, noise: str, *, t0: float, dt: float,
             n_steps: int, save_every: int, m_noise: int, seed: int,
             lane_offset: int, use_table: bool) -> Callable:
    """Fixed-dt SDE integration with the in-kernel Threefry stream keyed by
    (seed; step, noise-row, lane_offset + lane), or a pre-drawn table:
    extras[0] ("lanes", (n_steps, m, N)) when `use_table`.  `method` names
    the stepper (`core.sde.SDE_STEPPERS`)."""
    from repro_torch.kernels.em.kernel import sde_ensemble

    def body(u0, p, extras):
        return sde_ensemble(f, g, method, u0, p, noise=noise,
                            m_noise=m_noise, t0=t0, dt=dt, n_steps=n_steps,
                            save_every=save_every, seed=seed,
                            lane_offset=lane_offset,
                            table=extras[0] if use_table else None)

    return body


# extras are (kind, tensor) with kind:
#   "broadcast" — identical for every lane (the saveat grid)
#   "lanes"     — (..., N), one column per trajectory (noise tables)
# The reference's "table" kind (dataset tables) waits for ROADMAP queue 2
# item 7.
Extra = Tuple[str, torch.Tensor]


def run_ensemble_kernel(body: Callable, u0s, ps, *, ts,
                        extras: Sequence[Extra] = ()):
    """Launch `body` over the ensemble and assemble an EnsembleResult.

    u0s (N, n), ps (N, m) trajectory-major; ts (S,) the result's save-time
    grid; `extras` reach the body, in order, as contiguous tensors."""
    from repro_torch.core.ensemble import EnsembleResult

    N = u0s.shape[0]
    ex = []
    for kind, arr in extras:
        if kind not in ("broadcast", "lanes"):
            raise ValueError(f"unknown extra kind {kind!r}")
        arr = torch.as_tensor(arr).contiguous()
        if kind == "lanes" and arr.shape[-1] != N:
            raise ValueError(f"a 'lanes' extra needs N={N} columns, got "
                             f"shape {tuple(arr.shape)}")
        ex.append(arr)
    us, uf, t_fin, stats = body(u0s.T.contiguous(), ps.T.contiguous(),
                                tuple(ex))
    return EnsembleResult(
        ts=ts, us=us.permute(2, 0, 1), u_final=uf.T, t_final=t_fin,
        naccept=stats[0], nreject=stats[1], nf=stats[3].sum(),
        status=stats[2].max(), njac=stats[4].sum(), nfact=stats[5].sum())


def run_ensemble_kernel_staged(body_factory: Callable, u0s, ps, *, ts,
                               save_chunks: int):
    """Segmented launch: the save grid (ascending, all > t0) is split into
    `save_chunks` segments, one launch each; `u_final` and the step counters
    thread between them.  `body_factory(t_start, seg_ts, last)` returns
    ``(body, extras)`` for a segment that restarts integration at the
    previous segment's endpoint.

    Fixed-dt runs whose segment boundaries land on the step grid are
    bitwise-identical to one launch; adaptive runs restart the controller at
    each boundary, so they agree to solver accuracy, not bitwise."""
    ts_np = ts.cpu().numpy()
    S = int(ts_np.shape[0])
    save_chunks = int(max(1, min(save_chunks, S)))
    segs = [idx for idx in np.array_split(np.arange(S), save_chunks)
            if idx.size]

    u_cur = u0s
    parts, acc = [], None
    for k, idx in enumerate(segs):
        t_start = float(ts_np[idx[0] - 1]) if k else None  # None: problem t0
        body, extras = body_factory(t_start, ts_np[idx], k == len(segs) - 1)
        seg_ts = torch.as_tensor(ts_np[idx], dtype=ts.dtype, device=ts.device)
        res = run_ensemble_kernel(body, u_cur, ps, ts=seg_ts, extras=extras)
        u_cur = res.u_final
        parts.append(res.us)
        if acc is None:
            acc = res
        else:
            acc = acc._replace(
                u_final=res.u_final, t_final=res.t_final,
                naccept=acc.naccept + res.naccept,
                nreject=acc.nreject + res.nreject,
                nf=acc.nf + res.nf, njac=acc.njac + res.njac,
                nfact=acc.nfact + res.nfact,
                status=torch.maximum(acc.status, res.status))
    return acc._replace(ts=ts, us=torch.cat(parts, dim=1))
