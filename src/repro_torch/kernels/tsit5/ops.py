"""Public wrapper for the fused explicit-RK ensemble kernel — the
counterpart of `repro.kernels.tsit5.ops.solve_ensemble_pallas`.

It binds the problem into the kernel's parameters (`erk_body`) and, when
the save grid is large, routes through the saveat-segmented driver
(`run_ensemble_kernel_staged`) exactly where the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core.ensemble import EnsembleResult
from repro_torch.core.tableaus import Tableau
from repro_torch.kernels.ensemble_kernel import (data_extras, erk_body,
                                                 erk_work_words,
                                                 run_ensemble_kernel,
                                                 run_ensemble_kernel_staged,
                                                 save_chunk_count)


def solve_ensemble_cuda(prob, u0s, ps, tab: Tableau, t0, tf, dt0, saveat,
                        rtol, atol, adaptive, max_iters=100_000,
                        save_chunks=None, event=None,
                        data=None) -> EnsembleResult:
    """EnsembleGPUKernel entry point (``ensemble="kernel"``,
    ``backend="cuda"``).  u0s (N, n), ps (N, m) and saveat (S,) on one
    device: CUDA tensors launch the kernel, CPU tensors run its plain twin.

    `save_chunks=None` takes the reference's segment count; pass an explicit
    count to force (or `1` to forbid) staging.  Staging needs an ascending
    save grid of more than one point, all after t0, and no event (a
    terminated lane cannot thread between segments), as in the reference.
    With a dataset (`data`, which ``prob.f`` takes as a fourth argument)
    every launch receives its tables.
    """
    saveat = torch.as_tensor(saveat, dtype=u0s.dtype, device=u0s.device)
    work_words = erk_work_words(u0s.shape[1], ps.shape[1], tab.stages)
    if save_chunks is None:
        save_chunks = save_chunk_count(u0s.shape[1], ps.shape[1],
                                       int(saveat.shape[0]),
                                       itemsize=u0s.element_size(),
                                       work_words=work_words)

    def mk_body(t_start, t_end):
        return erk_body(prob.f, tab, t0=float(t_start), tf=float(t_end),
                        dt0=float(dt0), rtol=float(rtol), atol=float(atol),
                        adaptive=adaptive, max_iters=max_iters, event=event,
                        data=data)

    tables = data_extras(data)

    stageable = (save_chunks > 1 and event is None and saveat.shape[0] > 1
                 and bool(saveat[0] > t0)
                 and bool((saveat[1:] > saveat[:-1]).all()))
    if stageable:
        def body_factory(t_start, seg_ts, last):
            seg_t0 = t0 if t_start is None else t_start
            seg_tf = tf if last else float(seg_ts[-1])
            sv = torch.as_tensor(seg_ts, dtype=u0s.dtype, device=u0s.device)
            return mk_body(seg_t0, seg_tf), [("broadcast", sv)] + tables

        return run_ensemble_kernel_staged(body_factory, u0s, ps, ts=saveat,
                                          save_chunks=save_chunks)

    return run_ensemble_kernel(mk_body(t0, tf), u0s, ps, ts=saveat,
                               extras=[("broadcast", saveat)] + tables)
