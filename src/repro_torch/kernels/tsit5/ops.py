"""Public wrapper for the fused explicit-RK ensemble kernel — the
counterpart of `repro.kernels.tsit5.ops.solve_ensemble_pallas`.

It binds the problem into the kernel's parameters (`erk_body`) and, when
the save grid is large, routes through the saveat-segmented driver
(`run_ensemble_kernel_staged`, its launches in one call:
`erk_staged_body`) exactly where the reference does.  The
grid's order and the segments' boundaries are read on the host, before
the grid goes to the card, so a solve given its grid on the host reads
nothing back from the card.  An RHS without a registration (or a user
tableau) stages the same way: its generated translation unit exports the
staged entry too, so its k launches also go in one C call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ensemble import EnsembleResult
from repro_torch.core.tableaus import Tableau
from repro_torch.kernels.ensemble_kernel import (data_extras, erk_body,
                                                 erk_staged_body,
                                                 erk_work_words, refuse_grad,
                                                 run_ensemble_kernel,
                                                 run_ensemble_kernel_staged,
                                                 save_chunk_count)


def save_grid(saveat, like: torch.Tensor):
    """(the grid on `like`'s device in its dtype, its values on the host):
    a grid on the host (a list, an array or a CPU tensor) goes to the card
    through pinned memory, in a copy the host does not wait for; a grid on
    the card is read back once."""
    if torch.is_tensor(saveat) and saveat.device.type != "cpu":
        grid = saveat.to(device=like.device, dtype=like.dtype)
        return grid, grid.cpu().numpy()
    host = torch.as_tensor(saveat, dtype=like.dtype)
    if like.device.type != "cuda":
        return host.to(like.device), host.numpy()
    return host.pin_memory().to(like.device, non_blocking=True), host.numpy()


def solve_ensemble_cuda(prob, u0s, ps, tab: Tableau, t0, tf, dt0, saveat,
                        rtol, atol, adaptive, max_iters=100_000,
                        save_chunks=None, event=None,
                        data=None) -> EnsembleResult:
    """EnsembleGPUKernel entry point (``ensemble="kernel"``,
    ``backend="cuda"``).  u0s (N, n) and ps (N, m) on one device, saveat
    (S,) on the host or on that device: CUDA tensors launch the kernel,
    CPU tensors run its plain twin.

    `save_chunks=None` takes the reference's segment count; pass an explicit
    count to force (or `1` to forbid) staging.  Staging needs an ascending
    save grid of more than one point, all after t0, and no event (a
    terminated lane cannot thread between segments), as in the reference.
    With a dataset (`data`, which ``prob.f`` takes as a fourth argument)
    every launch receives its tables.
    """
    grid, host = save_grid(saveat, u0s)
    if u0s.device.type == "cuda" and not bool(np.all(host[1:] >= host[:-1])):
        raise ValueError("the CUDA kernel needs an ascending saveat grid")
    work_words = erk_work_words(u0s.shape[1], ps.shape[1], tab.stages)
    if save_chunks is None:
        save_chunks = save_chunk_count(u0s.shape[1], ps.shape[1],
                                       int(host.shape[0]),
                                       itemsize=u0s.element_size(),
                                       work_words=work_words)

    tables = data_extras(data)
    stageable = (save_chunks > 1 and event is None and host.shape[0] > 1
                 and bool(host[0] > t0)
                 and bool(np.all(host[1:] > host[:-1])))
    if stageable:
        refuse_grad("the ensemble kernel", *(leaf for _, leaf in tables))
        body = erk_staged_body(prob.f, tab, dt0=float(dt0),
                               rtol=float(rtol), atol=float(atol),
                               adaptive=adaptive, max_iters=max_iters,
                               data=data)
        return run_ensemble_kernel_staged(body, u0s, ps, ts=grid,
                                          save_chunks=save_chunks, t0=t0,
                                          tf=tf, ts_host=host)

    body = erk_body(prob.f, tab, t0=float(t0), tf=float(tf), dt0=float(dt0),
                    rtol=float(rtol), atol=float(atol), adaptive=adaptive,
                    max_iters=max_iters, event=event, data=data)
    return run_ensemble_kernel(body, u0s, ps, ts=grid,
                               extras=[("broadcast", grid)] + tables)
