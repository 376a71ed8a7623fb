"""The divergence measure that decides where the trajectory work queue of
the adaptive ensemble kernels (`csrc/trajectory_queue.cuh`) pays.

A kernel on the queue runs a persistent grid: a thread starts on
trajectory blockIdx.x·blockDim.x + threadIdx.x and, each time its
trajectory ends, takes the next index from a device counter (one int32
word the wrapper zeroes), so no lane idles behind a slower one but at the
tail of the run.  The adaptive SDE kernel takes every trajectory from it;
the stiff kernel, whose rows all measured an efficiency above 0.95, runs
one trajectory a thread.

`simt_efficiency` is the share of a warp's issue slots that do a
trajectory's work when every thread runs one trajectory and a warp runs as
long as its slowest lane: Σ attempts / Σ over warps of 32·max attempts,
warps of 32 consecutive lanes.  It is computed from a run's per-lane stats
(naccept + nreject), here rather than in the kernel, so the CPU can test
it.
"""
from __future__ import annotations

import torch

WARP = 32


def simt_efficiency(attempts: torch.Tensor, warp: int = WARP) -> float:
    """Σ attempts / Σ over warps of warp·max attempts, for per-lane attempt
    counts (N,) laid out one lane a thread; a last partial warp is padded
    with idle lanes.  1.0 where no lane made an attempt."""
    a = attempts.reshape(-1).to(torch.float64)
    pad = (-a.numel()) % warp
    if pad:
        a = torch.cat([a, a.new_zeros(pad)])
    worst = a.reshape(-1, warp).max(dim=1).values.sum() * warp
    if float(worst) == 0.0:
        return 1.0
    return float(a.sum() / worst)
