"""Public entry of the fused Rosenbrock stiff ensemble kernel.

The reference has no such module: its stiff kernel is the generic TPU
factory `repro.kernels.ensemble_kernel.run_ensemble_kernel` specialised
with `rosenbrock_body` (`repro.core.ensemble._solve_rosenbrock`, ensemble
"kernel", backend "pallas").  This module stands for that call: it binds
the problem into the kernel's parameters (`rosenbrock_body`) and hands the
launch to the generic layer.
"""
from __future__ import annotations

from repro_torch.core.ensemble import EnsembleResult
from repro_torch.kernels.ensemble_kernel import (rosenbrock_body,
                                                 run_ensemble_kernel)


def solve_rosenbrock_cuda(prob, u0s, ps, rtab, *, t0, tf, dt0, saveat, rtol,
                          atol, max_iters=100_000, jac=None,
                          w_reuse=None) -> EnsembleResult:
    """EnsembleGPUKernel for the stiff family (``ensemble="kernel"``,
    ``backend="cuda"``).  u0s (N, n), ps (N, m) and saveat (S,) on one
    device: CUDA tensors launch the kernel, CPU tensors run its plain
    version."""
    body = rosenbrock_body(prob.f, rtab, jac=jac, t0=float(t0),
                           tf=float(tf), dt0=float(dt0), rtol=float(rtol),
                           atol=float(atol), max_iters=int(max_iters),
                           w_reuse=w_reuse)
    return run_ensemble_kernel(body, u0s, ps, ts=saveat,
                               extras=[("broadcast", saveat)])
