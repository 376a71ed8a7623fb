"""Public batched-LU entry: (N, n, n) systems, lane-major for the kernel,
with the reference's contract for singular systems — the counterpart of
`repro.kernels.lu.ops`.

Systems whose pivot is exactly zero even after partial pivoting (the
kernel's per-system minimum |pivot| is 0 or NaN) are rerouted to the
reference solve (`repro_torch.kernels.lu.ref.ref_solve`); this is the
reference's documented behaviour for singular systems, not a fallback for a
failing kernel, and `rerouted` counts the systems it took.  The reference's
`lu_lane_tile` has no counterpart: its VMEM tile does not exist on the
card, where each system is one thread.
"""
from __future__ import annotations

from repro_torch.kernels.ensemble_kernel import refuse_grad

from .kernel import lu_solve
from .ref import ref_solve

# systems rerouted to the reference solve since the counter was last set to 0
rerouted = 0


def batched_solve(W, b, backend="cuda", pivot=True):
    """Solve W[i] x[i] = b[i] for all i. W (N, n, n), b (N, n) -> (N, n).

    ``backend="cuda"`` runs the LU kernel (`lu_solve`; its plain version on
    CPU tensors) with partial pivoting (``pivot=False`` turns it off), and
    the singular systems fall back to the reference solve, exactly where
    ``~(pivmin > 0)``; ``backend="torch"`` is the reference solve alone.
    The kernel path refuses inputs that require grad (`refuse_grad`)."""
    global rerouted
    if backend == "torch":
        return ref_solve(W, b)
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r} (use 'cuda' or "
                         "'torch')")
    refuse_grad("the batched LU kernel (linsolve='cuda')", W, b)
    x, pivmin = lu_solve(W.permute(1, 2, 0).contiguous(), b.T.contiguous(),
                         pivot=pivot)
    x = x.T
    # a zero pivot mid-elimination poisons the later rows (inf·0 = NaN), so
    # a singular system's min-|pivot| is 0 OR NaN: ~(pivmin > 0) takes both
    singular = ~(pivmin > 0.0)
    k = int(singular.sum())
    if k:
        rerouted += k
        x = x.clone()
        x[singular] = ref_solve(W[singular], b[singular])
    return x
