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

`factor`, `resolve` and `select` split `batched_solve` for one W solved
against several right-hand sides (the Rosenbrock engine's stage solves,
``linsolve="cuda"``): the factorization is launched once and stays on the
card between launches, the singular systems are found there, with one
host read, and each resolve launches one kernel with no copy and no host
read unless some system was singular.  The results, the reroute and the
`rerouted` count are `batched_solve`'s on each right-hand side.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.ensemble_kernel import refuse_grad

from .kernel import lu_factor, lu_resolve, lu_solve
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


class Factorization(NamedTuple):
    """`lu_factor`'s state of W (B, n, n), lane-major, and the reroute:
    the singular systems' indices (B,) and W itself, both None where no
    system is singular."""
    lu: torch.Tensor
    piv: torch.Tensor
    pivmin: torch.Tensor
    singular: Optional[torch.Tensor] = None
    W: Optional[torch.Tensor] = None


def _with_reroute(lu, piv, pivmin, W):
    # one host read: the singular systems (pivmin 0 or NaN), if any
    singular = torch.nonzero(~(pivmin > 0.0)).flatten()
    if singular.numel() == 0:
        return Factorization(lu, piv, pivmin)
    return Factorization(lu, piv, pivmin, singular, W)


def factor(W, pivot=True):
    """Factor W (B, n, n), at any strides, once for `resolve` (the LU
    kernel's factorization; its plain version on CPU tensors)."""
    refuse_grad("the batched LU kernel (linsolve='cuda')", W)
    return _with_reroute(*lu_factor(W, pivot=pivot), W)


def resolve(fac: Factorization, b):
    """Solve b (n, B) against `factor`'s state -> x (n, B): one launch of
    the resolve kernel, and the singular systems through the reference
    solve, as `batched_solve` takes them."""
    global rerouted
    refuse_grad("the batched LU kernel (linsolve='cuda')", b)
    x = lu_resolve(fac.lu, fac.piv, b)
    if fac.singular is not None:
        s = fac.singular
        rerouted += s.numel()
        x[:, s] = ref_solve(fac.W[s], b.T[s]).T
    return x


def select(mask, new: Factorization, old: Factorization) -> Factorization:
    """Per-system choice between two factorizations, mask (B,): `new`
    where it holds.  The reroute follows the systems chosen."""
    lu = torch.where(mask, new.lu, old.lu)
    piv = torch.where(mask, new.piv, old.piv)
    pivmin = torch.where(mask, new.pivmin, old.pivmin)
    if new.W is None and old.W is None:
        return Factorization(lu, piv, pivmin)
    # only a singular system's W is read: one side may stand in for the other
    W_new = new.W if new.W is not None else old.W
    W_old = old.W if old.W is not None else new.W
    return _with_reroute(lu, piv, pivmin,
                         torch.where(mask[:, None, None], W_new, W_old))
