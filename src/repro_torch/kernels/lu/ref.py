"""Reference solve of a batch of small systems, by the library's LU.

`torch.linalg.solve` raises on a singular batch element; the reference's
`jnp.linalg.solve` returns LAPACK's garbage for it instead.  LU
factorisation with the error check off (`lu_factor_ex`) followed by
`lu_solve` returns that same pattern (``[nan, -inf, inf]`` for a rank-2
3x3 matrix, ``[nan, nan, inf]`` for the zero matrix), so singular systems
come out as the reference's do.
"""
import torch


def ref_solve(W, b):
    """W (N, n, n), b (N, n) -> (N, n)."""
    LU, piv, _ = torch.linalg.lu_factor_ex(W)
    return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]
