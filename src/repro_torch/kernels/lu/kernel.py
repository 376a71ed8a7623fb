"""Batched small-matrix LU solve (paper §5.1.3): W x = b for N independent
systems, W = I − γh·J block-diagonal over the ensemble — the counterpart of
`repro.kernels.lu.kernel`.

`lu_factor_lanes`, `lu_resolve_lanes` and `lu_solve_lanes` are the plain
versions, on lane-major tensors W (n, n, B) and b (n, B): unrolled Gaussian
elimination in which every scalar operation is a (B,)-wide tensor
operation, with lanes-wide partial pivoting (each lane picks the first row
of largest |column k| — NaN counting as largest, as `jnp.argmax` does —
and the swap is a masked select) and the per-lane minimum |pivot|, which is
0 or NaN exactly on a singular system: `repro_torch.kernels.lu.ops
.batched_solve` reroutes those systems to the reference solve.  The
Rosenbrock engine runs them inline (``linsolve="lanes"``), and the fused
stiff kernel `csrc/rosenbrock_ensemble.cu` runs the same elimination from
`csrc/lu_lanes.cuh`.

`lu_solve` is the wrapper of the standalone CUDA kernel `csrc/lu_solve.cu`,
which replaces the TPU kernel `repro.kernels.lu.kernel.lu_solve_pallas`: on
CUDA tensors it checks its inputs and launches the kernel (or raises); on
CPU tensors, and only there, it runs `lu_solve_lanes`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

SOURCE = "lu_solve.cu"
MAX_N = 8   # the kernel is instantiated for n = 1..MAX_N
DTYPE_IDS = {torch.float32: 0, torch.float64: 1}

# launches of the CUDA kernel since the counter was last set to 0
launches = 0


def lu_factor_lanes(W, pivot=True):
    """Lanes-mode LU factorization: W (n, n, B) -> (rows, swaps, mults,
    pivmin): the eliminated rows (upper triangle), the per-step pivot rows
    and multipliers (what `lu_resolve_lanes` replays on a right-hand side)
    and the per-lane minimum |pivot| (0 or NaN on a singular system)."""
    n = W.shape[0]
    rows = [W[i] for i in range(n)]   # each (n, B)
    swaps = []                        # per step k: pivot row index (B,)
    mults = []                        # per step k: multipliers of rows k+1..
    pivmin = torch.full(W.shape[-1:], math.inf, dtype=W.dtype,
                        device=W.device)
    for k in range(n):
        if pivot and k < n - 1:
            mag = torch.stack([rows[i][k].abs() for i in range(k, n)])
            piv = mag.argmax(dim=0) + k                 # (B,)
            for i in range(k + 1, n):
                sel_r = (piv == i)[None]
                rows[k], rows[i] = (torch.where(sel_r, rows[i], rows[k]),
                                    torch.where(sel_r, rows[k], rows[i]))
            swaps.append(piv)
        pivmin = torch.minimum(pivmin, rows[k][k].abs())
        inv = 1.0 / rows[k][k]
        mk = []
        for i in range(k + 1, n):
            m = rows[i][k] * inv
            rows[i] = rows[i] - m * rows[k]
            mk.append(m)
        mults.append(mk)
    return rows, swaps, mults, pivmin


def lu_resolve_lanes(fac, b):
    """Back-substitution against a `lu_factor_lanes` factorization:
    b (n, B) -> x (n, B), replaying the stored row swaps and multipliers."""
    rows, swaps, mults, _ = fac
    n = len(rows)
    rhs = [b[i] for i in range(n)]    # each (B,)
    for k in range(n):
        if swaps and k < n - 1:
            piv = swaps[k]
            for i in range(k + 1, n):
                sel = piv == i
                rhs[k], rhs[i] = (torch.where(sel, rhs[i], rhs[k]),
                                  torch.where(sel, rhs[k], rhs[i]))
        for i in range(k + 1, n):
            rhs[i] = rhs[i] - mults[k][i - k - 1] * rhs[k]
    xs = [None] * n
    for i in reversed(range(n)):
        acc = rhs[i]
        for j in range(i + 1, n):
            acc = acc - rows[i][j] * xs[j]
        xs[i] = acc / rows[i][i]
    return torch.stack(xs)


def lu_solve_lanes(W, b, pivot=True, with_pivmin=False):
    """One-shot lanes-mode LU solve: W (n, n, B), b (n, B) -> x (n, B), and
    with ``with_pivmin=True`` also the per-lane minimum |pivot|."""
    fac = lu_factor_lanes(W, pivot=pivot)
    x = lu_resolve_lanes(fac, b)
    if with_pivmin:
        return x, fac[3]
    return x


@functools.lru_cache(maxsize=None)
def _bind():
    from repro_torch.kernels.build import load
    fn = load(SOURCE).lu_solve_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, i32, vp, vp, i32, vp, vp, vp]
    fn.restype = i32
    return fn


def lu_solve(W_lanes, b_lanes, pivot=True):
    """W_lanes (n, n, N), b_lanes (n, N) -> (x (n, N), pivmin (N,)).

    pivmin is the per-system minimum |pivot|: 0 or NaN marks a singular
    system whose x column is garbage (inf/nan)."""
    if W_lanes.device.type == "cpu":
        return lu_solve_lanes(W_lanes, b_lanes, pivot=pivot,
                              with_pivmin=True)
    if W_lanes.device.type != "cuda":
        raise ValueError(f"lu_solve runs on CPU or CUDA tensors, not "
                         f"{W_lanes.device.type}")
    dtype = W_lanes.dtype
    if dtype not in DTYPE_IDS:
        raise TypeError(f"the LU kernel takes float32 or float64, not {dtype}")
    if W_lanes.dim() != 3 or W_lanes.shape[0] != W_lanes.shape[1]:
        raise ValueError(f"W must be (n, n, N), got {tuple(W_lanes.shape)}")
    n, N = W_lanes.shape[0], W_lanes.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the LU kernel is compiled for n = 1..{MAX_N}, "
                         f"got n = {n}")
    if not 1 <= N < 2 ** 31:
        raise ValueError(f"need 1 <= N < 2^31 systems, got N={N}")
    for what, x, shape in (("W", W_lanes, (n, n, N)), ("b", b_lanes, (n, N))):
        if x.device != W_lanes.device or x.dtype != dtype:
            raise ValueError(f"{what} must be a {dtype} tensor on "
                             f"{W_lanes.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous with shape {shape}, "
                             f"got {tuple(x.shape)}")
    x = torch.empty((n, N), dtype=dtype, device=W_lanes.device)
    pivmin = torch.empty((N,), dtype=dtype, device=W_lanes.device)
    stream = torch.cuda.current_stream(W_lanes.device).cuda_stream
    with torch.cuda.device(W_lanes.device):
        rc = _bind()(DTYPE_IDS[dtype], n, int(bool(pivot)),
                     W_lanes.data_ptr(), b_lanes.data_ptr(), N, x.data_ptr(),
                     pivmin.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lu_solve launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return x, pivmin
