"""Dataset interpolation (paper §6.7, "texture memory") — the PyTorch
counterpart of `repro.core.interp`.

A data-driven problem carries uniform-grid tables in ``prob.data`` and its
callbacks take them as a fourth argument, ``f(u, p, t, data)``.  Three
modes, all with clamped ends (texture address-mode clamp):

  mode="gather"  — index computation and two reads, linear weights.
  mode="onehot"  — the weights as a (..., K) one-hot pair contracted with
                   the table (the reference's MXU form): the same function,
                   summed over K terms of which two are not zero.
  mode="cubic"   — Catmull–Rom cubic convolution (Keys a = -1/2) over the
                   clamped 4-point stencil.

Every operation follows the reference's order, so on the same inputs the
two packages agree bit for bit in gather and cubic (onehot's matmul may sum
in another order).  The CUDA kernels read the tables on the card through
the same lookups (`csrc/interp.cuh`); hardware texture filtering, with its
9-bit fractional weights, is not used.

Forward-mode tangents follow JAX's: ``jnp.clip`` passes half the tangent
where the argument sits exactly on a bound (its max/min rule), where
``torch.clamp`` passes all of it.  `_locate` clamps through `_clip`, which
keeps JAX's tangent, so ``torch.func.jvp`` through a lookup (the Rosenbrock
stages' ∂f/∂t) gives the reference's value at the table's ends.

Tables are leaves of a pytree for the dispatch layers: `data_flatten`
returns their ``values`` in `jax.tree_util`'s order (dict keys sorted), so
the leaves of both packages line up.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

Tensor = torch.Tensor

MODES = ("gather", "onehot", "cubic")


@dataclasses.dataclass(frozen=True)
class UniformTable1D:
    """values[i] sampled at x0 + i*dx, i in [0, K)."""
    values: Tensor   # (K,)
    x0: float
    dx: float

    @property
    def K(self) -> int:
        return int(self.values.shape[0])


@dataclasses.dataclass(frozen=True)
class UniformTable2D:
    """values[i, j] sampled at (x0 + i*dx, y0 + j*dy)."""
    values: Tensor   # (Kx, Ky)
    x0: float
    dx: float
    y0: float
    dy: float


class _Clip(torch.autograd.Function):
    """``clamp(x, lo, hi)`` with JAX's forward tangent: jnp.clip is
    minimum(maximum(x, lo), hi), and each of JAX's max/min passes half the
    tangent at a tie.  The value is torch.clamp's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, lo: float, hi: float):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, lo, hi = inputs
        ctx.save_for_forward(x)
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi

    @staticmethod
    def _factor(ctx, x):
        # maximum(x, lo): 1 above, 1/2 on, 0 below; then minimum(., hi)
        one, half = torch.ones_like(x), torch.full_like(x, 0.5)
        zero = torch.zeros_like(x)
        f_lo = torch.where(x > ctx.lo, one, torch.where(x == ctx.lo, half,
                                                        zero))
        m = torch.clamp(x, min=ctx.lo)
        f_hi = torch.where(m < ctx.hi, one, torch.where(m == ctx.hi, half,
                                                        zero))
        return f_lo, f_hi

    @staticmethod
    def jvp(ctx, x_t, lo_t, hi_t):
        (x,) = ctx.saved_tensors
        f_lo, f_hi = _Clip._factor(ctx, x)
        return x_t * f_lo * f_hi

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        f_lo, f_hi = _Clip._factor(ctx, x)
        return g * f_lo * f_hi, None, None


def _locate(x, x0: float, dx: float, K: int):
    """Clamped cell index (int32) and fractional offset.  dx divides as a
    tensor: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which is not the reference's quotient."""
    s = (x - x0) / torch.tensor(dx, dtype=x.dtype, device=x.device)
    s = _Clip.apply(s, 0.0, float(K - 1))
    i = torch.clamp(torch.floor(s).to(torch.int32), 0, K - 2)
    w = s - i  # in [0, 1]; w == 1 exactly at the last node
    return i, w


def _catmull_rom_weights(w):
    """Keys cubic-convolution weights (a = -1/2) for nodes i-1, i, i+1, i+2."""
    w2 = w * w
    w3 = w2 * w
    return (0.5 * (-w3 + 2.0 * w2 - w),
            0.5 * (3.0 * w3 - 5.0 * w2 + 2.0),
            0.5 * (-3.0 * w3 + 4.0 * w2 + w),
            0.5 * (w3 - w2))


def _take(values, idx):
    idx = idx.to(torch.int64)
    return values.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _as_query(x, values):
    """A tensor query keeps its dtype, as a JAX array does; a Python number
    takes the table's."""
    if isinstance(x, Tensor):
        return x
    return torch.as_tensor(x, dtype=values.dtype, device=values.device)


def interp1d(table: UniformTable1D, x, mode: str = "gather"):
    """Interpolation at x (any shape). Clamped boundaries, all modes."""
    vals = table.values
    if not isinstance(vals, Tensor):
        # a dataset leaf being traced (repro_torch.translate.trace): the
        # lookup is one node of the traced function
        return vals.lookup(mode, x)
    x = _as_query(x, vals)
    K = table.K
    i, w = _locate(x, table.x0, table.dx, K)
    if mode == "gather":
        v0 = _take(vals, i)
        v1 = _take(vals, i + 1)
        return v0 * (1.0 - w) + v1 * w
    if mode == "onehot":
        # weights (..., K): (1-w) at i, w at i+1, contracted with the table
        iota = torch.arange(K, dtype=torch.int32, device=vals.device)
        ii = i.unsqueeze(-1)
        ww = w.unsqueeze(-1)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        wmat = (torch.where(iota == ii, 1.0 - ww, zero)
                + torch.where(iota == ii + 1, ww, zero))
        return wmat @ vals
    if mode == "cubic":
        # the 4-point stencil's indices clamp to [0, K-1]: node replication
        # at the edges, so a query outside the grid returns the edge node
        ws = _catmull_rom_weights(w)
        out = None
        for off, wk in zip((-1, 0, 1, 2), ws):
            idx = torch.clamp(i + off, 0, K - 1)
            term = wk * _take(vals, idx)
            out = term if out is None else out + term
        return out
    raise ValueError(f"unknown mode {mode!r} (one of {MODES})")


def interp2d(table: UniformTable2D, x, y, mode: str = "gather"):
    """Bilinear/bicubic interpolation at (x, y) (broadcast shapes). Clamped."""
    vals = table.values
    if not isinstance(vals, Tensor):
        return vals.lookup(mode, x, y)
    x = _as_query(x, vals)
    y = _as_query(y, vals)
    Kx, Ky = int(vals.shape[0]), int(vals.shape[1])
    i, wx = _locate(x, table.x0, table.dx, Kx)
    j, wy = _locate(y, table.y0, table.dy, Ky)
    if mode == "gather":
        flat = vals.reshape(-1)
        idx = i * Ky + j
        v00 = _take(flat, idx)
        v01 = _take(flat, idx + 1)
        v10 = _take(flat, idx + Ky)
        v11 = _take(flat, idx + Ky + 1)
        return (v00 * (1 - wx) * (1 - wy) + v01 * (1 - wx) * wy
                + v10 * wx * (1 - wy) + v11 * wx * wy)
    if mode == "onehot":
        # a one-hot pair per axis; two small contractions
        ix = torch.arange(Kx, dtype=torch.int32, device=vals.device)
        iy = torch.arange(Ky, dtype=torch.int32, device=vals.device)
        ie, je = i.unsqueeze(-1), j.unsqueeze(-1)
        wxe, wye = wx.unsqueeze(-1), wy.unsqueeze(-1)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        wmx = (torch.where(ix == ie, 1.0 - wxe, zero)
               + torch.where(ix == ie + 1, wxe, zero))         # (..., Kx)
        wmy = (torch.where(iy == je, 1.0 - wye, zero)
               + torch.where(iy == je + 1, wye, zero))         # (..., Ky)
        rows = wmx @ vals                                      # (..., Ky)
        return torch.sum(rows * wmy, dim=-1)
    if mode == "cubic":
        # separable Catmull–Rom: 4x4 clamped stencil, tensor-product weights
        flat = vals.reshape(-1)
        wxs = _catmull_rom_weights(wx)
        wys = _catmull_rom_weights(wy)
        out = None
        for ox, wkx in zip((-1, 0, 1, 2), wxs):
            ii = torch.clamp(i + ox, 0, Kx - 1)
            for oy, wky in zip((-1, 0, 1, 2), wys):
                jj = torch.clamp(j + oy, 0, Ky - 1)
                term = wkx * wky * _take(flat, ii * Ky + jj)
                out = term if out is None else out + term
        return out
    raise ValueError(f"unknown mode {mode!r} (one of {MODES})")


# ---------------------------------------------------------------------------
# `prob.data` pytree helpers: the dispatch layers handle data through these
# functions only.  A treedef is a nested tuple: ("leaf",), ("none",),
# ("table1d", x0, dx), ("table2d", x0, dx, y0, dy), ("dict", keys, subs),
# ("list" | "tuple", subs).
# ---------------------------------------------------------------------------

def _flatten(node, leaves: List[Tensor]):
    if node is None:
        return ("none",)
    if isinstance(node, UniformTable1D):
        leaves.append(node.values)
        return ("table1d", node.x0, node.dx)
    if isinstance(node, UniformTable2D):
        leaves.append(node.values)
        return ("table2d", node.x0, node.dx, node.y0, node.dy)
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, tuple(_flatten(v, leaves) for v in node))
    leaves.append(node)
    return ("leaf",)


def data_flatten(data) -> Tuple[list, Any]:
    """(leaves, treedef) of a `prob.data` pytree — the leaves are the
    tables' value tensors, in `jax.tree_util`'s order."""
    leaves: List[Tensor] = []
    return leaves, _flatten(data, leaves)


def _unflatten(tree, it):
    kind = tree[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    if kind == "table1d":
        return UniformTable1D(next(it), *tree[1:])
    if kind == "table2d":
        return UniformTable2D(next(it), *tree[1:])
    if kind == "dict":
        return {k: _unflatten(sub, it) for k, sub in zip(tree[1], tree[2])}
    subs = [_unflatten(sub, it) for sub in tree[1]]
    return subs if kind == "list" else tuple(subs)


def data_tables(data) -> list:
    """The tables of a `prob.data` pytree in `data_flatten`'s order (a leaf
    that is not a table is returned as it is)."""
    leaves, treedef = data_flatten(data)
    out: list = []

    def walk(tree):
        kind = tree[0]
        if kind == "table1d":
            out.append(UniformTable1D(leaves[len(out)], *tree[1:]))
        elif kind == "table2d":
            out.append(UniformTable2D(leaves[len(out)], *tree[1:]))
        elif kind == "leaf":
            out.append(leaves[len(out)])
        elif kind == "dict":
            for sub in tree[2]:
                walk(sub)
        elif kind in ("list", "tuple"):
            for sub in tree[1]:
                walk(sub)

    walk(treedef)
    return out


def data_unflatten(treedef, leaves):
    it = iter(list(leaves))
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def data_words(data) -> int:
    """Total elements across all table leaves."""
    if data is None:
        return 0
    return int(sum(int(leaf.numel()) for leaf in data_flatten(data)[0]))


def data_signature(data) -> str:
    """Compact shape/dtype signature of a data pytree, as the reference's
    ("none" without data, "empty" without leaves)."""
    if data is None:
        return "none"
    leaves = data_flatten(data)[0]
    if not leaves:
        return "empty"
    return "+".join(
        "x".join(str(int(s)) for s in leaf.shape)
        + str(leaf.dtype).replace("torch.", "")
        for leaf in leaves)
