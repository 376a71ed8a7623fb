"""Dataset tables on the card: what the wrappers of K1, K3, K4 and K5 pass
to their data forms, and the lookup test entry (`csrc/interp_lookup.cu`).

A data functor of a kernel reads the leaves of ``prob.data``: a
hand-written one (forced oscillator, rate-table GBM) those its
`DataLayout` names, a generated one (`repro_torch.translate`) every leaf
of the dataset it was traced with, in `data_flatten`'s order.
`data_launch_args` checks the dataset (against a layout where one is
given), its dtype and device against the state's, and packs each leaf's
device pointer, shape and grid for the kernel's data entry
(`csrc/interp.cuh` `Tables`); the kernels read the tables through the same
lookups as `repro_torch.core.interp`.

`interp_lookup` runs those lookups alone, one thread per query, on CUDA
tensors (or raises); on CPU tensors, and only for them, it runs the plain
version, `core.interp.interp1d` / `interp2d`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.interp import (MODES, UniformTable1D, UniformTable2D,
                                     data_tables, interp1d, interp2d)

SOURCE = "interp_lookup.cu"
MAX_LEAVES = 4          # repro_data::kMaxLeaves
MODE_IDS = {m: i for i, m in enumerate(MODES)}
DTYPE_IDS = {torch.float32: 0, torch.float64: 1}

# launches of the lookup kernel since the counter was last set to 0
launches = 0


class DataLayout(NamedTuple):
    """The dataset a data functor reads: ``prob.data`` is a dict with these
    keys, each a table of that many dimensions (1 or 2), in key order."""
    tables: Tuple[Tuple[str, int], ...]


def matches(data, layout) -> bool:
    """Whether `data` is the dict of tables a hand-written functor's
    `DataLayout` names."""
    want = dict(layout.tables)
    return isinstance(data, dict) and set(data) == set(want) and all(
        isinstance(data[k], UniformTable1D if nd == 1 else UniformTable2D)
        for k, nd in want.items())


def data_launch_args(data, layout, name: str, u0):
    """``(count, leaves, shapes, grids)`` for a data entry: ctypes arrays of
    the leaves' device pointers, (kx, ky) shapes and (x0, dx, y0, dy)
    grids, in `data_flatten`'s order.  `layout` is a hand-written functor's
    `DataLayout`, or None for a generated functor, which reads every leaf.
    Raises where the dataset is not the layout's, a leaf is not a 1-D or
    2-D table, or a table is not a contiguous tensor of u0's dtype on u0's
    device."""
    if layout is not None and not matches(data, layout):
        raise ValueError(
            f"the data functor {name!r} reads a dict of tables "
            f"{sorted(dict(layout.tables))}, got "
            f"{sorted(data) if isinstance(data, dict) else type(data)}")
    tables = data_tables(data)
    if not 1 <= len(tables) <= MAX_LEAVES:
        raise ValueError(f"a data form takes 1 to {MAX_LEAVES} tables, got "
                         f"{len(tables)}")
    ptrs, shapes, grids = [], [], []
    for k, tab in enumerate(tables):
        if not isinstance(tab, (UniformTable1D, UniformTable2D)):
            raise ValueError(f"dataset leaf {k} is a {type(tab).__name__}, "
                             "not a UniformTable1D or UniformTable2D")
        v = tab.values
        ndim = 1 if isinstance(tab, UniformTable1D) else 2
        if v.device != u0.device or v.dtype != u0.dtype:
            raise ValueError(f"dataset leaf {k} must be a {u0.dtype} tensor "
                             f"on {u0.device}, got {v.dtype} on {v.device}")
        if not v.is_contiguous() or v.dim() != ndim or v.shape[0] < 2 \
                or (v.dim() == 2 and v.shape[1] < 2) or v.numel() >= 2 ** 31:
            raise ValueError(f"dataset leaf {k} must be contiguous with at "
                             "least 2 knots an axis")
        ptrs.append(v.data_ptr())
        shapes += [int(v.shape[0]), int(v.shape[1]) if v.dim() == 2 else 0]
        grids += [float(tab.x0), float(tab.dx),
                  float(getattr(tab, "y0", 0.0)),
                  float(getattr(tab, "dy", 0.0))]
    return (len(ptrs), (ctypes.c_void_p * MAX_LEAVES)(*ptrs),
            (ctypes.c_int * (2 * MAX_LEAVES))(*shapes),
            (ctypes.c_double * (4 * MAX_LEAVES))(*grids))


def data_argtypes():
    """The ctypes types of `data_launch_args`'s four values."""
    return [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _bind():
    from repro_torch.kernels.build import load
    fn = load(SOURCE).interp_lookup_launch
    i32, f64, vp = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    fn.argtypes = [i32, i32, vp, i32, i32, f64, f64, f64, f64, vp, vp, i32,
                   vp, vp]
    fn.restype = i32
    return fn


def interp_lookup(table, x, y=None, mode: str = "gather"):
    """``interp1d(table, x, mode)`` (``y=None``) or ``interp2d(table, x, y,
    mode)`` at 1-D queries of the table's dtype on its device: the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    two_d = isinstance(table, UniformTable2D)
    if two_d != (y is not None):
        raise ValueError("a 2-D table takes x and y, a 1-D table x alone")
    v = table.values
    if v.device.type == "cpu":
        return (interp2d(table, x, y, mode) if two_d
                else interp1d(table, x, mode))
    if v.device.type != "cuda":
        raise ValueError(f"interp_lookup runs on CPU or CUDA tensors, not "
                         f"{v.device.type}")
    if mode not in MODE_IDS:
        raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
    if v.dtype not in DTYPE_IDS:
        raise TypeError(f"the lookup kernel takes float32 or float64, not "
                        f"{v.dtype}")
    qs = [x] + ([y] if two_d else [])
    for q in qs:
        if q.device != v.device or q.dtype != v.dtype or q.dim() != 1 \
                or not q.is_contiguous() or q.shape != x.shape:
            raise ValueError("queries must be contiguous 1-D tensors of one "
                             "length, of the table's dtype on its device")
    if not v.is_contiguous() or min(v.shape) < 2:
        raise ValueError("the table must be contiguous, 2 knots an axis")
    out = torch.empty_like(x)
    nq = int(x.shape[0])
    with torch.cuda.device(v.device):
        rc = _bind()(DTYPE_IDS[v.dtype], MODE_IDS[mode], v.data_ptr(),
                     int(v.shape[0]), int(v.shape[1]) if two_d else 0,
                     float(table.x0), float(table.dx),
                     float(getattr(table, "y0", 0.0)),
                     float(getattr(table, "dy", 0.0)), x.data_ptr(),
                     y.data_ptr() if two_d else None, nq, out.data_ptr(),
                     torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"interp_lookup launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
