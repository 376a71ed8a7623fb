"""Carry the reference's inputs, given as numpy arrays, into the port.

The reference (`repro`) and the port share no array type.  A test or a user
who holds the reference's inputs as numpy arrays — ``(u0s, ps)`` of an ODE
or SDE problem, a save grid, a tableau's coefficients, an SDE noise table,
a dataset of interpolation tables — turns them into the port's tensors and
objects here, on a chosen device and dtype, with no loss: numpy float64
arrays convert exactly, and a narrower dtype rounds once, as the reference
does when it casts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.interp import UniformTable1D, UniformTable2D
from repro_torch.core.problem import EnsembleProblem
from repro_torch.core.tableaus import Tableau


def to_tensor(x, *, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """A numpy array (or anything numpy takes) as a contiguous tensor."""
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


def dataset(data, *, device="cpu", dtype=None):
    """A `prob.data` pytree (dicts, lists and tuples of tables with
    ``values``, ``x0``, ``dx`` and, in 2-D, ``y0``, ``dy``: the reference's
    or the port's) as the port's tables on `device`.  ``dtype=None`` keeps
    each table's own dtype, bit for bit; a narrower dtype rounds once, as
    the reference's cast does."""
    if data is None:
        return None
    if isinstance(data, dict):
        return {k: dataset(v, device=device, dtype=dtype)
                for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(dataset(v, device=device, dtype=dtype)
                          for v in data)
    if isinstance(data.values, torch.Tensor):
        vt = data.values.to(device=device).contiguous()
    else:
        vt = torch.as_tensor(np.array(data.values), device=device)
    if dtype is not None:
        vt = vt.to(dtype)
    if hasattr(data, "y0"):
        return UniformTable2D(vt, float(data.x0), float(data.dx),
                              float(data.y0), float(data.dy))
    return UniformTable1D(vt, float(data.x0), float(data.dx))


def ensemble_problem(prob, u0s, ps, *, device="cpu", dtype=torch.float64,
                     data=None) -> EnsembleProblem:
    """An `EnsembleProblem` over `prob` with the given trajectory-major
    (N, n) initial states and (N, m) parameters, on `device` in `dtype`.
    The problem's dataset, or `data` (a reference dataset pytree) in its
    place, is carried by `dataset` onto `device` in `dtype` too."""
    u0s_t = to_tensor(u0s, device=device, dtype=dtype)
    ps_t = to_tensor(ps, device=device, dtype=dtype)
    data = getattr(prob, "data", None) if data is None else data
    if data is not None:
        prob = dataclasses.replace(
            prob, data=dataset(data, device=device, dtype=dtype))
    return EnsembleProblem(prob, int(u0s_t.shape[0]), u0s=u0s_t, ps=ps_t)


def noise_table(z, *, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """A pre-drawn SDE noise table, numpy (n_steps, m, N) of N(0,1) draws
    as the reference's ``noise_table=`` takes it, as a contiguous tensor."""
    t = to_tensor(z, device=device, dtype=dtype)
    if t.dim() != 3:
        raise ValueError(f"a noise table is (n_steps, m, N), got shape "
                         f"{tuple(t.shape)}")
    return t


def tableau_from_arrays(name: str, a, b, btilde, c, *, order: int,
                        embedded_order: int, fsal: bool,
                        interp_bpoly=None) -> Tableau:
    """A port `Tableau` from a reference tableau's coefficient arrays
    (kept as float64 numpy data, as both packages store them)."""
    as64 = lambda v: np.array(v, dtype=np.float64)
    return Tableau(name, as64(a), as64(b), as64(btilde), as64(c), int(order),
                   int(embedded_order), bool(fsal), interp_bpoly)


def lm_params(params, cfg, *, device="cpu", dtype=torch.float64):
    """A dense `DecoderLM` of `cfg` on `device` in `dtype` holding the
    reference's ``init_params`` pytree ``params`` (its leaves as numpy
    arrays; the block leaves stacked (L, …) as the reference's scan keeps
    them, unstacked here).  Copies exactly: float64 to float64 bit for bit,
    a narrower dtype rounding once."""
    from repro_torch.models.model import build_model
    model = build_model(cfg, dtype=dtype, device=device)
    names = ["embed", "final_norm"] + ([] if cfg.tie_embeddings
                                       else ["unembed"])
    with torch.no_grad():
        for name in names:
            getattr(model, name).copy_(to_tensor(np.array(params[name]),
                                                 device=device, dtype=dtype))
        blocks = params["blocks"]
        for i, blk in enumerate(model.blocks):
            for group in ("attn", "mlp"):
                for name, p in getattr(blk, group).items():
                    p.copy_(to_tensor(np.array(blocks[group][name][i]),
                                      device=device,
                                      dtype=dtype))
            for name in ("ln1", "ln2"):
                getattr(blk, name).copy_(to_tensor(np.array(blocks[name][i]),
                                                   device=device,
                                                   dtype=dtype))
    return model
