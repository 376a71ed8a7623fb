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


def lm_params(params, cfg, *, device="cpu", dtype=torch.float64, **kw):
    """The model of `cfg` (any family, `models.model.build_model` with
    `kw`) on `device` in `dtype` holding the reference's ``init_params``
    pytree ``params`` (its leaves as numpy arrays; the block leaves stacked
    (L, …) as the reference's scan keeps them: ``blocks``,
    ``enc_blocks``/``dec_blocks``, the hybrid's ``periods`` (a stack a
    pattern slot) and ``rem``; unstacked here).  Each weight keeps its own
    dtype (the float32 islands: the MoE router, Mamba-2's dt_bias, A_log,
    D_skip, the RG-LRU's b_r, b_i, lam).  Copies exactly: float64 to
    float64 bit for bit, a narrower dtype rounding once."""
    from repro_torch.models.model import build_model
    model = build_model(cfg, dtype=dtype, device=device, **kw)
    weights = dict(model.named_parameters())
    with torch.no_grad():
        for name, a in named_leaves(params, model):
            p = weights[name]
            p.copy_(to_tensor(a, device=device, dtype=p.dtype))
    return model


def named_leaves(tree, model):
    """(parameter name, numpy array) for every parameter of `model`, in
    `named_parameters` order, read from `tree`, a pytree in the layout of
    the reference's ``init_params`` (parameters, or anything shaped as
    them: gradients, AdamW's ``mu`` and ``nu``)."""
    lm = getattr(model, "lm", model)
    sources = {}
    for mod, sub, index in [(model, tree, None), (lm, tree, None),
                            *_layer_sources(lm, tree)]:
        for name, s in mod.spec.items():
            group = getattr(mod, name)
            if isinstance(s, dict):
                for k, p in group.items():
                    sources[id(p)] = (sub[name][k], index)
            else:
                sources[id(group)] = (sub[name], index)
    for name, p in model.named_parameters():
        a, index = sources[id(p)]
        yield name, np.asarray(a if index is None else a[index])


def adamw_state(state, model, *, device="cpu"):
    """The reference's `AdamWState` (``step``, and ``mu``, ``nu`` shaped as
    its ``init_params`` pytree; leaves numpy or anything numpy takes) as
    the port's `optim.adamw.AdamWState` for `model`: int32 step, float32
    moments keyed by parameter name, on `device`, each a copy (the update
    writes them in place)."""
    from repro_torch.optim.adamw import AdamWState

    def moments(tree):
        return {n: torch.tensor(a, dtype=torch.float32, device=device)
                for n, a in named_leaves(tree, model)}
    return AdamWState(torch.tensor(int(np.asarray(state.step)),
                                   dtype=torch.int32, device=device),
                      moments(state.mu), moments(state.nu))


def _layer_sources(model, params):
    """(block module, reference subtree, index into its stack or None) for
    each block of `model`."""
    from repro_torch.models.lm import HybridLM
    if isinstance(model, HybridLM):
        n = model.n_periods * model.period
        for j, blk in enumerate(model.blocks):
            if j < n:
                yield blk, params["periods"][j % model.period], \
                    j // model.period
            else:
                yield blk, params["rem"][j - n], None
        return
    for name in ("blocks", "enc_blocks", "dec_blocks"):
        for i, blk in enumerate(getattr(model, name, ())):
            yield blk, params[name], i
