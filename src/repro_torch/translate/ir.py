"""The IR of the automated translation: a DAG of scalar nodes.

A traced right-hand side is a `Graph` of scalar nodes over the inputs
``u[i]``, ``p[j]`` and ``t`` and float64 constants, and a `Traced`: the
graph with the node ids of the function's outputs in row-major order and
their shape, ``(n,)``, ``(n, m)`` or ``(n, n)``.

Nodes are hash-consed on (op, inputs, attribute), so a sub-expression the
function computes twice is one node, computed once by `evaluate` and by the
emitted functor (the same op on the same inputs gives the same bits, so
sharing is bitwise safe).  An op keeps the form of the torch call that made
it: a Python number operand is an attribute of a ``*_s`` op (``x / 3.0`` is
``div_s``, which PyTorch's CUDA kernel computes as ``x * (1 / 3.0)``), a
tensor constant (``zeros_like``, ``ones_like``, ``full_like``) is a
``const`` node, ``pow_s`` keeps its Python exponent (int or float).

`evaluate` replays each node as the torch call that made it, on lane
tensors, in node order: it is the plain version of every generated functor.

A function traced with a dataset (``f(u, p, t, data)``) reads its tables
through ``lookup`` nodes: one node a call of `core.interp.interp1d` or
`interp2d`, with the leaf's index in `data_flatten`'s order and the mode as
its attribute and the queries as its inputs; the graph's ``data`` holds
the number of dimensions of each leaf.  A ``lookup_jvp`` node is the
tangent of a lookup along its queries' tangents (`derive`), its attribute
(leaf, mode, which queries carry a tangent), its inputs the queries, then
the tangents that exist.  `evaluate` computes a lookup through
`core.interp` on the dataset it is given and its tangent by
`torch.func.jvp` of the same call.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.interp import data_tables, interp1d, interp2d

# op -> the torch call that replays it (`evaluate`); arity in ARITY
UNARY = ("neg", "sqrt", "exp", "log", "sin", "cos", "tanh", "abs",
         "reciprocal")
BINARY = ("add", "sub", "mul", "div", "pow", "maximum", "minimum")
# a tensor and a Python number (the attribute); rsub_s is ``c - x``
SCALAR = ("add_s", "sub_s", "rsub_s", "mul_s", "div_s", "pow_s",
          "clamp_min", "clamp_max")
COMPARE = ("lt", "le", "gt", "ge", "eq", "ne")
COMPARE_S = tuple(c + "_s" for c in COMPARE)
LEAVES = ("u", "p", "t", "const")
# a dataset lookup and its tangent (attributes in the module docstring)
LOOKUPS = ("lookup", "lookup_jvp")
OPS = (UNARY + BINARY + SCALAR + COMPARE + COMPARE_S + ("where",) + LEAVES
       + LOOKUPS)


class Node(NamedTuple):
    op: str
    args: Tuple[int, ...]
    attr: object = None       # the index of u/p, the constant, the scalar


def _attr_key(attr):
    """A hashable key that tells -0.0 from 0.0 and an int from a float."""
    if isinstance(attr, float):
        return ("f", attr.hex())
    if isinstance(attr, int):
        return ("i", attr)
    return attr


class Graph:
    """A hash-consed DAG of scalar nodes of a problem with n states and m
    parameters.  Every node's inputs precede it."""

    def __init__(self, n: int, m: int, data: Optional[Tuple[int, ...]] = None):
        self.n, self.m = int(n), int(m)
        # the number of dimensions of each dataset leaf, None without data
        self.data = None if data is None else tuple(int(d) for d in data)
        self.nodes: List[Node] = []
        self._index: Dict[tuple, int] = {}

    def add(self, op: str, args: Tuple[int, ...] = (), attr=None) -> int:
        if op not in OPS:
            raise ValueError(f"unknown IR op {op!r}")
        key = (op, tuple(args), _attr_key(attr))
        got = self._index.get(key)
        if got is None:
            got = len(self.nodes)
            self.nodes.append(Node(op, tuple(args), attr))
            self._index[key] = got
        return got

    def u(self, i: int) -> int:
        return self.add("u", (), int(i))

    def p(self, j: int) -> int:
        return self.add("p", (), int(j))

    def t(self) -> int:
        return self.add("t")

    def const(self, value: float) -> int:
        return self.add("const", (), float(value))

    def is_const(self, i: int, value: Optional[float] = None) -> bool:
        node = self.nodes[i]
        return node.op == "const" and (value is None or node.attr == value)

    def reachable(self, roots) -> List[int]:
        """The ids of the nodes `roots` depend on, themselves included, in
        node order (inputs first)."""
        seen = set()
        stack = [r for r in roots if r is not None]
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            stack.extend(self.nodes[i].args)
        return sorted(seen)


class Traced(NamedTuple):
    """A function traced into `graph`: its outputs' node ids in row-major
    order and their shape."""
    graph: Graph
    outputs: Tuple[int, ...]
    shape: Tuple[int, ...]
    name: str = "f"

    def rows(self):
        """The outputs as nested tuples of the output shape."""
        if len(self.shape) == 1:
            return tuple(self.outputs)
        k = self.shape[1]
        return tuple(tuple(self.outputs[i * k:(i + 1) * k])
                     for i in range(self.shape[0]))


def same(a: Traced, b: Traced) -> bool:
    """Whether two traced functions are the same computation: equal
    outputs and shape over equal nodes (constants by their bits)."""
    ga, gb = a.graph, b.graph
    key = lambda g: [(nd.op, nd.args, _attr_key(nd.attr))  # noqa: E731
                     for nd in g.nodes]
    return (a.outputs == b.outputs and a.shape == b.shape
            and (ga.n, ga.m, ga.data) == (gb.n, gb.m, gb.data)
            and key(ga) == key(gb))


_TORCH_UNARY = {"neg": torch.neg, "sqrt": torch.sqrt, "exp": torch.exp,
                "log": torch.log, "sin": torch.sin, "cos": torch.cos,
                "tanh": torch.tanh, "abs": torch.abs,
                "reciprocal": torch.reciprocal}
_TORCH_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                 "div": torch.div, "pow": torch.pow,
                 "maximum": torch.maximum, "minimum": torch.minimum,
                 "lt": torch.lt, "le": torch.le, "gt": torch.gt,
                 "ge": torch.ge, "eq": torch.eq, "ne": torch.ne}
_TORCH_SCALAR = {"add_s": torch.add, "sub_s": torch.sub,
                 "rsub_s": torch.rsub, "mul_s": torch.mul,
                 "div_s": torch.div, "pow_s": torch.pow,
                 "clamp_min": torch.clamp_min, "clamp_max": torch.clamp_max,
                 **{c + "_s": _TORCH_BINARY[c] for c in COMPARE}}


def _lookup(table, queries, mode):
    if len(queries) == 1:
        return interp1d(table, queries[0], mode)
    return interp2d(table, queries[0], queries[1], mode)


def _lookup_jvp(table, attr, x):
    """torch.func.jvp of the lookup along the tangents that exist; each
    moving query broadcast with its tangent."""
    _, mode, has = attr
    qs, ts = list(x[:len(has)]), list(x[len(has):])
    moving = [i for i, h in enumerate(has) if h]
    prim, tans = [], []
    for i, tan in zip(moving, ts):
        a, b = torch.broadcast_tensors(qs[i], tan)
        prim.append(a)
        tans.append(b)

    def fn(*m):
        full = list(qs)
        for i, v in zip(moving, m):
            full[i] = v
        return _lookup(table, full, mode)

    return torch.func.jvp(fn, tuple(prim), tuple(tans))[1]


def evaluate_nodes(graph: Graph, roots, u, p, t,
                   data=None) -> Dict[int, torch.Tensor]:
    """The value of every node `roots` depend on, each replayed as the
    torch call that made it, in node order: ``{id: tensor}``; a lookup
    reads `data` (the traced function's dataset)."""
    ref = u[0] if len(u) else t     # t alone: a traced interpolant
    vals: Dict[int, torch.Tensor] = {}
    tables = None
    for i in graph.reachable(roots):
        op, args, attr = graph.nodes[i]
        x = [vals[a] for a in args]
        if op == "u":
            v = u[attr]
        elif op == "p":
            v = p[attr]
        elif op == "t":
            v = t
        elif op == "const":
            v = torch.full_like(ref, attr)
        elif op in _TORCH_UNARY:
            v = _TORCH_UNARY[op](x[0])
        elif op in _TORCH_BINARY:
            v = _TORCH_BINARY[op](x[0], x[1])
        elif op in _TORCH_SCALAR:
            v = _TORCH_SCALAR[op](x[0], attr)
        elif op == "where":
            v = torch.where(x[0], x[1], x[2])
        elif op in LOOKUPS:
            if tables is None:
                if data is None:
                    raise ValueError("the traced function reads a dataset: "
                                     "pass data=")
                tables = data_tables(data)
            tab = tables[attr[0]]
            v = (_lookup(tab, x, attr[1]) if op == "lookup"
                 else _lookup_jvp(tab, attr, x))
        else:                                   # pragma: no cover
            raise ValueError(f"unknown IR op {op!r}")
        vals[i] = v
    return vals


def evaluate(traced: Traced, u, p, t, data=None) -> torch.Tensor:
    """The traced function's value at lane tensors u (n, B) or (n,), p
    (m, B) or (m,) and t (B,) or 0-d (and the dataset `data` of a function
    traced with one; a traced interpolant has n = m = 0): each node replayed as the torch call that made it,
    then the outputs stacked into ``traced.shape`` + the lane shape
    (constants and lane-free outputs broadcast)."""
    if not torch.is_tensor(t):
        t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
    vals = evaluate_nodes(traced.graph, traced.outputs, u, p, t, data)
    lane = torch.broadcast_shapes(u[0].shape if len(u) else (),
                                  p[0].shape if len(p) else (), t.shape)
    outs = [vals[i].expand(lane) for i in traced.outputs]
    flat = torch.stack(outs)
    return flat.reshape(tuple(traced.shape) + tuple(lane))


def as_function(traced: Traced):
    """``f(u, p, t)`` (``f(u, p, t, data)`` for a function traced with a
    dataset) computing `evaluate`: the traced function's plain version,
    which the lanes engines can call."""

    def f(u, p, t, data=None):
        return evaluate(traced, u, p, t, data)

    f.__name__ = f"plain_{traced.name}"
    return f
