"""The recording proxy: a component-style ``fn(u, p, t)`` traced into the IR.

`trace(fn, n, m, outputs=...)` calls ``fn`` once with proxies: ``u`` and
``p`` are symbolic vectors of length n and m, ``t`` a symbolic scalar.  A
proxy supports what a component-style right-hand side does with its
arguments: indexing and slicing, ``len`` and ``.shape``, Python arithmetic
with Python numbers and with other proxies, a scalar broadcast over a
vector (``p[0] * u``), and, through ``__torch_function__``, ``torch.stack``
(nested, for (n, m) noise and (n, n) Jacobians), ``zeros_like``,
``ones_like``, ``full_like``, ``torch.where`` with the comparisons, and
the ops of `OPS_TRACED`.  Each operation adds one node to the graph
(`ir.Graph`), in the form of the torch call it stands for.

Anything else raises `NotImplementedError` naming the op, the function and
ROADMAP item 17; so does ``bool()`` of a proxy, i.e. Python control flow
on the data, which ``torch.where`` replaces.  Nothing falls back to the
plain version.

A function of a data-driven problem, ``fn(u, p, t, data)``, is traced
with its dataset (``data=``): it receives the dataset with each table's
values replaced by a `TableLeaf`, so that ``interp1d(leaf, x, mode)`` and
``interp2d(leaf, x, y, mode)`` (`core.interp`) record one ``lookup`` node
each, whose attribute is the leaf's index in `data_flatten`'s order.  The
grid (x0, dx, ...) is not traced: the device functor reads it from the
kernel's tables at run time.  Reading a leaf any other way refuses.

An event's condition (a 0-d output) and affect (an (n,) output) are
traced by `trace_event`, and a tableau's free interpolant (theta -> its
stage weights) by `trace_interp`.

A traced function is cached per function object (weakly), and per
dataset structure: a second solve with the same function traces nothing.
"""
from __future__ import annotations

import numbers
import weakref
from typing import Optional, Sequence

import torch

from repro_torch.core.interp import (MODES, UniformTable1D, UniformTable2D,
                                     data_flatten, data_tables,
                                     data_unflatten)
from repro_torch.translate.ir import Graph, Traced

ITEM = "ROADMAP queue 1 item 17 (automated translation)"

# the torch functions a proxy takes, and the ops of the IR they become
_UNARY_FNS = {torch.neg: "neg", torch.negative: "neg", torch.sqrt: "sqrt",
              torch.exp: "exp", torch.log: "log", torch.sin: "sin",
              torch.cos: "cos", torch.tanh: "tanh", torch.abs: "abs",
              torch.reciprocal: "reciprocal"}
_BINARY_FNS = {torch.add: "add", torch.sub: "sub", torch.subtract: "sub",
               torch.mul: "mul", torch.multiply: "mul", torch.div: "div",
               torch.true_divide: "div", torch.pow: "pow",
               torch.maximum: "maximum", torch.minimum: "minimum",
               torch.lt: "lt", torch.le: "le", torch.gt: "gt", torch.ge: "ge",
               torch.eq: "eq", torch.ne: "ne"}
OPS_TRACED = ("+", "-", "*", "/", "**", "neg", "abs", "stack", "zeros_like",
              "ones_like", "full_like", "where", "lt", "le", "gt", "ge",
              "eq", "ne", "sqrt", "exp", "log", "sin", "cos", "tanh",
              "reciprocal", "pow", "maximum", "minimum", "clamp_min",
              "clamp_max")


class _Context:
    """What a trace records into, and whose function it is."""

    def __init__(self, graph: Graph, name: str):
        self.graph, self.name = graph, name

    def refuse(self, what: str, hint: str = "") -> NotImplementedError:
        return NotImplementedError(
            f"cannot translate {what} in {self.name!r} into a device "
            f"functor{': ' + hint if hint else ''} (the translator takes "
            f"{', '.join(OPS_TRACED)} on u, p, t and Python numbers; "
            f"{ITEM})")


def _number(x) -> bool:
    return isinstance(x, numbers.Real) and not isinstance(x, bool) \
        and not torch.is_tensor(x)


def _py(x):
    """A Python number as the torch call would see it: int or float."""
    return int(x) if isinstance(x, numbers.Integral) else float(x)


class _Proxy:
    """What both proxies share: the torch-function hook and the refusals."""

    __slots__ = ("ctx",)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ctx = _find_ctx(args, kwargs)
        return _torch_call(ctx, func, args, kwargs)

    def __bool__(self):
        raise self.ctx.refuse(
            "bool() of a traced value",
            "Python control flow on the data (if/while/and/or on u, p or "
            "t) cannot run on the card; write the branch with torch.where")

    def __float__(self):
        raise self.ctx.refuse("float() of a traced value")

    def __int__(self):
        raise self.ctx.refuse("int() of a traced value")

    def __index__(self):
        raise self.ctx.refuse("a traced value as an index")

    def __array__(self, *a, **k):
        raise self.ctx.refuse("a traced value as a numpy array")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self.ctx.refuse(f"the tensor attribute or method .{name}")

    def __iter__(self):
        raise self.ctx.refuse("iterating over a scalar")

    # Python arithmetic: each operand a proxy or a Python number
    def __add__(self, o):
        return _binary(self.ctx, "add", self, o)

    def __radd__(self, o):
        return _binary(self.ctx, "add", self, o)

    def __sub__(self, o):
        return _binary(self.ctx, "sub", self, o)

    def __rsub__(self, o):
        return _binary(self.ctx, "rsub", self, o)

    def __mul__(self, o):
        return _binary(self.ctx, "mul", self, o)

    def __rmul__(self, o):
        return _binary(self.ctx, "mul", self, o)

    def __truediv__(self, o):
        return _binary(self.ctx, "div", self, o)

    def __rtruediv__(self, o):
        # Tensor.__rtruediv__: self.reciprocal() * other
        return _binary(self.ctx, "mul", _unary(self.ctx, "reciprocal", self),
                       o)

    def __pow__(self, o):
        return _binary(self.ctx, "pow", self, o)

    def __rpow__(self, o):
        raise self.ctx.refuse("a Python number raised to a traced power")

    def __neg__(self):
        return _unary(self.ctx, "neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _unary(self.ctx, "abs", self)

    def __lt__(self, o):
        return _binary(self.ctx, "lt", self, o)

    def __le__(self, o):
        return _binary(self.ctx, "le", self, o)

    def __gt__(self, o):
        return _binary(self.ctx, "gt", self, o)

    def __ge__(self, o):
        return _binary(self.ctx, "ge", self, o)

    def __eq__(self, o):
        return _binary(self.ctx, "eq", self, o)

    def __ne__(self, o):
        return _binary(self.ctx, "ne", self, o)

    __hash__ = object.__hash__

    # the methods of a tensor that are ops of the IR
    def sqrt(self):
        return _unary(self.ctx, "sqrt", self)

    def exp(self):
        return _unary(self.ctx, "exp", self)

    def log(self):
        return _unary(self.ctx, "log", self)

    def sin(self):
        return _unary(self.ctx, "sin", self)

    def cos(self):
        return _unary(self.ctx, "cos", self)

    def tanh(self):
        return _unary(self.ctx, "tanh", self)

    def abs(self):
        return _unary(self.ctx, "abs", self)

    def neg(self):
        return _unary(self.ctx, "neg", self)

    def reciprocal(self):
        return _unary(self.ctx, "reciprocal", self)

    def pow(self, o):
        return _binary(self.ctx, "pow", self, o)

    def clamp_min(self, lo):
        return _clamp(self.ctx, self, lo, None)

    def clamp_max(self, hi):
        return _clamp(self.ctx, self, None, hi)


class Scalar(_Proxy):
    """One symbolic scalar: a node of the graph (``is_bool`` for the result
    of a comparison, which only ``torch.where`` takes)."""

    __slots__ = ("id", "is_bool")

    def __init__(self, ctx: _Context, node: int, is_bool: bool = False):
        self.ctx, self.id, self.is_bool = ctx, node, is_bool

    @property
    def shape(self):
        return ()

    def __len__(self):
        raise TypeError("len() of a 0-d traced value")

    def __getitem__(self, i):
        raise self.ctx.refuse("indexing a scalar")


class Vector(_Proxy):
    """A symbolic vector (or, nested, matrix) of proxies."""

    __slots__ = ("items",)

    def __init__(self, ctx: _Context, items: Sequence):
        self.ctx, self.items = ctx, list(items)

    @property
    def shape(self):
        inner = self.items[0].shape if self.items else ()
        return (len(self.items),) + tuple(inner)

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Vector(self.ctx, self.items[i])
        if isinstance(i, numbers.Integral) and not isinstance(i, bool):
            return self.items[i]
        raise self.ctx.refuse(f"the index {i!r}",
                              "index with integers and slices of the first "
                              "axis")


def _find_ctx(args, kwargs) -> _Context:
    stack = list(args) + list(kwargs.values())
    while stack:
        a = stack.pop()
        if isinstance(a, _Proxy):
            return a.ctx
        if isinstance(a, (list, tuple)):
            stack.extend(a)
    raise RuntimeError("no traced value among the arguments")  # unreachable


def _map(ctx, fn, *xs):
    """fn over the elements of the operands, a scalar broadcast over a
    vector (every vector of one length)."""
    vecs = [x for x in xs if isinstance(x, Vector)]
    if not vecs:
        return fn(*xs)
    k = len(vecs[0])
    if any(len(v) != k for v in vecs):
        raise ctx.refuse("an operation on vectors of different lengths",
                         f"lengths {[len(v) for v in vecs]}")
    return Vector(ctx, [_map(ctx, fn, *(x.items[i] if isinstance(x, Vector)
                                        else x for x in xs))
                        for i in range(k)])


def _check_operand(ctx, x, what):
    if isinstance(x, _Proxy):
        return x
    if _number(x):
        return _py(x)
    if torch.is_tensor(x):
        raise ctx.refuse(f"a tensor constant as an operand of {what}",
                         "write constants as Python numbers or with "
                         "zeros_like/ones_like/full_like")
    raise ctx.refuse(f"an operand of type {type(x).__name__} in {what}")


def _value(ctx, a, what):
    """An element of an operand: a comparison's result feeds only
    torch.where."""
    if isinstance(a, Scalar) and a.is_bool:
        raise ctx.refuse(f"a comparison's result as an operand of {what}",
                         "comparisons feed torch.where only")
    return a


def _unary(ctx, op, x):
    x = _check_operand(ctx, x, op)
    g = ctx.graph
    return _map(ctx, lambda a: Scalar(
        ctx, g.add(op, (_value(ctx, a, op).id,))), x)


_CMP = ("lt", "le", "gt", "ge", "eq", "ne")
_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq",
         "ne": "ne"}


def _binary(ctx, op, x, y):
    """x op y, x a proxy; ``rsub`` is y - x (Tensor.__rsub__)."""
    x = _check_operand(ctx, x, op)
    y = _check_operand(ctx, y, op)
    g = ctx.graph
    is_bool = op in _CMP

    def one(a, b):
        a, b = _value(ctx, a, op), _value(ctx, b, op)
        if isinstance(b, Scalar):
            if op == "rsub":
                return Scalar(ctx, g.add("sub", (b.id, a.id)))
            return Scalar(ctx, g.add(op, (a.id, b.id)), is_bool)
        return Scalar(ctx, g.add(op + "_s", (a.id,), b), is_bool)

    if not isinstance(x, _Proxy):
        # a number first (torch.add(2.0, x) and kin): the proxy's op with
        # the operands swapped where the op commutes
        if op in ("add", "mul"):
            x, y = y, x
        elif op in _CMP:
            x, y, op = y, x, _SWAP[op]
        elif op == "sub":
            x, y, op = y, x, "rsub"
        else:
            raise ctx.refuse(f"{op} with a Python number first")
    return _map(ctx, one, x, y)


def _clamp(ctx, x, lo, hi):
    x = _check_operand(ctx, x, "clamp")
    for v in (lo, hi):
        if v is not None and not _number(v):
            raise ctx.refuse("clamp with a traced or tensor bound",
                             "use torch.maximum / torch.minimum")
    g = ctx.graph

    def one(a):
        i = a.id
        if lo is not None:
            i = g.add("clamp_min", (i,), _py(lo))
        if hi is not None:
            i = g.add("clamp_max", (i,), _py(hi))
        return Scalar(ctx, i)

    return _map(ctx, one, x)


def _like(ctx, x, value):
    g = ctx.graph
    return _map(ctx, lambda a: Scalar(ctx, g.const(value)), x)


def _where(ctx, c, a, b):
    g = ctx.graph

    def val(v):
        if isinstance(v, _Proxy):
            return v
        if _number(v):
            return Scalar(ctx, g.const(float(v)))
        raise ctx.refuse(f"a where branch of type {type(v).__name__}")

    def one(cc, aa, bb):
        if not (isinstance(cc, Scalar) and cc.is_bool):
            raise ctx.refuse("torch.where on a condition that is not a "
                             "comparison of traced values")
        aa, bb = _value(ctx, aa, "where"), _value(ctx, bb, "where")
        return Scalar(ctx, g.add("where", (cc.id, aa.id, bb.id)))

    return _map(ctx, one, c, val(a), val(b))


def _stack(ctx, seq, dim=0):
    if dim != 0:
        raise ctx.refuse(f"torch.stack(dim={dim})", "stack along dim 0")
    items = []
    for x in seq:
        if not isinstance(x, _Proxy):
            raise ctx.refuse(f"a {type(x).__name__} in torch.stack",
                             "stack traced values only")
        if isinstance(x, Scalar) and x.is_bool:
            raise ctx.refuse("a comparison's result in torch.stack")
        items.append(x)
    shapes = {tuple(x.shape) for x in items}
    if len(shapes) > 1:
        raise ctx.refuse("torch.stack of values of different shapes",
                         f"shapes {sorted(shapes)}")
    return Vector(ctx, items)


def _torch_call(ctx, func, args, kwargs):
    name = getattr(func, "__name__", repr(func))
    if func in (torch.stack,):
        return _stack(ctx, *args, **kwargs)
    if kwargs and func is not torch.full_like:
        raise ctx.refuse(f"torch.{name} with keyword arguments "
                         f"{sorted(kwargs)}")
    if func in _UNARY_FNS and len(args) == 1:
        return _unary(ctx, _UNARY_FNS[func], args[0])
    if func in _BINARY_FNS and len(args) == 2:
        return _binary(ctx, _BINARY_FNS[func], args[0], args[1])
    if func is torch.rsub and len(args) == 2:
        return _binary(ctx, "rsub", args[0], args[1])
    if func is torch.clamp_min and len(args) == 2:
        return _clamp(ctx, args[0], args[1], None)
    if func is torch.clamp_max and len(args) == 2:
        return _clamp(ctx, args[0], None, args[1])
    if func is torch.where and len(args) == 3:
        return _where(ctx, *args)
    if func is torch.zeros_like and len(args) == 1:
        return _like(ctx, args[0], 0.0)
    if func is torch.ones_like and len(args) == 1:
        return _like(ctx, args[0], 1.0)
    if func is torch.full_like:
        a = dict(zip(("input", "fill_value"), args), **kwargs)
        if set(a) != {"input", "fill_value"} or not _number(a["fill_value"]):
            raise ctx.refuse("torch.full_like with a traced or tensor fill, "
                             "or other keywords")
        return _like(ctx, a["input"], float(a["fill_value"]))
    raise ctx.refuse(f"torch.{name}")


class TableLeaf:
    """The values of one table of a traced dataset: the leaf `index` in
    `data_flatten`'s order, of `shape`.  `core.interp`'s lookups call
    `lookup`; nothing else may read it."""

    def __init__(self, ctx: _Context, index: int, shape):
        self._ctx, self._index = ctx, int(index)
        self._shape = tuple(int(k) for k in shape)

    @property
    def shape(self):
        return self._shape

    def dim(self):
        return len(self._shape)

    def lookup(self, mode, *queries):
        """interp1d (one query) or interp2d (two) of this table at the
        traced queries: one ``lookup`` node per lane value."""
        ctx = self._ctx
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
        if len(queries) != len(self._shape):
            raise ctx.refuse(f"a {len(queries)}-query lookup of a "
                             f"{len(self._shape)}-D table")
        g = ctx.graph
        qs = []
        for q in queries:
            q = _check_operand(ctx, q, "a lookup")
            qs.append(Scalar(ctx, g.const(float(q))) if not isinstance(
                q, _Proxy) else q)

        def one(*a):
            ids = tuple(_value(ctx, x, "a lookup").id for x in a)
            return Scalar(ctx, g.add("lookup", ids, (self._index, mode)))

        return _map(ctx, one, *qs)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        leaf = next(a for a in args if isinstance(a, TableLeaf))
        raise leaf._ctx.refuse(
            f"torch.{getattr(func, '__name__', func)} on a dataset table",
            "read a table through core.interp's interp1d / interp2d")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self._ctx.refuse(f"the attribute .{name} of a dataset table",
                               "read a table through core.interp's "
                               "interp1d / interp2d")

    def __getitem__(self, i):
        raise self._ctx.refuse("indexing a dataset table",
                               "read a table through core.interp's "
                               "interp1d / interp2d")

    def __len__(self):
        return self._shape[0]


def data_layout(data):
    """The number of dimensions of each leaf of a dataset, in
    `data_flatten`'s order; raises where a leaf is not a 1-D or 2-D
    uniform table."""
    dims = []
    for i, tab in enumerate(data_tables(data)):
        if not isinstance(tab, (UniformTable1D, UniformTable2D)):
            raise NotImplementedError(
                f"dataset leaf {i} is a {type(tab).__name__}, not a "
                "UniformTable1D or UniformTable2D: a device functor reads "
                f"tables only ({ITEM})")
        want = 1 if isinstance(tab, UniformTable1D) else 2
        if tab.values.dim() != want:
            raise ValueError(f"dataset leaf {i}: a {type(tab).__name__} "
                             f"holds a {want}-D tensor, not "
                             f"{tab.values.dim()}-D")
        dims.append(want)
    return tuple(dims)


def _data_key(data):
    """The structure of a dataset a trace depends on: its tree (grids
    included, as the function may read them) and its leaves' shapes."""
    if data is None:
        return None
    leaves, treedef = data_flatten(data)
    return treedef, tuple(tuple(leaf.shape) for leaf in leaves)


def _data_proxy(ctx: _Context, data):
    """The dataset with each table's values a TableLeaf."""
    leaves, treedef = data_flatten(data)
    return data_unflatten(treedef, [TableLeaf(ctx, i, leaf.shape)
                                    for i, leaf in enumerate(leaves)])


def _shape_of(x):
    if isinstance(x, Scalar):
        return ()
    return (len(x.items),) + (_shape_of(x.items[0]) if x.items else ())


def _flat(x):
    if isinstance(x, Scalar):
        return [x.id]
    return [i for item in x.items for i in _flat(item)]


def _record(fn, graph: Graph, outputs, name: str, data=None) -> Traced:
    ctx = _Context(graph, name)
    u = Vector(ctx, [Scalar(ctx, graph.u(i)) for i in range(graph.n)])
    p = Vector(ctx, [Scalar(ctx, graph.p(j)) for j in range(graph.m)])
    t = Scalar(ctx, graph.t())
    out = (fn(u, p, t) if data is None
           else fn(u, p, t, _data_proxy(ctx, data)))
    outputs = tuple(int(k) for k in outputs)
    if not isinstance(out, (Vector if outputs else Scalar)) \
            or _shape_of(out) != outputs or any(
                isinstance(s, Scalar) and s.is_bool for s in _leaves(out)):
        got = _shape_of(out) if isinstance(out, _Proxy) else type(out).__name__
        raise NotImplementedError(
            f"{name!r} returned {got}, not a stacked value of shape "
            f"{outputs}: the device functor needs one value a component "
            f"({ITEM})")
    return Traced(graph, tuple(_flat(out)), outputs, name)


def _leaves(x):
    if isinstance(x, Scalar):
        return [x]
    return [s for item in x.items for s in _leaves(item)]


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def fn_name(fn) -> str:
    return getattr(fn, "__qualname__", None) or getattr(fn, "__name__",
                                                        repr(fn))


def _new_graph(n, m, data) -> Graph:
    return Graph(n, m, None if data is None else data_layout(data))


def trace(fn, n: int, m: int, *, outputs, graph: Optional[Graph] = None,
          data=None) -> Traced:
    """Trace ``fn(u, p, t)`` (``fn(u, p, t, data)`` where a dataset `data`
    is given) for n states and m parameters; `outputs` is the shape of its
    value, ``(n,)``, ``(n, m)``, ``(n, n)`` or ``()`` (an event's
    condition).  Into a new graph (cached per function object and dataset
    structure) or into `graph`, which then shares its nodes with the
    functions traced there before.  Raises `NotImplementedError` where fn
    does something the translator cannot take."""
    outputs = tuple(int(k) for k in outputs)
    if graph is not None:
        return _record(fn, graph, outputs, fn_name(fn), data)
    key = (int(n), int(m), outputs, _data_key(data))
    per_fn = _cached(fn)
    if per_fn is not None and key in per_fn:
        return per_fn[key]
    got = _record(fn, _new_graph(n, m, data), outputs, fn_name(fn), data)
    _store(fn, key, got)
    return got


def trace_pair(f, g, n: int, m: int, *, f_outputs, g_outputs,
               data=None) -> "tuple[Traced, Traced]":
    """f and g traced into one graph, so that the nodes they share (CRN's
    Hill term) are one node each; cached on f per g (and per dataset
    structure, where both take the dataset `data`)."""
    f_outputs = tuple(int(k) for k in f_outputs)
    g_outputs = tuple(int(k) for k in g_outputs)
    key = ("pair", g, int(n), int(m), f_outputs, g_outputs, _data_key(data))
    per_fn = _cached(f)
    if per_fn is not None and key in per_fn:
        return per_fn[key]
    graph = _new_graph(n, m, data)
    got = (_record(f, graph, f_outputs, fn_name(f), data),
           _record(g, graph, g_outputs, fn_name(g), data))
    _store(f, key, got)
    return got


def trace_event(condition, affect, n: int, m: int,
                ) -> "tuple[Traced, Optional[Traced]]":
    """An event's condition ``g(u, p, t)`` (0-d) and affect ``h(u, p,
    t)`` ((n,), or None) traced into one graph; cached on the condition per
    affect."""
    key = ("event", affect, int(n), int(m))
    per_fn = _cached(condition)
    if per_fn is not None and key in per_fn:
        return per_fn[key]
    graph = Graph(n, m)
    got = (_record(condition, graph, (), fn_name(condition)),
           None if affect is None
           else _record(affect, graph, (int(n),), fn_name(affect)))
    _store(condition, key, got)
    return got


def trace_interp(bpoly, stages: int) -> Traced:
    """A tableau's free interpolant ``bpoly(theta)`` (theta -> its
    `stages` weights, stacked) traced with theta a 0-d proxy: the graph's
    ``t`` stands for theta, and it has no u and no p.  Cached on bpoly."""
    key = ("interp", int(stages))
    per_fn = _cached(bpoly)
    if per_fn is not None and key in per_fn:
        return per_fn[key]
    got = _record(lambda u, p, t: bpoly(t), Graph(0, 0), (int(stages),),
                  fn_name(bpoly))
    _store(bpoly, key, got)
    return got


def _cached(fn):
    try:
        return _CACHE.get(fn)
    except TypeError:
        return None


def _store(fn, key, value):
    try:
        _CACHE.setdefault(fn, {})[key] = value
    except TypeError:
        pass    # not weakly referable: traced again next time
