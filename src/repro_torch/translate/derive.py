"""Forward-mode derivatives on the IR.

`jacobian` gives ∂f/∂u (the stiff kernel's Jacobian where the problem
ships none: the reference's `jacfwd` in `rosenbrock_body`, the plain
version's `torch.func.jacfwd`), `time_derivative` gives ∂f/∂t (the stiff
kernel's `eval_dfdt`, the reference's `jvp` along t) and `jvp` gives the
derivative of a function along another (Milstein's (∂g/∂u)·g, and, of
that, the milstein pair's ∂((∂g)·g)·g).  A dataset lookup's tangent is one
``lookup_jvp`` node (`ir`), the lookup's derivative along its queries in
its mode, with `core.interp`'s half slope on a table's bounds; a lookup's
second derivative refuses.

Each node's tangent follows the operand order of PyTorch's own forward-AD
formula for the op (derivatives.yaml), so that `ir.evaluate` of a
derivative replays what `torch.func.jvp` computes.  A tangent that is
identically zero is symbolic (None) and dropped, as PyTorch drops an
undefined tangent; a tangent that is the constant 1 (the seed of ∂/∂u_j
and ∂/∂t) multiplies nothing, since x·1 = x exactly.  `torch.func.jacfwd`
pushes dense zeros where this drops them, so the two differ only where a
dropped term is not an exact zero: an infinite or NaN partner, or the sign
of a zero.

The derivative nodes are added to the traced function's own graph, so
they share its nodes (a Jacobian entry that reads ``q*y1`` reads f's).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.translate.ir import COMPARE, COMPARE_S, Graph, Traced
from repro_torch.translate.trace import ITEM


def _refuse(op: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"cannot differentiate {op} in {name!r} on the card: pass the "
        f"problem's analytic Jacobian (jac=) or write the term with "
        f"differentiable ops ({ITEM})")


class _Tangents:
    """Builds tangent nodes into `g`, folding x·1 and symbolic zeros."""

    def __init__(self, g: Graph):
        self.g = g

    def neg(self, a):
        node = self.g.nodes[a]
        if node.op == "const":
            return self.g.const(-node.attr)
        return self.g.add("neg", (a,))

    def mul(self, a, b):
        """a·b with a a tangent: a == 1 gives b, a == -1 gives -b (both
        exact)."""
        if self.g.is_const(a, 1.0):
            return b
        if self.g.is_const(a, -1.0):
            return self.neg(b)
        return self.g.add("mul", (a, b))

    def add(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return self.g.add("add", (a, b))


def forward(traced: Traced, seeds: Dict[int, int]) -> Dict[int, Optional[int]]:
    """The tangent node (None: zero) of every node the outputs of `traced`
    depend on, the leaves in `seeds` carrying theirs."""
    g = traced.graph
    T = _Tangents(g)
    tan: Dict[int, Optional[int]] = {}
    for i in g.reachable(traced.outputs):
        op, args, attr = g.nodes[i]
        ts = [tan[a] for a in args]
        if op in ("u", "p", "t", "const"):
            tan[i] = seeds.get(i)
            continue
        if all(x is None for x in ts) or op in COMPARE + COMPARE_S:
            tan[i] = None
            continue
        st = ts[0]
        ot = ts[1] if len(ts) > 1 else None
        a = args[0]
        b = args[1] if len(args) > 1 else None
        if op == "add":
            out = T.add(st, ot)
        elif op == "sub":
            out = st if ot is None else (
                T.neg(ot) if st is None else g.add("sub", (st, ot)))
        elif op == "mul":
            # other_t * self_p + self_t * other_p
            out = T.add(None if ot is None else T.mul(ot, a),
                        None if st is None else T.mul(st, b))
        elif op == "div":
            # (self_t - other_t * result) / other_p
            if ot is None:
                num = st
            else:
                prod = T.mul(ot, i)
                num = T.neg(prod) if st is None else g.add("sub", (st, prod))
            out = g.add("div", (num, b))
        elif op in ("add_s", "sub_s"):
            out = st
        elif op == "rsub_s":
            out = T.neg(st)
        elif op == "mul_s":
            out = g.add("mul_s", (st,), attr)
        elif op == "div_s":
            out = g.add("div_s", (st,), attr)
        elif op == "neg":
            out = T.neg(st)
        elif op == "pow_s":
            # grad * (exponent * self.pow(exponent - 1))
            if float(attr) == 0.0:
                out = None
            else:
                e = float(attr)
                inner = g.add("mul_s", (g.add("pow_s", (a,), e - 1.0),), e)
                out = T.mul(st, inner)
        elif op == "pow":
            if ot is not None:
                raise _refuse("a power whose exponent depends on the "
                              "variable", traced.name)
            # where(exponent == 0, 0, grad * (exponent * self.pow(exponent - 1)))
            inner = g.add("mul", (b, g.add("pow", (a, g.add("sub_s", (b,),
                                                              1)))))
            out = g.add("where", (g.add("eq_s", (b,), 0.0), g.const(0.0),
                                  T.mul(st, inner)))
        elif op == "sqrt":
            # self_t / (2 * result)
            out = g.add("div", (st, g.add("mul_s", (i,), 2)))
        elif op == "exp":
            out = T.mul(st, i)
        elif op == "log":
            out = g.add("div", (st, a))
        elif op == "sin":
            out = T.mul(st, g.add("cos", (a,)))
        elif op == "cos":
            out = T.mul(st, g.add("neg", (g.add("sin", (a,)),)))
        elif op == "reciprocal":
            # -self_t * (result * result)
            out = g.add("mul", (T.neg(st), g.add("mul", (i, i))))
        elif op == "clamp_min":
            out = g.add("where", (g.add("ge_s", (a,), attr), st,
                                  g.const(0.0)))
        elif op == "clamp_max":
            out = g.add("where", (g.add("le_s", (a,), attr), st,
                                  g.const(0.0)))
        elif op == "where":
            zero = g.const(0.0)
            sa = ts[1] if ts[1] is not None else zero
            sb = ts[2] if ts[2] is not None else zero
            out = g.add("where", (a, sa, sb))
        elif op == "lookup":
            # the lookup's tangent along the queries that carry one
            # (interp.cuh `interp1d_tangent`, `interp2d_tangent`)
            has = tuple(x is not None for x in ts)
            out = g.add("lookup_jvp", args + tuple(x for x in ts
                                                   if x is not None),
                        (attr[0], attr[1], has))
        else:
            raise _refuse(op, traced.name)
        tan[i] = out
    return tan


def _outputs(traced: Traced, tan, shape, name) -> Traced:
    g = traced.graph
    outs = tuple(g.const(0.0) if tan.get(i) is None else tan[i]
                 for i in traced.outputs)
    return Traced(g, outs, shape, name)


def jacobian(traced: Traced) -> Traced:
    """∂f/∂u of a traced f of shape (k,): a Traced of shape (k, n), row i
    the gradient of f_i ((n, n) for a right-hand side)."""
    g = traced.graph
    n = g.n
    one = g.const(1.0)
    cols = [forward(traced, {g.u(j): one}) for j in range(n)]
    outs = []
    for i in traced.outputs:
        for j in range(n):
            t = cols[j].get(i)
            outs.append(g.const(0.0) if t is None else t)
    return Traced(g, tuple(outs), (len(traced.outputs), n),
                  f"jacobian({traced.name})")


def time_derivative(traced: Traced) -> Traced:
    """∂f/∂t of a traced f, of f's shape."""
    g = traced.graph
    tan = forward(traced, {g.t(): g.const(1.0)})
    return _outputs(traced, tan, traced.shape, f"dt({traced.name})")


def jvp(traced: Traced, along: Traced) -> Traced:
    """The derivative of a traced g (shape (n,)) along the values of
    `along` (shape (n,), in the same graph): ``(∂g/∂u)·along``, Milstein's
    (∂g/∂u)·g with ``along=g``."""
    if along.graph is not traced.graph or along.shape != (traced.graph.n,):
        raise ValueError("jvp: the direction must be a traced (n,) value of "
                         "the same graph")
    g = traced.graph
    seeds = {g.u(i): along.outputs[i] for i in range(g.n)}
    tan = forward(traced, seeds)
    return _outputs(traced, tan, traced.shape, f"jvp({traced.name})")
