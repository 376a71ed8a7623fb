"""The CUDA C++ emitter: traced functions as device functors, in each
kernel's existing functor interface.

- K1 (`erk_body.cuh`): ``n, m`` and ``template <class A, typename T>
  eval(u, p, t, du)``, every add, subtract, multiply and divide through
  the kernel's arithmetic policy ``A``, as `Lorenz` is written.
- K3 (`rosenbrock_body.cuh`): ``eval``, ``jac`` and ``eval_dfdt`` (f and
  ∂f/∂t at one point, their shared nodes once), every operation rounded on
  its own (arith.cuh's `Rounded`), as `Rober` is written.
- K4 (`sde_body.cuh`): ``drift``; ``diffusion`` (diagonal noise) or
  ``noise`` (general: g·dW summed left to right, product by product, the
  zero entries skipped, so the (n, m) matrix is never held); ``gdg``,
  (∂g/∂u)·g, where the noise is diagonal; the members ``n, k, m,
  diagonal, has_gdg, has_ddb``; and, where f's and g's nodes overlap,
  ``drift_and_noise`` with ``kSharedDriftNoise``, so the steppers compute
  the shared part once.

- K5 (`sde_adaptive_body.cuh`): K4's functor with ``gdg`` and, for the
  milstein pair, ``ddb``, ∂((∂g)·g)·g.
- The events of every kernel (`events.cuh`): ``enabled``, ``kAffect``,
  ``condition`` (0-d) and ``affect`` ((n,)), under the policy the kernel
  passes (`Rounded` in every event form).
- A user ERK tableau (`erk_tableau`): K1's tableau struct, with a free
  interpolant's weight function ``bpoly`` (`interp_weights`) where the
  tableau carries one.

A function traced with a dataset becomes a data functor: it holds the
kernel's table leaves (`interp.cuh` ``Leaf``, copied from ``Tables`` by its
constructor, as the hand-written `ForcedOsc` holds its one) and its
members are ``const``; a ``lookup`` node is interp.cuh's lookup of leaf k
in its mode, a ``lookup_jvp`` node that lookup's tangent
(`interp1d_tangent`, `interp2d_tangent`).

A node becomes one ``const T`` (or ``const bool``) temporary, in node
order; the inputs are read in place.  Constants are hexadecimal float
literals cast to T, exact in double and rounded once in float, as
PyTorch casts a Python number.  Each op is written as PyTorch's CUDA
kernel computes it (`csrc/generated.cuh`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.translate.ir import COMPARE, Graph, Traced

_ARITH = {"add": "add", "sub": "sub", "mul": "mul", "div": "div"}
_FUNCS = {"sqrt": "sqrt", "exp": "exp", "log": "log", "sin": "sin",
          "cos": "cos", "tanh": "tanh", "abs": "fabs"}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
        "ne": "!="}
_MODES = {"gather": "repro_data::kGather", "onehot": "repro_data::kOneHot",
          "cubic": "repro_data::kCubic"}


def literal(x: float) -> str:
    """A double as an exact C++ expression of type double."""
    x = float(x)
    if np.isnan(x):
        return "(0.0 / 0.0)"
    if np.isinf(x):
        return "(1.0 / 0.0)" if x > 0 else "(-1.0 / 0.0)"
    return x.hex()


def _f32_literal(x: np.float32) -> str:
    v = float(x)
    if np.isnan(v) or np.isinf(v):
        return f"float({literal(v)})"
    return v.hex() + "f"


def constant(x: float) -> str:
    """A Python number cast to T, as PyTorch casts a scalar operand."""
    return f"T({literal(x)})"


def reciprocal(x: float) -> str:
    """1 / x in T, as PyTorch's CUDA division by a host scalar forms it:
    in float the reciprocal of float(x), in double of x."""
    with np.errstate(divide="ignore", invalid="ignore"):
        r32 = np.float32(1.0) / np.float32(x)
        r64 = 1.0 / float(x) if float(x) != 0.0 else float(
            np.float64(1.0) / np.float64(x))
    return f"repro_gen::pick<T>({_f32_literal(r32)}, {literal(r64)})"


class Body:
    """The statements of one member function: a temporary per node, shared
    across the outputs written in it."""

    def __init__(self, graph: Graph, policy: str = "A"):
        self.g = graph
        self.policy = policy
        self.names: Dict[int, str] = {}
        self.lines: List[str] = []
        self.temps = 0

    def ref(self, i: int) -> str:
        """The C++ name of node i's value, emitting what it needs first."""
        if i in self.names:
            return self.names[i]
        for j in self.g.reachable([i]):
            if j not in self.names:
                self.names[j] = self._define(j)
        return self.names[i]

    def _define(self, i: int) -> str:
        op, args, attr = self.g.nodes[i]
        if op == "u":
            return f"u[{attr}]"
        if op == "p":
            return f"p[{attr}]"
        if op == "t":
            return "t"
        if op == "const":
            return constant(attr)
        x = [self.names[a] for a in args]
        A = self.policy
        is_bool = op in COMPARE or op.endswith("_s") and op[:-2] in COMPARE
        if op in _ARITH:
            e = f"{A}::{_ARITH[op]}({x[0]}, {x[1]})"
        elif op in ("add_s", "sub_s", "mul_s"):
            e = f"{A}::{op[:3]}({x[0]}, {constant(attr)})"
        elif op == "rsub_s":
            e = f"{A}::sub({constant(attr)}, {x[0]})"
        elif op == "div_s":
            e = f"{A}::mul({x[0]}, {reciprocal(attr)})"
        elif op == "neg":
            e = f"-{x[0]}"
        elif op == "reciprocal":
            e = f"{A}::div(T(1), {x[0]})"
        elif op in _FUNCS:
            e = f"{_FUNCS[op]}({x[0]})"
        elif op == "pow":
            e = f"pow({x[0]}, {x[1]})"
        elif op == "pow_s":
            e = self._pow(x[0], attr)
        elif op == "maximum":
            e = f"repro_gen::nmax({x[0]}, {x[1]})"
        elif op == "minimum":
            e = f"repro_gen::nmin({x[0]}, {x[1]})"
        elif op == "clamp_min":
            e = f"repro_gen::nmax({x[0]}, {constant(attr)})"
        elif op == "clamp_max":
            e = f"repro_gen::nmin({x[0]}, {constant(attr)})"
        elif op in _CMP:
            e = f"{x[0]} {_CMP[op]} {x[1]}"
        elif op.endswith("_s") and op[:-2] in _CMP:
            e = f"{x[0]} {_CMP[op[:-2]]} {constant(attr)}"
        elif op == "where":
            e = f"{x[0]} ? {x[1]} : {x[2]}"
        elif op == "lookup":
            leaf, mode = attr
            k = len(x)
            e = (f"repro_data::interp{k}d<{_MODES[mode]}, {A}>("
                 f"repro_data::Table{k}D<T>(leaf[{leaf}]), {', '.join(x)})")
        elif op == "lookup_jvp":
            leaf, mode, has = attr
            k = len(has)
            rest = iter(x[k:])
            tans = [next(rest) if h else "T(0)" for h in has]
            flags = "".join(f", {'true' if h else 'false'}" for h in has) \
                if k == 2 else ""
            e = (f"repro_data::interp{k}d_tangent<{_MODES[mode]}, {A}{flags}>"
                 f"(repro_data::Table{k}D<T>(leaf[{leaf}]), "
                 f"{', '.join(list(x[:k]) + tans)})")
        else:                                   # pragma: no cover
            raise ValueError(f"no C++ form for IR op {op!r}")
        name = f"v{self.temps}"
        self.temps += 1
        self.lines.append(f"const {'bool' if is_bool else 'T'} {name} = {e};")
        return name

    def _pow(self, x: str, e) -> str:
        """torch.pow(x, e) for a Python number e, on the card."""
        A = self.policy
        e = float(e)
        if e == 0.0:
            return "T(1)"
        if e == 1.0:
            return x
        if e == 0.5:
            return f"sqrt({x})"
        if e == 2.0:
            return f"{A}::mul({x}, {x})"
        if e == 3.0:
            return f"{A}::mul({A}::mul({x}, {x}), {x})"
        if e == -0.5:
            return f"rsqrt({x})"
        if e == -1.0:
            return f"{A}::div(T(1), {x})"
        if e == -2.0:
            return f"{A}::div(T(1), {A}::mul({x}, {x}))"
        return f"pow({x}, {constant(e)})"

    def assign(self, lhs: str, i: int):
        self.lines.append(f"{lhs} = {self.ref(i)};")

    def text(self, indent: str = "    ") -> str:
        return "\n".join(indent + line for line in self.lines)


def _member(head: str, body: Body, policy_using: bool = False) -> str:
    using = "    using A = repro_arith::Rounded;\n" if policy_using else ""
    return (f"  {head} {{\n{using}{body.text()}\n  }}\n")


def _data_parts(name: str, graph: Graph):
    """(the members' storage class, their qualifier, the data functor's
    leaves and constructor): static members without a dataset; const
    members of a functor that holds the kernel's table leaves with one."""
    if graph.data is None:
        return "static ", "", ""
    L = len(graph.data)
    init = ", ".join(f"d.leaf[{k}]" for k in range(L))
    return "", " const", (
        f"  repro_data::Leaf leaf[{L}];\n"
        f"  __device__ __forceinline__ explicit {name}("
        f"const repro_data::Tables& d)\n      : leaf{{{init}}} {{}}\n")


def _assign_all(body: Body, out: str, nodes: Sequence[int]):
    for c, i in enumerate(nodes):
        body.assign(f"{out}[{c}]", i)


def erk_functor(name: str, f: Traced) -> str:
    """K1's functor for the traced f (shape (n,))."""
    g = f.graph
    body = Body(g)
    _assign_all(body, "du", f.outputs)
    static, const, members = _data_parts(name, g)
    return (f"// {f.name}, traced\n"
            f"struct {name} {{\n"
            f"  static constexpr int n = {g.n}, m = {g.m};\n"
            + members
            + _member("template <class A, typename T>\n"
                      f"  __device__ __forceinline__ {static}void eval("
                      f"const T* u, const T* p, T t, T* du){const}", body)
            + "};\n")


def rosenbrock_functor(name: str, f: Traced, jac: Traced,
                       dfdt: Traced) -> str:
    """K3's functor: f (n,), its Jacobian (n, n) and ∂f/∂t (n,), every
    operation rounded on its own."""
    g = f.graph
    n = g.n
    ev = Body(g)
    _assign_all(ev, "du", f.outputs)
    jb = Body(g)
    for k, i in enumerate(jac.outputs):
        jb.assign(f"J[{k // n}][{k % n}]", i)
    both = Body(g)
    _assign_all(both, "du", f.outputs)
    _assign_all(both, "d", dfdt.outputs)
    static, const, members = _data_parts(name, g)
    head = f"template <typename T>\n  __device__ __forceinline__ {static}void"
    return (f"// {f.name}, traced; Jacobian {jac.name}; ∂f/∂t {dfdt.name}\n"
            f"struct {name} {{\n"
            f"  static constexpr int n = {n}, m = {g.m};\n"
            + members
            + _member(f"{head} eval(const T* u, const T* p, T t, T* du)"
                      f"{const}", ev, True)
            + _member(f"{head} jac(const T* u, const T* p, T t, T J[n][n])"
                      f"{const}", jb, True)
            + _member(f"{head} eval_dfdt(const T* u, const T* p, T t, T* du,"
                      f" T* d){const}", both, True)
            + "};\n")


def _noise_rows(body: Body, g: Traced, out: str = "out"):
    """out[i] = Σ_j g[i][j]·dW[j], left to right, the constant-zero entries
    skipped (they add a zero)."""
    A = body.policy
    for i, row in enumerate(g.rows()):
        acc: Optional[str] = None
        for j, node in enumerate(row):
            if body.g.is_const(node) and body.g.nodes[node].attr == 0.0:
                continue
            term = f"{A}::mul({body.ref(node)}, dW[{j}])"
            acc = term if acc is None else f"{A}::add({acc}, {term})"
        body.lines.append(f"{out}[{i}] = {acc if acc else 'T(0)'};")


def shared_nodes(f: Traced, g: Traced) -> List[int]:
    """The computed (non-leaf) nodes both f and g read."""
    G = f.graph
    both = set(G.reachable(f.outputs)) & set(G.reachable(g.outputs))
    return sorted(i for i in both
                  if G.nodes[i].op not in ("u", "p", "t", "const"))


def sde_functor(name: str, f: Traced, g: Traced, noise: str,
                gdg: Optional[Traced], ddb: Optional[Traced] = None) -> str:
    """K4's and K5's functor: drift f (n,), diffusion g ((n,) diagonal,
    (n, m) general) and, for diagonal noise, gdg = (∂g/∂u)·g and (the
    milstein pair's) ddb = ∂((∂g)·g)·g."""
    G = f.graph
    n, k = G.n, G.m
    diagonal = noise == "diagonal"
    m = n if diagonal else g.shape[1]
    static, const, members = _data_parts(name, G)
    head = ("template <class A, typename T>\n  __device__ __forceinline__ "
            f"{static}void")
    drift = Body(G)
    _assign_all(drift, "du", f.outputs)
    parts = [_member(f"{head} drift(const T* u, const T* p, T t, T* du)"
                     f"{const}", drift)]
    if diagonal:
        diff = Body(G)
        _assign_all(diff, "g", g.outputs)
        parts.append(_member(f"{head} diffusion(const T* u, const T* p, T t,"
                             f" T* g){const}", diff))
    else:
        nz = Body(G)
        _noise_rows(nz, g)
        parts.append(_member(f"{head} noise(const T* u, const T* p, T t, "
                             f"const T* dW, T* out){const}", nz))
    for member, tr in (("gdg", gdg), ("ddb", ddb)):
        if tr is not None:
            gb = Body(G)
            _assign_all(gb, "out", tr.outputs)
            parts.append(_member(f"{head} {member}(const T* u, const T* p, "
                                 f"T t, T* out){const}", gb))
    shared = bool(shared_nodes(f, g))
    if shared:
        both = Body(G)
        _assign_all(both, "du", f.outputs)
        if diagonal:
            for c, i in enumerate(g.outputs):
                both.lines.append(f"out[{c}] = {both.policy}::mul("
                                  f"{both.ref(i)}, dW[{c}]);")
        else:
            _noise_rows(both, g)
        parts.append("  static constexpr bool kSharedDriftNoise = true;\n"
                     + _member(f"{head} drift_and_noise(const T* u, const T*"
                               " p, T t, const T* dW, T* du, T* out)"
                               f"{const}", both))
    flag = lambda x: "true" if x is not None else "false"  # noqa: E731
    return (f"// drift {f.name}, {noise} noise {g.name}, traced"
            + (f"; gdg {gdg.name}" if gdg is not None else "")
            + (f"; ddb {ddb.name}" if ddb is not None else "") + "\n"
            f"struct {name} {{\n"
            f"  static constexpr int n = {n}, k = {k}, m = {m};\n"
            f"  static constexpr bool diagonal = "
            f"{'true' if diagonal else 'false'};\n"
            f"  static constexpr bool has_gdg = {flag(gdg)}, has_ddb = "
            f"{flag(ddb)};\n"
            + members + "".join(parts) + "};\n")


def event_functor(name: str, condition: Traced,
                  affect: Optional[Traced] = None) -> str:
    """An event functor of `events.cuh`: the traced condition (0-d) and,
    where given, the traced affect ((n,)), each under the kernel's policy
    ``A``, as `BallBounce` is written."""
    G = condition.graph
    head = ("template <class A, typename T>\n  __device__ __forceinline__ "
            "static")
    cb = Body(G)
    cb.lines.append(f"return {cb.ref(condition.outputs[0])};")
    parts = [_member(f"{head} T condition(const T* u, const T* p, T t)", cb)]
    if affect is not None:
        ab = Body(G)
        _assign_all(ab, "out", affect.outputs)
        parts.append(_member(f"{head} void affect(const T* u, const T* p, "
                             "T t, T* out)", ab))
    return (f"// condition {condition.name}"
            + (f", affect {affect.name}" if affect is not None else "")
            + ", traced\n"
            f"struct {name} {{\n"
            "  static constexpr bool enabled = true;\n"
            f"  static constexpr bool kAffect = "
            f"{'true' if affect is not None else 'false'};\n"
            + "".join(parts) + "};\n")


def _array(values) -> str:
    vals = [literal(float(v)) for v in np.asarray(values, np.float64).ravel()]
    return ", ".join(vals)


def interp_weights(interp: Traced) -> str:
    """The free interpolant's weight function of K1's tableau interface,
    ``bpoly(t, w)`` with t standing for theta: the traced ``bpoly(theta)``
    under the kernel's policy ``A``, every operation in the traced order,
    as `tsit5_bpoly` is written."""
    body = Body(interp.graph)
    _assign_all(body, "w", interp.outputs)
    return _member("template <class A, typename T>\n  __device__ "
                   "__forceinline__ static void bpoly(T t, "
                   f"T (&w)[{len(interp.outputs)}])", body)


def erk_tableau(name: str, tab, interp: Optional[Traced] = None, *,
                rounded: bool = True, stream_sums: bool = True) -> str:
    """A user ERK tableau as a struct of K1's tableau interface, like
    `Rkck54` in csrc/erk_tableaus.cu: by default every operation rounded
    on its own (`rounded`) and the sums streamed; with `interp` (the traced
    free interpolant) its weight function (`interp_weights`) as the dense
    output, else Hermite."""
    s = int(tab.stages)
    a = np.asarray(tab.a, np.float64)
    rows = ",\n        ".join("{" + _array(a[i]) + "}" for i in range(s))
    flag = lambda x: "true" if x else "false"  # noqa: E731
    return (f"// the user tableau {tab.name!r} (order {tab.order}, embedded "
            f"order {tab.embedded_order}"
            + (f", free interpolant {interp.name}" if interp is not None
               else "") + ")\n"
            f"struct {name} {{\n"
            f"  static constexpr int stages = {s};\n"
            f"  static constexpr bool fsal = {flag(tab.fsal)}, stream_sums = "
            f"{flag(stream_sums)};\n"
            f"  static constexpr bool rounded = {flag(rounded)};\n"
            f"  static constexpr bool free_interp = "
            f"{flag(interp is not None)};\n"
            f"  static constexpr int embedded_order = "
            f"{int(tab.embedded_order)};\n"
            + ("" if interp is None else interp_weights(interp)) +
            f"  __host__ __device__ static constexpr double a(int i, int j) {{\n"
            f"    constexpr double A[{s}][{s}] = {{\n        {rows}}};\n"
            f"    return A[i][j];\n  }}\n"
            f"  __host__ __device__ static constexpr double b(int i) {{\n"
            f"    constexpr double B[{s}] = {{{_array(tab.b)}}};\n"
            f"    return B[i];\n  }}\n"
            f"  __host__ __device__ static constexpr double btilde(int i) {{\n"
            f"    constexpr double BT[{s}] = {{{_array(tab.btilde)}}};\n"
            f"    return BT[i];\n  }}\n"
            f"  __host__ __device__ static constexpr double c(int i) {{\n"
            f"    constexpr double C[{s}] = {{{_array(tab.c)}}};\n"
            f"    return C[i];\n  }}\n"
            "};\n")
