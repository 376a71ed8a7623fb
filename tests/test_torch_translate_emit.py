"""The emitter and the generated units on the CPU (`repro_torch.translate`
emit.py, units.py): the emitted K1, K3 and K4 functors compiled as host
code with g++ against a stub ``cuda_runtime.h`` (one compile for the
file; skipped without g++) and called through ctypes against `evaluate` —
bitwise where every op is an add, subtract, multiply, divide, a product
form of pow or a select; within 4 ulps of the output's largest value where
the host's libm (exp, log, sin, cos, tanh, pow), PyTorch's CPU sqrt (not
correctly rounded) or the card's division by a Python number (a multiply
by its reciprocal, emitted as the card computes it) differs from
PyTorch's CPU kernels — the emitted user tableau parsed back into
its arrays, and every generated C entry parsed against its wrapper's
`argtypes()`."""
import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import de_problems as dp
from repro_torch.convert import tableau_from_arrays
from repro_torch.core.tableaus import ROSENBROCK_TABLEAUS, get_tableau
from repro_torch.kernels.em import kernel as k4
from repro_torch.kernels.rosenbrock import kernel as k3
from repro_torch.kernels.tsit5 import kernel as k1
from repro_torch.translate import derive, emit, units
from repro_torch.translate.ir import evaluate
from repro_torch.translate.trace import trace, trace_pair

from test_torch_translate import cos_stiff, diff_ops, many_ops

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
F32, F64 = torch.float32, torch.float64
HEUN = tableau_from_arrays("heun_euler", [[0.0, 0.0], [1.0, 0.0]],
                           [0.5, 0.5], [-0.5, 0.5], [0.0, 1.0], order=2,
                           embedded_order=1, fsal=False)

STUB = r"""
#pragma once
#include <cmath>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
typedef void* cudaStream_t;
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float rsqrt(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::sqrt; using std::exp; using std::log; using std::sin;
using std::cos; using std::tanh; using std::fabs; using std::pow;
"""

# ops whose results the host computes as PyTorch's CPU kernels do
EXACT = {"u", "p", "t", "const", "add", "sub", "mul", "div", "neg",
         "add_s", "sub_s", "rsub_s", "mul_s", "reciprocal", "maximum",
         "minimum", "clamp_min", "clamp_max", "where", "lt", "le", "gt",
         "ge", "eq", "ne", "lt_s", "le_s", "gt_s", "ge_s", "eq_s", "ne_s",
         "abs"}
EXACT_POW = {0.0, 1.0, 2.0, 3.0, -1.0, -2.0}


def _exact(graph, node) -> bool:
    for i in graph.reachable([node]):
        op, _, attr = graph.nodes[i]
        if op == "pow_s" and float(attr) in EXACT_POW:
            continue
        if op not in EXACT:
            return False
    return True


def five_states(fn):
    """fn (two states, five outputs) as a right-hand side of five states,
    the last three unread."""
    def rhs(u, p, t):
        return torch.stack(list(fn(u[:2], p, t)))
    rhs.__name__ = fn.__name__
    return rhs


MANY_OPS, DIFF_OPS = five_states(many_ops), five_states(diff_ops)


def _k1_cases():
    return {"lorenz": (dp.lorenz_rhs, 3, 3), "vdp": (dp.vdp_rhs, 2, 1),
            "orego": (dp.orego_rhs, 3, 3), "cos_stiff": (cos_stiff, 1, 1),
            "many_ops": (MANY_OPS, 5, 1), "sho": (dp.sho_rhs, 2, 1),
            "ball": (dp.bouncing_ball_rhs, 2, 2)}


def _k1_traced(name):
    fn, n, m = _k1_cases()[name]
    return trace(fn, n, m, outputs=(n,))


@functools.lru_cache(maxsize=None)
def _library(tmp: str):
    """Every emitted functor of this file in one host library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of the emitted functors")
    d = Path(tmp)
    (d / "cuda_runtime.h").write_text(STUB)
    parts = ['#include "arith.cuh"', '#include "generated.cuh"',
             "#include <cstddef>", ""]
    wrappers = []
    for name in sorted(_k1_cases()):
        tr = _k1_traced(name)
        parts.append(emit.erk_functor(f"K1_{name}", tr))
        for T in ("float", "double"):
            wrappers.append(
                f'extern "C" void k1_{name}_{T}(const {T}* u, const {T}* p,'
                f" {T} t, {T}* du) {{ K1_{name}::eval<repro_arith::Rounded>"
                "(u, p, t, du); }")
    for name, (f, jac) in _k3_cases().items():
        tf, J, dT = _k3_traced(name)
        parts.append(emit.rosenbrock_functor(f"K3_{name}", tf, J, dT))
        n = tf.graph.n
        for T in ("float", "double"):
            wrappers.append(
                f'extern "C" void k3_{name}_{T}(const {T}* u, const {T}* p,'
                f" {T} t, {T}* du, {T}* J, {T}* d, {T}* du2) {{\n"
                f"  K3_{name}::eval(u, p, t, du);\n"
                f"  K3_{name}::jac(u, p, t, reinterpret_cast<{T}(*)[{n}]>"
                "(J));\n"
                f"  K3_{name}::eval_dfdt(u, p, t, du2, d); }}")
    for name in _k4_cases():
        tf, tg, noise, gdg = _k4_traced(name)
        parts.append(emit.sde_functor(f"K4_{name}", tf, tg, noise, gdg))
        for T in ("float", "double"):
            body = (f"  using A = repro_arith::Rounded; using P = K4_{name};\n"
                    "  P::drift<A>(u, p, t, du);\n")
            if noise == "diagonal":
                body += "  P::diffusion<A>(u, p, t, g); P::gdg<A>(u, p, t, gd);\n"
            else:
                body += ("  P::noise<A>(u, p, t, dW, g);\n"
                         "  P::drift_and_noise<A>(u, p, t, dW, du2, gd);\n")
            wrappers.append(
                f'extern "C" void k4_{name}_{T}(const {T}* u, const {T}* p,'
                f" {T} t, const {T}* dW, {T}* du, {T}* g, {T}* gd, {T}* du2)"
                f" {{\n{body}}}")
    src = d / "emitted.cpp"
    src.write_text("\n".join(parts + wrappers) + "\n")
    lib = d / "emitted.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(d), "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _library(str(tmp_path_factory.mktemp("emitted")))


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _scalar(T, v):
    return (ctypes.c_float if T == "float" else ctypes.c_double)(float(v))


def _ulps(got, want, dtype):
    """|got - want| in ulps of want's largest value over the lanes."""
    eps = torch.finfo(dtype).eps
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / (scale * eps)


def _check(graph, nodes, got, want, dtype, what):
    """got and want (k, B): bitwise where the node is exact, else within 4
    ulps of the output's largest value."""
    for c, node in enumerate(nodes):
        a, b = got[c], want[c]
        assert torch.equal(a.isnan(), b.isnan()), what
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        if _exact(graph, node):
            assert torch.equal(a, b), (what, c)
        else:
            assert _ulps(a, b, dtype) <= 4, (what, c)


def _points(n, m, dtype, B=64, seed=0):
    rng = np.random.default_rng(seed)
    u = torch.tensor(rng.uniform(0.05, 2.0, (B, n)), dtype=dtype)
    p = torch.tensor(rng.uniform(0.5, 4.0, (B, m)), dtype=dtype)
    t = torch.tensor(rng.uniform(0.0, 3.0, B), dtype=dtype)
    return u, p, t


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(_k1_cases()))
def test_k1_functor_matches_evaluate(lib, name, dtype):
    tr = _k1_traced(name)
    n, m, k = tr.graph.n, tr.graph.m, tr.shape[0]
    T = "float" if dtype == F32 else "double"
    fn = getattr(lib, f"k1_{name}_{T}")
    u, p, t = _points(n, m, dtype)
    got = torch.empty(len(t), k, dtype=dtype)
    for b in range(len(t)):
        ub, pb, out = u[b].contiguous(), p[b].contiguous(), got[b]
        fn(_ptr(ub), _ptr(pb), _scalar(T, t[b]), _ptr(out))
    want = evaluate(tr, u.T, p.T, t)
    _check(tr.graph, tr.outputs, got.T, want, dtype, name)


def _k3_cases():
    return {"rober": (dp.rober_rhs, dp.rober_jac),
            "rober_derived": (lambda u, p, t: dp.rober_rhs(u, p, t), None),
            "orego": (dp.orego_rhs, None), "vdp": (dp.vdp_rhs, None),
            "cos_stiff": (cos_stiff, None), "diff_ops": (DIFF_OPS, None)}


@functools.lru_cache(maxsize=None)
def _k3_traced(name):
    f, jac = _k3_cases()[name]
    n = {"rober": 3, "rober_derived": 3, "orego": 3, "vdp": 2,
         "cos_stiff": 1, "diff_ops": 5}[name]
    m = 3 if n == 3 else 1
    if jac is None:
        tf = trace(f, n, m, outputs=(n,))
        return tf, derive.jacobian(tf), derive.time_derivative(tf)
    tf, tj = trace_pair(f, jac, n, m, f_outputs=(n,), g_outputs=(n, n))
    return tf, tj, derive.time_derivative(tf)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(_k3_cases()))
def test_k3_functor_matches_evaluate(lib, name, dtype):
    tf, J, dT = _k3_traced(name)
    n, m = tf.graph.n, tf.graph.m
    T = "float" if dtype == F32 else "double"
    fn = getattr(lib, f"k3_{name}_{T}")
    u, p, t = _points(n, m, dtype, seed=1)
    if name.startswith("rober"):
        p = p * torch.tensor([0.01, 3e7, 1e4], dtype=dtype)
    B = len(t)
    du, Jg = torch.empty(B, n, dtype=dtype), torch.empty(B, n, n, dtype=dtype)
    d, du2 = torch.empty(B, n, dtype=dtype), torch.empty(B, n, dtype=dtype)
    for b in range(B):
        fn(_ptr(u[b].contiguous()), _ptr(p[b].contiguous()),
           _scalar(T, t[b]), _ptr(du[b]), _ptr(Jg[b]), _ptr(d[b]),
           _ptr(du2[b]))
    uu, pp = u.T.contiguous(), p.T.contiguous()
    g = tf.graph
    _check(g, tf.outputs, du.T, evaluate(tf, uu, pp, t), dtype, "f")
    assert torch.equal(du, du2)
    _check(g, J.outputs, Jg.reshape(B, n * n).T,
           evaluate(J, uu, pp, t).reshape(n * n, B), dtype, "jac")
    _check(g, dT.outputs, d.T, evaluate(dT, uu, pp, t), dtype, "dfdt")


def _k4_cases():
    return {"gbm": (dp.gbm_drift, dp.gbm_diffusion, "diagonal", 3, 2),
            "crn": (dp.crn_drift, dp.crn_diffusion, "general", 4, 6),
            "sqrt_noise": (lambda u, p, t: -p[0] * u,
                           lambda u, p, t: p[1] * torch.sqrt(u) / 3.0,
                           "diagonal", 2, 2)}


@functools.lru_cache(maxsize=None)
def _k4_traced(name):
    f, g, noise, n, m = _k4_cases()[name]
    g_out = (n,) if noise == "diagonal" else (n, 8)
    tf, tg = trace_pair(f, g, n, m, f_outputs=(n,), g_outputs=g_out)
    gdg = derive.jvp(tg, tg) if noise == "diagonal" else None
    return tf, tg, noise, gdg


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(_k4_cases()))
def test_k4_functor_matches_evaluate(lib, name, dtype):
    tf, tg, noise, gdg = _k4_traced(name)
    n, m = tf.graph.n, tf.graph.m
    k = n if noise == "diagonal" else tg.shape[1]
    T = "float" if dtype == F32 else "double"
    fn = getattr(lib, f"k4_{name}_{T}")
    u, p, t = _points(n, m, dtype, seed=2)
    dW = torch.tensor(np.random.default_rng(3).standard_normal((len(t), k)),
                      dtype=dtype)
    B = len(t)
    du, g, gd = (torch.empty(B, n, dtype=dtype) for _ in range(3))
    du2 = torch.empty(B, n, dtype=dtype)
    for b in range(B):
        fn(_ptr(u[b].contiguous()), _ptr(p[b].contiguous()),
           _scalar(T, t[b]), _ptr(dW[b].contiguous()), _ptr(du[b]),
           _ptr(g[b]), _ptr(gd[b]), _ptr(du2[b]))
    uu, pp = u.T.contiguous(), p.T.contiguous()
    G = tf.graph
    _check(G, tf.outputs, du.T, evaluate(tf, uu, pp, t), dtype, "drift")
    gv = evaluate(tg, uu, pp, t)
    if noise == "diagonal":
        _check(G, tg.outputs, g.T, gv, dtype, "diffusion")
        _check(G, gdg.outputs, gd.T, evaluate(gdg, uu, pp, t), dtype, "gdg")
    else:
        # core.sde.apply_noise: each product and sum on its own, left to
        # right; the zero entries add nothing
        want = gv[:, 0] * dW.T[0]
        for j in range(1, k):
            want = want + gv[:, j] * dW.T[j]
        for i, row in enumerate(tg.rows()):
            a, b = torch.nan_to_num(g.T[i]), torch.nan_to_num(want[i])
            if all(_exact(G, node) for node in row):
                assert torch.equal(a, b), ("noise", i)
            else:
                assert _ulps(a, b, dtype) <= 4, ("noise", i)
        assert torch.equal(torch.nan_to_num(gd), torch.nan_to_num(g))
        assert torch.equal(torch.nan_to_num(du2), torch.nan_to_num(du))


def test_shared_drift_noise_only_where_f_and_g_share_nodes():
    crn = emit.sde_functor("P", *_k4_traced("crn"))
    gbm = emit.sde_functor("P", *_k4_traced("gbm"))
    assert "kSharedDriftNoise = true" in crn and "drift_and_noise" in crn
    assert "drift_and_noise" not in gbm
    assert "has_gdg = true, has_ddb = false" in gbm
    assert "has_gdg = false, has_ddb = false" in crn
    # the noise never holds the matrix: two products a row, zeros skipped
    noise = crn.split(" noise(", 1)[1].split("\n  }", 1)[0]
    assert noise.count("dW[") == 8


def test_constants_are_exact_hex_literals_cast_to_T():
    assert emit.constant(1.0 / 3.0) == "T(0x1.5555555555555p-2)"
    assert float.fromhex(emit.literal(0.1)) == 0.1
    r = emit.reciprocal(3.0)
    f32, f64 = re.match(r"repro_gen::pick<T>\((\S+)f, (\S+)\)", r).groups()
    assert np.float32(float.fromhex(f32)) == np.float32(1) / np.float32(3)
    assert float.fromhex(f64) == 1.0 / 3.0


def parse_tableau(text, name):
    """(a, b, btilde, c) of the struct `name` in `text` (hexadecimal or
    decimal literals)."""
    body = text.split(f"struct {name} {{", 1)[1].split("\n};", 1)[0]
    s = int(re.search(r"stages = (\d+);", body).group(1))

    def arr(var):
        m = re.search(rf"constexpr double {var}\[[^=]*= \{{(.*?)\}};",
                      body, re.S)
        nums = re.findall(r"-?0x[0-9a-fA-F.]+p[+-]\d+|-?[0-9][0-9.e+-]*",
                          m.group(1).replace("{", " ").replace("}", " "))
        return np.array([float.fromhex(v) if "x" in v else float(v)
                         for v in nums], np.float64)

    return arr("A").reshape(s, s), arr("B"), arr("BT"), arr("C")


def test_user_tableau_struct_parses_back_into_its_arrays():
    text = emit.erk_tableau("UserTableau", HEUN)
    a, b, bt, c = parse_tableau(text, "UserTableau")
    for got, want in ((a, HEUN.a), (b, HEUN.b), (bt, HEUN.btilde),
                      (c, HEUN.c)):
        assert np.array_equal(got, want)
    assert "rounded = true" in text and "free_interp = false" in text
    vern7 = get_tableau("vern7")
    user = tableau_from_arrays("v7", vern7.a, vern7.b, vern7.btilde,
                               vern7.c, order=7, embedded_order=6,
                               fsal=False)
    a, b, bt, c = parse_tableau(emit.erk_tableau("V", user), "V")
    # the hand-written structs parse alike: the emitter's literals are
    # the .cu files' values
    a, b, bt, c = parse_tableau(units.hand_struct("erk_tableaus.cu",
                                                  "Vern7"), "Vern7")
    assert np.array_equal(a, vern7.a) and np.array_equal(bt, vern7.btilde)
    assert np.array_equal(a, vern7.a) and np.array_equal(bt, vern7.btilde)


def test_a_registered_tableau_is_the_hand_written_struct():
    lor = trace(dp.lorenz_rhs, 3, 3, outputs=(3,))
    for name, (source, struct) in units.ERK_TABLEAU_STRUCTS.items():
        text = units.erk_unit(lor, get_tableau(name), F64).text
        assert units.hand_struct(source, struct) in text
        assert f"launch<Real, {struct}, Rhs, repro_ev::NoEvent>" in text
    hand = units.erk_unit(None, HEUN, F32, hand_functor="repro_erk::Lorenz")
    assert "UserTableau, repro_erk::Lorenz" in hand.text
    # a free interpolant is traced into the struct's weight function
    # (tests/test_torch_translate_interp.py); one that gives no stacked
    # weights refuses, naming item 17
    with pytest.raises(NotImplementedError, match="returned.*item 17"):
        units.erk_unit(lor, HEUN._replace(interp_bpoly=lambda th: th), F64)
    lin = units.erk_unit(lor, HEUN._replace(
        interp_bpoly=lambda th: torch.stack([0.5 * th, 0.5 * th])), F64)
    assert "static void bpoly(T t, T (&w)[2])" in lin.text


C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
           "double": ctypes.c_double, "long long": ctypes.c_longlong,
           "const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "const double*": ctypes.c_void_p, "const int*": ctypes.c_void_p}


def c_entries(text):
    """{name: [argument declarations]} of the extern "C" entries of a
    unit's or a source's text."""
    return {m.group(1): [" ".join(a.split()) for a in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                 text, re.S)}


def _types(args):
    return [C_TYPES[re.sub(r"\s+", " ", a).rsplit(" ", 1)[0]
                    .replace(" *", "*")] for a in args]


def _units():
    lor = trace(dp.lorenz_rhs, 3, 3, outputs=(3,))
    rob, rj = trace_pair(lambda u, p, t: dp.rober_rhs(u, p, t), dp.rober_jac,
                         3, 3, f_outputs=(3,), g_outputs=(3, 3))
    crn = _k4_traced("crn")
    return {
        "k1": units.erk_unit(lor, HEUN, F64),
        "k3": units.rosenbrock_unit(rob, rj, derive.time_derivative(rob),
                                    ROSENBROCK_TABLEAUS["rodas5p"], F32),
        "k4": units.sde_unit(crn[0], crn[1], "general", None, "heun_strat",
                             F64)}


@pytest.mark.parametrize("kernel", ["k1", "k3", "k4"])
def test_generated_c_entries_take_what_the_wrappers_pass(kernel):
    """Each generated entry has the hand-written entry's name and argument
    list (the wrappers bind both with one `argtypes()`)."""
    entries = c_entries(_units()[kernel].text)
    if kernel == "k1":
        assert set(entries) == {"erk_ensemble_launch",
                                "erk_ensemble_staged_launch"}
        assert _types(entries["erk_ensemble_launch"]) == k1.argtypes()
        assert _types(entries["erk_ensemble_staged_launch"]) \
            == k1.argtypes(staged=True)
        hand = c_entries((CSRC / k1.SOURCE).read_text())
        assert entries["erk_ensemble_launch"] == hand["erk_ensemble_launch"]
    elif kernel == "k3":
        assert list(entries) == ["rosenbrock_ensemble_launch"]
        assert _types(entries["rosenbrock_ensemble_launch"]) == k3.argtypes()
    else:
        assert list(entries) == ["sde_ensemble_launch"]
        assert _types(entries["sde_ensemble_launch"]) == k4.argtypes()
        hand = c_entries((CSRC / k4.SOURCE).read_text())
        assert entries["sde_ensemble_launch"] == hand["sde_ensemble_launch"]


def _fake_nvcc(tmp_path, body):
    """A stand-in for nvcc: a shell script running `body`."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body + "\n")
    script.chmod(0o755)
    return str(script)


def test_generated_unit_builds_once_keyed_by_its_text(tmp_path, monkeypatch):
    """`build` writes a unit under GEN_DIR and compiles it with -I csrc;
    a second build of the same text (in this process or another) compiles
    nothing; another text is another library."""
    from repro_torch.kernels import build
    calls = tmp_path / "calls"
    # the output is the argument after -o
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {calls}; '
                      'while [ "$1" != "-o" ]; do shift; done; '
                      'echo lib > "$2"; echo "ptxas info : Used 8 registers"')
    monkeypatch.setattr(build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "GEN_DIR", tmp_path / "lib" / "gen")
    unit = units.Unit("probe", "// a generated unit\n")
    logs = build.build([unit, unit])
    assert list(logs) == ["probe"] and "registers" in logs["probe"]
    lib = build.library_path(unit)
    assert lib.parent == tmp_path / "lib" / "gen" and lib.exists()
    assert lib.with_suffix(".cu").read_text() == unit.text
    assert build.build_log(unit) == logs["probe"]
    args = calls.read_text().split()
    assert args[args.index("-I") + 1] == str(build.CSRC)
    assert build.build([units.Unit("probe", unit.text)]) == {}
    assert len(calls.read_text().splitlines()) == 1
    other = units.Unit("probe", "// another unit\n")
    assert build.library_path(other) != lib
    assert list(build.build([other])) == ["probe"]


def test_generated_build_compiles_each_unit_once(tmp_path, monkeypatch):
    """One `build` call compiles every unit whose library is missing, a
    unit given twice once, and a second call compiles nothing."""
    from repro_torch.kernels import build
    calls = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {calls}; '
                      'while [ "$1" != "-o" ]; do shift; done; '
                      'echo lib > "$2"; echo "ptxas info : Used 8 registers"')
    monkeypatch.setattr(build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "GEN_DIR", tmp_path / "lib" / "gen")
    made = [units.Unit(f"u{i}", f"// unit {i}\n") for i in range(5)]
    logs = build.build(made + made[:2])
    assert sorted(logs) == [f"u{i}" for i in range(5)]
    assert all(build.library_path(u).exists() for u in made)
    assert all("Used 8 registers" in build.build_log(u) for u in made)
    assert len(calls.read_text().splitlines()) == 5
    assert build.build(made) == {}


def test_failed_generated_build_raises_with_nvccs_message(tmp_path,
                                                          monkeypatch):
    from repro_torch.kernels import build
    nvcc = _fake_nvcc(tmp_path, 'echo "gen.cu(3): error: identifier Rhs '
                      'is undefined"; exit 2')
    monkeypatch.setattr(build, "nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "GEN_DIR", tmp_path / "lib" / "gen")
    unit = units.Unit("broken", "int main( {\n")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed on broken.*"
                       "identifier Rhs is undefined"):
        build.load_generated(unit)
    assert not build.library_path(unit).exists()
