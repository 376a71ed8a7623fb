"""Dataset lookups through the automated translation on the CPU
(`repro_torch.translate`: the dataset proxy of `trace`, the ``lookup`` and
``lookup_jvp`` nodes, their emission as `interp.cuh`'s lookups and
tangents, the data forms of the units and the wrappers' `route`).

- A traced lookup evaluates bitwise to the Python function, 1-D and 2-D,
  every mode, one table or several.
- The derived tangents of a lookup in every mode, along x, y or both, are
  `torch.func.jvp` of `core.interp` bit for bit in gather and cubic
  (onehot's contraction sums in PyTorch's matmul: within 2 ulps of the
  largest value), half the slope on a table's bounds included, and
  `jax.jvp` of `repro.core.interp` within 1e-13 of the largest value.
- The emitted data functors (K1's, K3's with their Jacobian and ∂f/∂t,
  K4's), compiled as host code with g++ against the stub of
  tests/test_torch_translate_emit.py (with `__ldg` a plain read), match
  `evaluate` within that file's bars.
- Every wrapper routes a dataset its hand-written data functor does not
  read, or a data form its source does not compile, to a generated unit,
  and a compiled one to its source; every new C entry takes its wrapper's
  `argtypes()`.
- The forced oscillator's table translated, through the port's front door
  on tsit5 at fixed dt, against the reference's front door (Pallas kernel,
  interpret mode) within 1e-12; the rate-table GBM with a terminal barrier
  on a shared noise table within 1e-12, event times within 1e-12.
"""
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.de_problems import forced_oscillator_problem as r_osc
from repro.core import interp as R
from repro.core import solve_ensemble_local as rsolve
from repro.core.events import Event as REvent
from repro.core.problem import EnsembleProblem as REP
from repro.core.problem import SDEProblem as RSDE
from repro_torch import convert
from repro_torch.configs import de_problems as tdp
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.events import Event
from repro_torch.core.interp import (UniformTable1D, UniformTable2D,
                                     interp1d, interp2d)
from repro_torch.core.problem import ODEProblem, SDEProblem
from repro_torch.core.tableaus import get_rosenbrock_tableau, get_tableau
from repro_torch.kernels.em import adaptive as k5
from repro_torch.kernels.em import kernel as k4
from repro_torch.kernels.rosenbrock import kernel as k3
from repro_torch.kernels.tsit5 import kernel as k1
from repro_torch.translate import derive, emit, units
from repro_torch.translate.ir import as_function, evaluate
from repro_torch.translate.trace import trace, trace_pair

from test_torch_translate_emit import STUB, _check, _ptr, _scalar, _types

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
F32, F64 = torch.float32, torch.float64
MODES = ("gather", "onehot", "cubic")


def tables(dtype=F64):
    """A 1-D and a 2-D table: K = 9 knots on [0, 2]; 6 x 5 knots on
    [-1, 1.5] x [0, 2]."""
    xs = np.linspace(0.0, 2.0, 9)
    a = UniformTable1D(torch.tensor(np.sin(2.0 * xs) + 0.3 * xs,
                                    dtype=dtype), 0.0, float(xs[1] - xs[0]))
    gx, gy = np.linspace(-1.0, 1.5, 6), np.linspace(0.0, 2.0, 5)
    v = np.cos(gx[:, None]) * np.exp(-0.5 * gy[None, :]) + 0.1 * gx[:, None]
    b = UniformTable2D(torch.tensor(v, dtype=dtype), -1.0,
                       float(gx[1] - gx[0]), 0.0, float(gy[1] - gy[0]))
    return {"drive": a, "field": b}


def r_tables():
    """The same tables in the reference's types."""
    t = tables()
    a, b = t["drive"], t["field"]
    return {"drive": R.UniformTable1D(jnp.asarray(a.values.numpy()), a.x0,
                                      a.dx),
            "field": R.UniformTable2D(jnp.asarray(b.values.numpy()), b.x0,
                                      b.dx, b.y0, b.dy)}


def make_rhs(mode):
    """A two-state RHS that reads both tables in `mode`: the 1-D one at t
    and at u[1], the 2-D one at (u[0], t)."""
    def rhs(u, p, t, data):
        f = interp1d(data["drive"], t, mode)
        g = interp2d(data["field"], u[0], t * 0.5, mode)
        return torch.stack([u[1] + g, -p[0] * u[0] - p[1] * u[1] + f
                            + interp1d(data["drive"], u[1], mode) * 0.25])
    rhs.__name__ = rhs.__qualname__ = f"two_tables_{mode}"
    return rhs


RHS = {mode: make_rhs(mode) for mode in MODES}


def _points(dtype, B=48, seed=0):
    """Lanes inside, outside and on the grids' bounds."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.5, 2.5, (2, B))
    t = rng.uniform(-0.5, 4.5, B)
    u[0, :4] = [-1.0, 1.5, -1.5, 0.0]          # 2-D x bounds, outside
    t[4:8] = [0.0, 2.0, 0.0, 4.0]              # 1-D bound, 2-D y bounds
    u[1, 8:10] = [0.0, 2.0]
    p = rng.uniform(0.5, 3.0, (2, B))
    return (torch.tensor(u, dtype=dtype), torch.tensor(p, dtype=dtype),
            torch.tensor(t, dtype=dtype))


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_traced_lookups_evaluate_bitwise_to_the_function(mode, dtype):
    data = tables(dtype)
    tr = trace(RHS[mode], 2, 2, outputs=(2,), data=data)
    assert tr.graph.data == (1, 2)
    ops = [nd.op for nd in tr.graph.nodes]
    assert ops.count("lookup") == 3
    u, p, t = _points(dtype)
    assert torch.equal(evaluate(tr, u, p, t, data), RHS[mode](u, p, t, data))
    # the plain version takes the dataset as a fourth argument
    assert torch.equal(as_function(tr)(u, p, t, data),
                       RHS[mode](u, p, t, data))
    # one trace a dataset structure, whatever the values
    other = {k: type(v)(v.values * 2, *list(vars(v).values())[1:])
             for k, v in data.items()}
    assert trace(RHS[mode], 2, 2, outputs=(2,), data=other) is tr


def test_a_dataset_is_read_only_through_the_lookups():
    data = tables()
    with pytest.raises(NotImplementedError, match="item 17"):
        trace(lambda u, p, t, d: torch.stack([u[0] + d["drive"].values[2]]),
              1, 1, outputs=(1,), data=data)
    with pytest.raises(NotImplementedError, match="item 17"):
        trace(lambda u, p, t, d: torch.stack([
            u[0] * torch.sum(d["drive"].values)]), 1, 1, outputs=(1,),
            data=data)
    with pytest.raises(NotImplementedError, match="UniformTable1D"):
        trace(lambda u, p, t, d: u, 1, 1, outputs=(1,),
              data={"raw": torch.ones(3)})


def _jvp(fn, primals, tangents):
    return torch.func.jvp(fn, primals, tangents)[1]


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_lookup_tangents_are_torch_func_jvp(mode, dtype):
    """∂f/∂t (the 1-D table along t, the 2-D one along y = t / 2) and the
    Jacobian (the 1-D table along u[1], the 2-D one along x = u[0]) of the
    traced RHS against torch.func of the Python function."""
    data = tables(dtype)
    f = RHS[mode]
    tr = trace(f, 2, 2, outputs=(2,), data=data)
    u, p, t = _points(dtype, seed=1)
    got_t = evaluate(derive.time_derivative(tr), u, p, t, data)
    want_t = _jvp(lambda tt: f(u, p, tt, data), (t,), (torch.ones_like(t),))
    got_j = evaluate(derive.jacobian(tr), u, p, t, data)
    want_j = torch.stack([_jvp(lambda uu: f(uu, p, t, data), (u,),
                               (torch.eye(2, dtype=dtype)[j][:, None]
                                .expand_as(u).contiguous(),))
                          for j in range(2)], 1)
    for got, want in ((got_t, want_t), (got_j, want_j)):
        if mode == "onehot":
            scale = float(want.abs().max()) * torch.finfo(dtype).eps
            assert float((got - want).abs().max()) <= 2 * scale
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_lookup_tangents_match_the_reference_jvp(mode):
    """The derived tangents of each table along each query (x, y and both
    together) against jax.jvp of repro.core.interp, on the bounds too."""
    data, rdata = tables(), r_tables()
    u, p, t = _points(F64, seed=2)
    x, y = u[0], t * 0.5

    def one(q, p_, t_, d):
        return torch.stack([interp1d(d["drive"], q[0], mode)])

    def two(q, p_, t_, d):
        return torch.stack([interp2d(d["field"], q[0], q[1], mode)])

    q = torch.stack([x, y])
    ones = np.ones_like(x.numpy())
    for fn, ref, seeds in (
            (one, lambda xx: R.interp1d(rdata["drive"], xx, mode),
             [(ones,)]),
            (two, lambda xx, yy: R.interp2d(rdata["field"], xx, yy, mode),
             [(ones, 0 * ones), (0 * ones, ones), (ones, 0.5 * ones)])):
        n = len(seeds[0])
        tr = trace(fn, n, 0, outputs=(1,), data=data)
        for seed in seeds:
            along = trace(lambda qq, pp, tt, d, s=seed: torch.stack([
                torch.full_like(qq[0], float(s[i][0])) for i in range(n)]),
                n, 0, outputs=(n,), data=data, graph=tr.graph)
            got = evaluate(derive.jvp(tr, along), q[:n],
                           torch.zeros(0, x.shape[0], dtype=F64), t, data)
            want = np.asarray(jax.jvp(
                ref, tuple(jnp.asarray(v.numpy()) for v in q[:n]),
                tuple(jnp.asarray(s) for s in seed))[1])
            scale = max(float(np.abs(want).max()), 1e-300)
            np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                                       atol=1e-13 * scale)


def test_tangent_is_half_the_slope_on_the_bounds():
    data = tables()
    tab = data["drive"]
    tr = trace(lambda u, p, t, d: torch.stack([interp1d(d["drive"], t)]), 1,
               0, outputs=(1,), data=data)
    dT = derive.time_derivative(tr)
    t = torch.tensor([0.0, 2.0, 1e-3, 2.5], dtype=F64)
    got = evaluate(dT, torch.zeros(1, 4, dtype=F64),
                   torch.zeros(0, 4, dtype=F64), t, data)[0]
    v = tab.values
    slope0 = float((v[1] - v[0]) / tab.dx)
    slope1 = float((v[-1] - v[-2]) / tab.dx)
    np.testing.assert_allclose(got.numpy(), [0.5 * slope0, 0.5 * slope1,
                                             slope0, 0.0], rtol=1e-12)


# ---------------------------------------------------------------------------
# the emitted data functors on the host
# ---------------------------------------------------------------------------

DATA_STUB = STUB + """
using std::floor;
template <class T> inline T __ldg(const T* p) { return *p; }
"""


def _k4_rate():
    data = tdp.gbm_rate_problem().data
    f = lambda u, p, t, d: tdp.gbm_rate_drift(u, p, t, d)  # noqa: E731
    g = lambda u, p, t, d: tdp.gbm_rate_diffusion(u, p, t, d)  # noqa: E731
    tf, tg = trace_pair(f, g, 1, 1, f_outputs=(1,), g_outputs=(1,),
                        data=data)
    return tf, tg, derive.jvp(tg, tg), data


@functools.lru_cache(maxsize=None)
def _library(tmp: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of the emitted functors")
    d = Path(tmp)
    (d / "cuda_runtime.h").write_text(DATA_STUB)
    parts = ['#include "arith.cuh"', '#include "generated.cuh"',
             '#include "interp.cuh"', ""]
    tables_args = ("int n_data, const void* const* vals, const int* shape, "
                   "const double* grid")
    for mode in MODES:
        tr = trace(RHS[mode], 2, 2, outputs=(2,), data=tables())
        J, dT = derive.jacobian(tr), derive.time_derivative(tr)
        parts.append(emit.erk_functor(f"K1_{mode}", tr))
        parts.append(emit.rosenbrock_functor(f"K3_{mode}", tr, J, dT))
        for T in ("float", "double"):
            parts.append(
                f'extern "C" void k1_{mode}_{T}({tables_args}, const {T}* u, '
                f"const {T}* p, {T} t, {T}* du) {{\n"
                "  repro_data::Tables tb;\n"
                "  repro_data::make_tables(n_data, vals, shape, grid, tb);\n"
                f"  const K1_{mode} f(tb);\n"
                "  f.eval<repro_arith::Rounded>(u, p, t, du); }")
            parts.append(
                f'extern "C" void k3_{mode}_{T}({tables_args}, const {T}* u, '
                f"const {T}* p, {T} t, {T}* du, {T}* J, {T}* dd) {{\n"
                "  repro_data::Tables tb;\n"
                "  repro_data::make_tables(n_data, vals, shape, grid, tb);\n"
                f"  const K3_{mode} f(tb);\n"
                f"  {T} du2[2];\n"
                f"  f.jac(u, p, t, reinterpret_cast<{T}(*)[2]>(J));\n"
                "  f.eval_dfdt(u, p, t, du, dd);\n"
                "  f.eval(u, p, t, du2);\n"
                "  if (du2[0] != du[0] || du2[1] != du[1]) du[0] = 0.0 / 0.0; }")
    tf, tg, gdg, _ = _k4_rate()
    parts.append(emit.sde_functor("K4_rate", tf, tg, "diagonal", gdg))
    for T in ("float", "double"):
        parts.append(
            f'extern "C" void k4_rate_{T}({tables_args}, const {T}* u, '
            f"const {T}* p, {T} t, {T}* du, {T}* g, {T}* gd) {{\n"
            "  repro_data::Tables tb;\n"
            "  repro_data::make_tables(n_data, vals, shape, grid, tb);\n"
            "  const K4_rate f(tb);\n  using A = repro_arith::Rounded;\n"
            "  f.drift<A>(u, p, t, du); f.diffusion<A>(u, p, t, g);\n"
            "  f.gdg<A>(u, p, t, gd); }")
    src = d / "data.cpp"
    src.write_text("\n".join(parts) + "\n")
    lib = d / "data.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(d), "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _library(str(tmp_path_factory.mktemp("data")))


def _table_args(data):
    """`kernels.interp.data_launch_args`' four values for CPU tensors."""
    from repro_torch.kernels.interp import data_launch_args
    leaf = next(iter(data.values())).values
    return data_launch_args(data, None, "host", leaf)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_emitted_data_functors_match_evaluate(lib, mode, dtype):
    data = tables(dtype)
    tr = trace(RHS[mode], 2, 2, outputs=(2,), data=data)
    J, dT = derive.jacobian(tr), derive.time_derivative(tr)
    T = "float" if dtype == F32 else "double"
    targs = _table_args(data)
    u, p, t = _points(dtype, seed=3)
    B = t.shape[0]
    du1, du3 = torch.empty(B, 2, dtype=dtype), torch.empty(B, 2, dtype=dtype)
    Jg, dd = torch.empty(B, 2, 2, dtype=dtype), torch.empty(B, 2,
                                                            dtype=dtype)
    for b in range(B):
        ub, pb = u[:, b].contiguous(), p[:, b].contiguous()
        getattr(lib, f"k1_{mode}_{T}")(*targs, _ptr(ub), _ptr(pb),
                                       _scalar(T, t[b]), _ptr(du1[b]))
        getattr(lib, f"k3_{mode}_{T}")(*targs, _ptr(ub), _ptr(pb),
                                       _scalar(T, t[b]), _ptr(du3[b]),
                                       _ptr(Jg[b]), _ptr(dd[b]))
    g = tr.graph
    want = evaluate(tr, u, p, t, data)
    _check(g, tr.outputs, du1.T, want, dtype, "K1 f")
    _check(g, tr.outputs, du3.T, want, dtype, "K3 f")
    _check(g, J.outputs, Jg.reshape(B, 4).T,
           evaluate(J, u, p, t, data).reshape(4, B), dtype, "K3 jac")
    _check(g, dT.outputs, dd.T, evaluate(dT, u, p, t, data), dtype,
           "K3 dfdt")


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_emitted_sde_data_functor_matches_evaluate(lib, dtype):
    tf, tg, gdg, data = _k4_rate()
    data = {k: UniformTable1D(v.values.to(dtype), v.x0, v.dx)
            for k, v in data.items()}
    T = "float" if dtype == F32 else "double"
    targs = _table_args(data)
    rng = np.random.default_rng(4)
    B = 32
    u = torch.tensor(rng.uniform(0.5, 1.5, (1, B)), dtype=dtype)
    p = torch.tensor(rng.uniform(0.1, 0.3, (1, B)), dtype=dtype)
    t = torch.tensor(rng.uniform(-0.5, 2.5, B), dtype=dtype)
    out = torch.empty(3, B, dtype=dtype)
    for b in range(B):
        o = torch.empty(3, dtype=dtype)
        getattr(lib, f"k4_rate_{T}")(*targs, _ptr(u[:, b].contiguous()),
                                     _ptr(p[:, b].contiguous()),
                                     _scalar(T, t[b]), _ptr(o),
                                     _ptr(o[1:]), _ptr(o[2:]))
        out[:, b] = o
    G = tf.graph
    _check(G, tf.outputs, out[:1], evaluate(tf, u, p, t, data), dtype, "f")
    _check(G, tg.outputs, out[1:2], evaluate(tg, u, p, t, data), dtype, "g")
    _check(G, gdg.outputs, out[2:], evaluate(gdg, u, p, t, data), dtype,
           "gdg")


# ---------------------------------------------------------------------------
# routes and C entries
# ---------------------------------------------------------------------------

def unregistered(fn):
    def wrapper(*args):
        return fn(*args)
    wrapper.__name__ = wrapper.__qualname__ = f"{fn.__name__}_plain"
    return wrapper


def test_routes_send_each_data_form_where_it_compiles():
    osc = tdp.forced_oscillator_problem()
    f, data = osc.f, osc.data
    tsit5, vern7 = get_tableau("tsit5"), get_tableau("vern7")
    lvl = tdp.osc_level_event()
    # K1: the data functors on tsit5 and dopri5, and the one data-and-event
    # pair, in the source
    assert k1.route(f, tsit5, None, data, n=2, m=2).target == k1.SOURCE
    assert k1.route(f, tsit5, lvl, data, n=2, m=2).target == k1.SOURCE
    two = tables()
    for fn, tab, ev, d in ((f, vern7, None, data), (f, tsit5, lvl._replace(
            direction=-1, condition=unregistered(lvl.condition)), data),
            (f, tsit5, tdp.bouncing_ball_event(), data),
            (RHS["cubic"], tsit5, None, two),
            (unregistered(f), tsit5, None, data)):
        unit = k1.route(fn, tab, ev, d, n=2, m=2).target
        assert isinstance(unit, units.Unit)
        assert "repro_data::Tables>" in unit.text
    hand = k1.route(f, vern7, None, data, n=2, m=2).target
    assert "Vern7, repro_erk::ForcedOsc<repro_data::kGather>" in hand.text
    # a registered data functor given a dataset it does not read: traced
    other = dict(data, extra=data["force"])
    traced = k1.route(f, tsit5, None, other, n=2, m=2).target
    assert "struct Rhs {" in traced.text and "leaf[2]" in traced.text
    # K3: the data functor in f64 without an event in the source; in f32
    # traced, with an event its struct copied
    r23 = get_rosenbrock_tableau("rosenbrock23")
    assert k3.route(f, None, r23, None, data, n=2, m=2)[0] is None
    u32 = k3.route(f, None, r23, None, data, n=2, m=2, dtype=F32)[0]
    assert "struct Rhs {" in u32.text and "interp1d_tangent" in u32.text
    uev = k3.route(f, None, r23, lvl, data, n=2, m=2)[0]
    assert "copied from rosenbrock_ensemble.cu" in uev.text
    assert "rosenbrock_ensemble_data_event_launch" in uev.text
    # K4 and K5: the rate-table GBM without an event in the sources; with
    # one in units
    rate = tdp.gbm_rate_problem()
    kw = dict(noise="diagonal", m_noise=1, n=1, k=1, dtype=F64,
              data=rate.data)
    bar = Event(condition=unregistered(lambda u, p, t: u[0] - 1.1),
                terminal=True, direction=1)
    assert k4.sde_route(rate.f, rate.g, "em", **kw).unit is None
    u4 = k4.sde_route(rate.f, rate.g, "em", event=bar, **kw).unit
    assert "repro_sde::GbmRate, St, Ev, repro_data::Tables>" in u4.text
    args = (rate.f, rate.g, "em", "diagonal", 1, "embedded")
    akw = dict(n=1, k=1, data=rate.data)
    assert k5._device_functor(*args, **akw)[2] is None
    u5 = k5._device_functor(*args, **akw, event=bar)[2]
    assert "repro_sde::GbmRate, St, true, Ev, repro_data::Tables>" \
        in u5.text
    traced5 = k5._device_functor(unregistered(rate.f), rate.g, "milstein",
                                 "diagonal", 1, "embedded", **akw)[2]
    assert "has_gdg = true, has_ddb = true" in traced5.text


def _entries(text):
    from test_torch_translate_emit import c_entries
    return c_entries(text)


def _c_types(args):
    return _types([a.replace("const void* const*", "const void*")
                   for a in args])


def test_data_c_entries_take_what_the_wrappers_pass():
    osc = tdp.forced_oscillator_problem()
    f, data = osc.f, osc.data
    lvl = tdp.osc_level_event()
    e1 = _entries(k1.route(f, get_tableau("rk4"), None, data, n=2,
                           m=2).target.text)
    assert set(e1) == {"erk_ensemble_data_launch",
                       "erk_ensemble_data_staged_launch"}
    assert _c_types(e1["erk_ensemble_data_launch"]) == k1.argtypes(data=True)
    assert _c_types(e1["erk_ensemble_data_staged_launch"]) \
        == k1.argtypes(data=True, staged=True)
    r23 = get_rosenbrock_tableau("rosenbrock23")
    for ev, dtype in ((None, F32), (lvl, F64)):
        e3 = _entries(k3.route(f, None, r23, ev, data, n=2, m=2,
                               dtype=dtype)[0].text)
        name = "rosenbrock_ensemble_data" + ("_event" if ev else "") \
            + "_launch"
        assert list(e3) == [name]
        assert _c_types(e3[name]) == k3.argtypes(event=ev is not None,
                                                 data=True)
    rate = tdp.gbm_rate_problem()
    bar = Event(condition=unregistered(lambda u, p, t: u[0] - 1.1),
                terminal=True, direction=1)
    for ev in (None, bar):
        e4 = _entries(k4.sde_route(
            unregistered(rate.f), rate.g, "heun_strat", noise="diagonal",
            m_noise=1, n=1, k=1, dtype=F64, event=ev, data=rate.data)
            .unit.text)
        name = "sde_ensemble_data" + ("_event" if ev else "") + "_launch"
        assert _c_types(e4[name]) == k4.argtypes(event=ev is not None,
                                                 data=True)
        e5 = _entries(k5._device_functor(
            rate.f, rate.g, "platen_w2", "diagonal", 1, "doubling", n=1,
            k=1, event=ev or bar, data=rate.data)[2].text)
        assert _c_types(e5["sde_adaptive_data_event_launch"]) \
            == k5.argtypes(event=True, data=True)
    hand = _entries((CSRC / k3.SOURCE).read_text())
    assert _c_types(hand["rosenbrock_ensemble_data_launch"]) \
        == k3.argtypes(data=True)


# ---------------------------------------------------------------------------
# the front door against the reference's Pallas kernel
# ---------------------------------------------------------------------------

N = 4


def _osc_inputs():
    rp = r_osc()
    u0s = np.stack([np.asarray(rp.u0)] * N) * np.linspace(0.5, 1.5, N)[:,
                                                                       None]
    return rp, u0s, np.stack([np.asarray(rp.p)] * N)


def test_translated_oscillator_table_matches_reference_kernel():
    """tsit5 at fixed dt on the forced oscillator, its RHS traced with the
    table: states within 1e-12."""
    rp, u0s, ps = _osc_inputs()
    kw = dict(alg="tsit5", adaptive=False, dt0=0.01, t0=0.0, tf=2.0)
    sv = np.linspace(0.5, 2.0, 4)
    want = rsolve(REP(rp, N, u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
                  ensemble="kernel", backend="pallas", lane_tile=N,
                  saveat=jnp.asarray(sv), **kw)
    tp = tdp.forced_oscillator_problem()
    traced = trace(unregistered(tp.f), 2, 2, outputs=(2,), data=tp.data)
    prob = ODEProblem(as_function(traced), tp.u0, tp.p, tp.tspan,
                      data=tp.data)
    got = tsolve(convert.ensemble_problem(prob, u0s, ps), ensemble="kernel",
                 backend="cuda", device="cpu", saveat=list(sv), **kw)
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    for g, w in ((got.us, want.us), (got.u_final, want.u_final)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_rate_gbm_with_a_barrier_matches_reference_kernel():
    """em at fixed dt on the rate-table GBM with a terminal up-and-out
    barrier at 1.05, both packages on one noise table: states and event
    times within 1e-12, every lane's active steps identical."""
    ts = np.linspace(0.0, 2.0, 33)
    rate = R.UniformTable1D(jnp.asarray(0.02 + 0.01 * np.sin(ts)), 0.0,
                            float(ts[1] - ts[0]))
    rp = RSDE(f=lambda u, p, t, d: R.interp1d(d["rate"], t) * u,
              g=lambda u, p, t, d: p[0] * u, u0=jnp.ones(1),
              p=jnp.asarray([0.2]), tspan=(0.0, 1.0), noise="diagonal",
              data={"rate": rate})
    u0s, ps = np.ones((N, 1)), np.full((N, 1), 0.2)
    # a seed on which two of the four paths reach the barrier
    z = np.random.default_rng(5).standard_normal((200, 1, N))
    kw = dict(alg="em", dt0=2.5e-3, n_steps=200, save_every=100, t0=0.0)
    jev = REvent(condition=lambda u, p, t: u[0] - 1.05, terminal=True,
                 direction=1)
    want = rsolve(REP(rp, N, u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
                  ensemble="kernel", backend="pallas", lane_tile=N,
                  noise_table=jnp.asarray(z), event=jev, **kw)
    tp = tdp.gbm_rate_problem()
    tf, tg = trace_pair(unregistered(tp.f), unregistered(tp.g), 1, 1,
                        f_outputs=(1,), g_outputs=(1,), data=tp.data)
    prob = SDEProblem(as_function(tf), as_function(tg), tp.u0, tp.p,
                      tp.tspan, noise="diagonal", data=tp.data)
    ev = Event(condition=lambda u, p, t: u[0] - 1.05, terminal=True,
               direction=1)
    from repro_torch.translate.trace import trace_event
    cond, _ = trace_event(ev.condition, None, 1, 1)
    got = tsolve(convert.ensemble_problem(prob, u0s, ps), ensemble="kernel",
                 backend="cuda", device="cpu",
                 noise_table=convert.noise_table(z),
                 event=ev._replace(condition=as_function(cond)), **kw)
    assert 0 < int((got.t_final < 0.5).sum()) < N   # some lanes hit
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    for g, w in ((got.us, want.us), (got.u_final, want.u_final),
                 (got.t_final, want.t_final)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
