"""A user ERK tableau's free interpolant through the automated translation
(`trace.trace_interp`, `emit.interp_weights`, `units.erk_unit`) on the
CPU.  Two user tableaus, built from arrays in both packages:

- ``tsit5_copy``: tsit5's coefficients under another name, with a copy of
  `_tsit5_bpoly` as its interpolant.  It compiles to a generated unit
  whose struct takes the hand-written `Tsit5`'s arithmetic flags
  (`units.twin_flags`: the same coefficients, the same interpolant IR), so
  that on the card it is the hand-written entry bit for bit
  (chip_smoke.py `phase_translate`).
- ``dopri5_dense``: dopri5's coefficients with Hairer's free 4th-order
  interpolant (the one of the dopri5 code's CONTD5) written as stage
  weights: every operation rounded on its own, held to its plain version
  bit for bit on the card.

Held here: the traced weights bitwise the Python functions (`evaluate`,
f32 and f64); the emitted weight functions, built with g++ on the host
stub of tests/test_torch_translate_emit.py, bitwise `evaluate`; the
units' text and routes; the port's front door (``backend="cuda"``, its
plain version on the CPU) against the reference's front door on its Pallas
kernel (interpret mode) with the same tableau: per-lane counts identical,
states within 1e-10 (f64, adaptive), and K2's staged run (fixed dt)
bitwise the one launch; the refusals naming item 17."""
import ctypes
import inspect
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tableaus as jtab
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro.core.problem import ODEProblem as JODEProblem
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem, tableau_from_arrays
from repro_torch.core import tableaus as ttab
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.kernels.tsit5 import kernel as k1
from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
from repro_torch.translate import emit, units
from repro_torch.translate.ir import evaluate, same
from repro_torch.translate.trace import trace_interp

from test_torch_translate_emit import STUB
from test_torch_translate_parity import j_lorenz, lorenz_arrays

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
F32, F64 = torch.float32, torch.float64

# a copy of `_tsit5_bpoly`'s source under another name: another function
# object with the same operations
_ns = {"torch": torch}
exec(inspect.getsource(ttab._tsit5_bpoly).replace("_tsit5_bpoly",
                                                   "tsit5_copy_bpoly"), _ns)
tsit5_copy_bpoly = _ns["tsit5_copy_bpoly"]

# Hairer's dopri5 dense output (CONTD5) as stage weights:
# b_i(θ) = b_i θ + (δ_i1 − b_i) θ(1−θ) + (2 b_i − δ_i1 − δ_i7) θ²(1−θ)
#          + d_i θ²(1−θ)²
_D = [-12715105075 / 11282082432, 0.0, 87487479700 / 32700410799,
      -10690763975 / 1880347072, 701980252875 / 199316789632,
      -1453857185 / 822651844, 69997945 / 29380423]
_B = [float(x) for x in ttab.DOPRI5.b]
_C2 = [(1.0 if i == 0 else 0.0) - _B[i] for i in range(7)]
_C3 = [2.0 * _B[i] - (1.0 if i == 0 else 0.0) - (1.0 if i == 6 else 0.0)
       for i in range(7)]


def _dopri5_weights(t, stack):
    s = 1.0 - t
    return stack([_B[i] * t + _C2[i] * (t * s) + _C3[i] * (t * t * s)
                  + _D[i] * (t * t * (s * s)) for i in range(7)])


def dopri5_bpoly(theta):
    return _dopri5_weights(theta, torch.stack)


def j_dopri5_bpoly(theta):
    return _dopri5_weights(theta, jnp.stack)


def _arrays(name):
    t = ttab.TABLEAUS[name]
    return dict(a=t.a, b=t.b, btilde=t.btilde, c=t.c, order=t.order,
                embedded_order=t.embedded_order, fsal=t.fsal)


TSIT5_COPY = tableau_from_arrays("tsit5_copy", **_arrays("tsit5"),
                                 interp_bpoly=tsit5_copy_bpoly)
DOPRI5_DENSE = tableau_from_arrays("dopri5_dense", **_arrays("dopri5"),
                                   interp_bpoly=dopri5_bpoly)
USER = {"tsit5_copy": TSIT5_COPY, "dopri5_dense": DOPRI5_DENSE}
J_BPOLY = {"tsit5_copy": jtab.TSIT5.interp_bpoly,
           "dopri5_dense": j_dopri5_bpoly}
PY_BPOLY = {"tsit5_copy": tsit5_copy_bpoly, "dopri5_dense": dopri5_bpoly}


def _thetas(dtype, k=257):
    rng = np.random.default_rng(3)
    th = np.concatenate([np.linspace(0.0, 1.0, k), rng.uniform(0, 1, k)])
    return torch.tensor(th, dtype=dtype)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(USER))
def test_traced_weights_bitwise_the_python_function(name, dtype):
    tab = USER[name]
    tr = trace_interp(tab.interp_bpoly, tab.stages)
    assert tr.shape == (7,) and (tr.graph.n, tr.graph.m) == (0, 0)
    th = _thetas(dtype)
    empty = torch.zeros((0,) + th.shape, dtype=dtype)
    got = evaluate(tr, empty, empty, th)
    assert torch.equal(got, PY_BPOLY[name](th))
    # the weights meet b at theta = 1 and 0 at theta = 0
    np.testing.assert_allclose(
        PY_BPOLY[name](torch.tensor(1.0, dtype=F64)).numpy(), tab.b,
        atol=1e-14)


def test_twin_flags_and_units():
    copy = trace_interp(tsit5_copy_bpoly, 7)
    assert same(copy, trace_interp(ttab.TSIT5.interp_bpoly, 7))
    assert not same(copy, trace_interp(dopri5_bpoly, 7))
    assert units.twin_flags(TSIT5_COPY, copy) == dict(rounded=False,
                                                      stream_sums=False)
    dense = trace_interp(dopri5_bpoly, 7)
    assert units.twin_flags(DOPRI5_DENSE, dense) == dict(rounded=True,
                                                         stream_sums=True)
    # tsit5's coefficients without its interpolant are not its twin
    assert units.twin_flags(TSIT5_COPY, None) == dict(rounded=True,
                                                      stream_sums=True)
    # the flags' table is the hand-written structs' own
    assert set(units.ERK_TABLEAU_FLAGS) == set(units.ERK_TABLEAU_STRUCTS)
    for name, (source, struct) in units.ERK_TABLEAU_STRUCTS.items():
        text = units.hand_struct(source, struct)
        for k, v in units.ERK_TABLEAU_FLAGS[name].items():
            assert f" {k} = {'true' if v else 'false'};" in text or \
                f" {k} = {'true' if v else 'false'}," in text, (name, k)
    for name, tab in USER.items():
        assert not k1._compiled(tab)
        r = k1.route(tdp.lorenz_rhs, tab, n=3, m=3)
        assert isinstance(r.target, units.Unit), name
        text = r.target.text
        assert "static constexpr bool free_interp = true;" in text
        assert "static void bpoly(T t, T (&w)[7])" in text
        assert "erk_ensemble_staged_launch" in text
        assert "struct Lorenz" not in text     # the hand-written functor
    # the hand-written tsit5 keeps its source, a tsit5 named alike with
    # another interpolant does not
    assert k1.route(tdp.lorenz_rhs, ttab.TSIT5, n=3, m=3).target == k1.SOURCE
    assert not k1._compiled(ttab.TSIT5._replace(interp_bpoly=dopri5_bpoly))


@pytest.fixture(scope="module")
def weights_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of the weight functions")
    d = tmp_path_factory.mktemp("interp")
    (d / "cuda_runtime.h").write_text(STUB)
    parts = ['#include "arith.cuh"', '#include "generated.cuh"', ""]
    for name, tab in USER.items():
        parts.append(f"struct W_{name} {{\n"
                     + emit.interp_weights(trace_interp(tab.interp_bpoly, 7))
                     + "};")
        for T in ("float", "double"):
            parts.append(
                f'extern "C" void w_{name}_{T}(const {T}* th, int k, {T}* w)'
                f" {{\n  for (int i = 0; i < k; ++i) {{\n    {T} v[7];\n"
                f"    W_{name}::bpoly<repro_arith::Rounded>(th[i], v);\n"
                "    for (int q = 0; q < 7; ++q) w[q * k + i] = v[q];\n"
                "  }\n}")
    src = d / "weights.cpp"
    src.write_text("\n".join(parts) + "\n")
    lib = d / "weights.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(d), "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(USER))
def test_emitted_weights_bitwise_evaluate(weights_lib, name, dtype):
    tr = trace_interp(USER[name].interp_bpoly, 7)
    th = _thetas(dtype)
    T = "float" if dtype == F32 else "double"
    out = torch.empty((7, th.numel()), dtype=dtype)
    getattr(weights_lib, f"w_{name}_{T}")(
        ctypes.c_void_p(th.data_ptr()), ctypes.c_int(th.numel()),
        ctypes.c_void_p(out.data_ptr()))
    empty = torch.zeros((0,) + th.shape, dtype=dtype)
    assert torch.equal(out, evaluate(tr, empty, empty, th))


N = 8
SAVEAT = np.linspace(0.1, 0.5, 5)
KW = dict(t0=0.0, tf=0.5, dt0=1e-3, rtol=1e-8, atol=1e-8, adaptive=True)


def _ref_tableau(name):
    t = ttab.TABLEAUS["tsit5" if name == "tsit5_copy" else "dopri5"]
    return jtab.Tableau(name, t.a, t.b, t.btilde, t.c, t.order,
                        t.embedded_order, t.fsal, J_BPOLY[name])


@pytest.mark.parametrize("name", sorted(USER))
def test_front_door_matches_reference(name):
    u0s, ps = lorenz_arrays()
    jp = JODEProblem(j_lorenz, jnp.asarray(u0s[0]), jnp.asarray(ps[0]),
                     (0.0, 0.5), name="lorenz")
    want = jsolve(JEnsembleProblem(jp, N, u0s=jnp.asarray(u0s),
                                   ps=jnp.asarray(ps)),
                  alg=_ref_tableau(name), ensemble="kernel",
                  backend="pallas", saveat=jnp.asarray(SAVEAT), **KW)
    ep = ensemble_problem(tdp.lorenz_problem(), u0s, ps)
    got = tsolve(ep, alg=USER[name], ensemble="kernel", backend="cuda",
                 device="cpu", saveat=SAVEAT, **KW)
    assert int(got.status) == 0
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    for k in ("us", "u_final"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), (name, k)
    # K2: the staged driver through the same unit's staged entry at fixed
    # dt on a save grid of the step grid, bitwise one launch (the plain
    # version on the CPU)
    u, p = (torch.tensor(x) for x in (u0s, ps))
    kw = dict(t0=0.0, tf=0.5, dt0=2.0 ** -10, rtol=1e-8, atol=1e-8,
              adaptive=False, saveat=torch.arange(1, 9, dtype=F64) / 16)
    three = solve_ensemble_cuda(ep.prob, u, p, USER[name], save_chunks=3,
                                **kw)
    one = solve_ensemble_cuda(ep.prob, u, p, USER[name], save_chunks=1, **kw)
    for k in ("us", "u_final", "naccept", "nreject"):
        assert torch.equal(getattr(three, k), getattr(one, k)), k


def test_untranslatable_interpolants_refuse_naming_item_17():
    def branchy(theta):
        return torch.stack([theta if theta > 0.5 else 1.0 - theta] * 7)

    def scalar(theta):
        return theta

    def wrong_length(theta):
        return torch.stack([theta, 1.0 - theta])

    for fn, what in ((branchy, "bool"), (scalar, "returned"),
                     (wrong_length, "returned")):
        tab = TSIT5_COPY._replace(name="bad", interp_bpoly=fn)
        with pytest.raises(NotImplementedError, match=f"{what}.*item 17"):
            k1.route(tdp.lorenz_rhs, tab, n=3, m=3)
