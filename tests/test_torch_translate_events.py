"""Event conditions and affects through the automated translation on the
CPU (`repro_torch.translate`: `trace_event`, `emit.event_functor`, the
units' event forms, the wrappers' `route`): a traced condition and affect
evaluate bitwise to the Python callbacks; the emitted event functors,
compiled as host code with g++ against the stub of
tests/test_torch_translate_emit.py, match `evaluate` within that file's
bars; every wrapper routes an event its hand-written source does not
compile to a generated unit, and a compiled one to its source; every new
C entry takes its wrapper's `argtypes()`; and the forms the card now runs
go through the port's front door, their callbacks replaced by
``as_function(trace(...))``, against the reference's front door
(``ensemble="kernel"``, ``backend="pallas"``, interpret mode).

Bars (ROADMAP): counts identical; an event within one bisection quantum
of the compiled reference (2^-30 of the widest step: the bouncing ball's
impacts, and so its states within the impact speed times that quantum,
2.6e-8; op by op the port's ball is held at 1e-10 in
tests/test_torch_event_parity.py); Van der Pol's terminal event alike,
and in f32 as its test says.
"""
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import solve_ensemble_local as jsolve
from repro.core.events import Event as JEvent
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem
from repro_torch.core import solve_ensemble_local as tsolve
from repro_torch.core.events import Event
from repro_torch.core.problem import ODEProblem
from repro_torch.core.tableaus import get_rosenbrock_tableau, get_tableau
from repro_torch.kernels.em import adaptive as k5
from repro_torch.kernels.em import kernel as k4
from repro_torch.kernels.rosenbrock import kernel as k3
from repro_torch.kernels.tsit5 import kernel as k1
from repro_torch.translate import emit, units
from repro_torch.translate.ir import as_function, evaluate
from repro_torch.translate.trace import trace, trace_event

from test_torch_translate_emit import STUB, _check, _ptr, _scalar, _types

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
F32, F64 = torch.float32, torch.float64


def user_condition(u, p, t):
    return u[0] * u[1] - p[0] + 0.25 * t


def user_affect(u, p, t):
    return torch.stack([u[0] * 0.5, -u[1] + p[0]])


def where_condition(u, p, t):
    return torch.where(u[0] > 0.5, u[0] - 1.0, u[1] / 3.0)


def unregistered(fn):
    """`fn` without its device registration."""
    def wrapper(*args):
        return fn(*args)
    wrapper.__name__ = wrapper.__qualname__ = f"{fn.__name__}_plain"
    return wrapper


# (condition, affect, n, m)
EVENTS = {"ball": (tdp.bouncing_ball_condition, tdp.bouncing_ball_affect,
                   2, 2),
          "decay_half": (tdp.half_condition, None, 1, 1),
          "rober_half": (tdp.rober_half_condition, None, 3, 3),
          "gbm_barrier": (tdp.gbm_barrier_condition, None, 3, 2),
          "ramp_sawtooth": (tdp.ramp_sawtooth_condition,
                            tdp.ramp_sawtooth_affect, 1, 2),
          "osc_level": (tdp.osc_level_condition, None, 2, 2),
          "user": (user_condition, user_affect, 2, 2),
          "where": (where_condition, None, 2, 1)}


def _points(n, m, dtype, B=32, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(-1.0, 2.0, (n, B)), dtype=dtype),
            torch.tensor(rng.uniform(0.1, 3.0, (m, B)), dtype=dtype),
            torch.tensor(rng.uniform(0.0, 2.0, B), dtype=dtype))


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(EVENTS))
def test_traced_event_evaluates_bitwise_to_the_callbacks(name, dtype):
    cond, affect, n, m = EVENTS[name]
    tc, ta = trace_event(cond, affect, n, m)
    assert tc.shape == () and (ta is None) == (affect is None)
    u, p, t = _points(n, m, dtype)
    assert torch.equal(evaluate(tc, u, p, t), cond(u, p, t))
    if affect is not None:
        assert torch.equal(evaluate(ta, u, p, t), affect(u, p, t))
    # a second trace of the same callbacks is the cached one
    assert trace_event(cond, affect, n, m)[0] is tc


def test_a_condition_must_be_one_value():
    with pytest.raises(NotImplementedError, match="stacked value"):
        trace_event(lambda u, p, t: u, None, 2, 1)
    with pytest.raises(NotImplementedError, match="item 17"):
        trace_event(lambda u, p, t: u[0] > 1.0, None, 2, 1)


@functools.lru_cache(maxsize=None)
def _library(tmp: str):
    """Every emitted event functor in one host library: per event and
    dtype, ``cond_<name>_<T>(u, p, t) -> T`` and ``affect_<name>_<T>(u, p,
    t, out)``, under `Rounded`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of the emitted functors")
    d = Path(tmp)
    (d / "cuda_runtime.h").write_text(STUB)
    parts = ['#include "arith.cuh"', '#include "generated.cuh"', ""]
    for name, (cond, affect, n, m) in sorted(EVENTS.items()):
        tc, ta = trace_event(cond, affect, n, m)
        parts.append(emit.event_functor(f"Ev_{name}", tc, ta))
        for T in ("float", "double"):
            parts.append(
                f'extern "C" {T} cond_{name}_{T}(const {T}* u, const {T}* p, '
                f"{T} t) {{ return Ev_{name}::condition<repro_arith::Rounded>"
                "(u, p, t); }")
            if ta is not None:
                parts.append(
                    f'extern "C" void affect_{name}_{T}(const {T}* u, const '
                    f"{T}* p, {T} t, {T}* out) {{ Ev_{name}::affect<"
                    "repro_arith::Rounded>(u, p, t, out); }")
    src = d / "events.cpp"
    src.write_text("\n".join(parts) + "\n")
    lib = d / "events.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(d), "-I", str(CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _library(str(tmp_path_factory.mktemp("events")))


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(EVENTS))
def test_emitted_event_functor_matches_evaluate(lib, name, dtype):
    cond, affect, n, m = EVENTS[name]
    tc, ta = trace_event(cond, affect, n, m)
    T = "float" if dtype == F32 else "double"
    cfn = getattr(lib, f"cond_{name}_{T}")
    cfn.restype = ctypes.c_float if T == "float" else ctypes.c_double
    u, p, t = _points(n, m, dtype, seed=1)
    B = t.shape[0]
    got = torch.empty(1, B, dtype=dtype)
    got_a = torch.empty(n, B, dtype=dtype)
    for b in range(B):
        ub, pb = u[:, b].contiguous(), p[:, b].contiguous()
        got[0, b] = cfn(_ptr(ub), _ptr(pb), _scalar(T, t[b]))
        if ta is not None:
            out = torch.empty(n, dtype=dtype)
            getattr(lib, f"affect_{name}_{T}")(_ptr(ub), _ptr(pb),
                                               _scalar(T, t[b]), _ptr(out))
            got_a[:, b] = out
    _check(tc.graph, tc.outputs, got, evaluate(tc, u, p, t)[None], dtype,
           "condition")
    if ta is not None:
        _check(ta.graph, ta.outputs, got_a, evaluate(ta, u, p, t), dtype,
               "affect")


def test_a_registered_event_is_its_hand_written_functor():
    """A unit names a registered event's struct of events.cuh; any other
    event is traced into the unit."""
    from repro_torch.kernels.events import event_form, event_launch_args
    ev = tdp.bouncing_ball_event()
    assert event_form(ev, 2, 2) == "repro_ev::BallBounce"
    assert event_launch_args(ev)[0] == 1
    plain = ev._replace(condition=unregistered(ev.condition))
    cond, affect = event_form(plain, 2, 2)
    assert cond.shape == () and affect.shape == (2,)
    assert event_launch_args(plain)[0] == -1
    # an affect that is not the registered functor's: translated too
    other = ev._replace(affect=user_affect)
    assert not isinstance(event_form(other, 2, 2), str)
    unit = units.erk_unit(None, get_tableau("vern7"), F64,
                          hand_functor="repro_erk::Ball",
                          event=event_form(ev, 2, 2))
    assert ("launch<Real, Vern7, repro_erk::Ball, repro_ev::BallBounce>"
            in unit.text)
    assert "struct Ev" not in unit.text
    # a registered event is traced all the same: on a problem whose state
    # it does not fit (the ball's affect on one state), it refuses
    with pytest.raises(IndexError):
        event_form(ev, 1, 1)


def test_routes_send_each_event_form_where_it_compiles():
    """Every event form a hand-written source compiles goes there; every
    other goes to a generated unit."""
    ball, bev = tdp.bouncing_ball_rhs, tdp.bouncing_ball_event()
    plain_ev = bev._replace(condition=unregistered(bev.condition),
                            affect=unregistered(bev.affect))
    tsit5, vern7 = get_tableau("tsit5"), get_tableau("vern7")
    # K1: the registered pair on tsit5 in the source; a translated event,
    # another tableau, another pair, a translated RHS: units
    assert k1.route(ball, tsit5, bev, n=2, m=2).target == k1.SOURCE
    for f, tab, ev in ((ball, tsit5, plain_ev), (ball, vern7, bev),
                       (tdp.linear_decay_rhs, tsit5,
                        tdp.gbm_barrier_event()),
                       (unregistered(ball), tsit5, bev)):
        n, m = (1, 1) if f is tdp.linear_decay_rhs else (2, 2)
        assert isinstance(k1.route(f, tab, ev, n=n, m=m).target,
                          units.Unit)
    # K3: the registered pairs in f64 in the source; in f32, with a
    # translated event, or unpaired: units (the hand-written struct)
    rober, rjac, rev = tdp.rober_rhs, tdp.rober_jac, tdp.rober_half_event()
    rodas5p = get_rosenbrock_tableau("rodas5p")
    assert k3.route(rober, rjac, rodas5p, rev, n=3, m=3)[0] is None
    u32 = k3.route(rober, rjac, rodas5p, rev, n=3, m=3, dtype=F32)[0]
    assert "repro_rb::Rober, false, repro_ev::RoberHalf" in u32.text
    lazy = k3.route(rober, rjac, rodas5p, rev, n=3, m=3, dtype=F32,
                    w_reuse=True)[0]
    assert "repro_rb::Rober, true, repro_ev::RoberHalf" in lazy.text
    assert "copied from rosenbrock_ensemble.cu" in u32.text
    vev = Event(condition=unregistered(lambda u, p, t: u[0]), terminal=True,
                direction=-1)
    uv = k3.route(tdp.vdp_rhs, None, get_rosenbrock_tableau("rodas4"), vev,
                  n=2, m=1, dtype=F32)[0]
    assert "struct Vdp {" in uv.text and "struct Ev {" in uv.text
    # K4 and K5: the registered pairs in the sources; a translated event or
    # an unpaired one in units
    gbm = (tdp.gbm_drift, tdp.gbm_diffusion)
    gev = tdp.gbm_barrier_event()
    kw = dict(noise="diagonal", m_noise=3, n=3, k=2, dtype=F64)
    assert k4.sde_route(*gbm, "em", event=gev, **kw).unit is None
    r = k4.sde_route(*gbm, "em", event=gev._replace(
        condition=unregistered(gev.condition)), **kw)
    assert "repro_sde::Gbm, St, Ev>" in r.unit.text
    r = k4.sde_route(*gbm, "em", event=tdp.ramp_sawtooth_event(), **kw)
    assert "repro_sde::Gbm, St, repro_ev::RampSawtooth>" in r.unit.text
    args = (*gbm, "em", "diagonal", 3, "embedded")
    assert k5._device_functor(*args, n=3, k=2, event=gev)[2] is None
    unit = k5._device_functor(*args, n=3, k=2, event=vev)[2]
    assert "repro_sde::Gbm, St, true, Ev>" in unit.text


def _parse(text, name):
    from test_torch_translate_emit import c_entries
    return _types(c_entries(text)[name])


def test_event_c_entries_take_what_the_wrappers_pass():
    vev = Event(condition=unregistered(lambda u, p, t: u[0]), terminal=True,
                direction=-1)
    ball = tdp.bouncing_ball_rhs
    u1 = k1.route(ball, get_tableau("rk4"), vev, n=2, m=2).target
    assert _parse(u1.text, "erk_ensemble_event_launch") \
        == k1.argtypes(event=True)
    u3 = k3.route(tdp.vdp_rhs, None, get_rosenbrock_tableau("rodas4"), vev,
                  n=2, m=1, dtype=F32)[0]
    assert _parse(u3.text, "rosenbrock_ensemble_event_launch") \
        == k3.argtypes(event=True)
    u4 = k4.sde_route(tdp.gbm_drift, tdp.gbm_diffusion, "milstein",
                      noise="diagonal", m_noise=3, n=3, k=2, dtype=F32,
                      event=vev).unit
    assert _parse(u4.text, "sde_ensemble_event_launch") \
        == k4.argtypes(event=True)
    u5 = k5._device_functor(tdp.gbm_drift, tdp.gbm_diffusion, "heun_strat",
                            "diagonal", 3, "doubling", n=3, k=2,
                            event=vev)[2]
    assert _parse(u5.text, "sde_adaptive_event_launch") \
        == k5.argtypes(event=True)


# ---------------------------------------------------------------------------
# the front door against the reference's Pallas kernel
# ---------------------------------------------------------------------------

def _traced_event(ev, n, m):
    cond, affect = trace_event(ev.condition, ev.affect, n, m)
    return ev._replace(condition=as_function(cond),
                       affect=None if affect is None else as_function(affect))


def _traced(prob):
    n, m = prob.u0.shape[0], prob.p.shape[0]
    return ODEProblem(as_function(trace(prob.f, n, m, outputs=(n,))),
                      prob.u0, prob.p, prob.tspan)


def _assert_same(got, want, tol, t_tol):
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    np.testing.assert_allclose(got.t_final.numpy(), np.asarray(want.t_final),
                               rtol=0, atol=t_tol)
    for g, w in ((got.u_final, want.u_final), (got.us, want.us)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


def _ball(N=4):
    es = np.linspace(0.3, 0.9, N)
    u0s = np.stack([np.full(N, 10.0), np.zeros(N)], 1)
    ps = np.stack([np.full(N, 9.8), es], 1)
    return (JEnsembleProblem(jdp.bouncing_ball_problem(), N,
                             u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
            u0s, ps)


@pytest.mark.parametrize("alg,dt0", [("tsit5", 1e-3), ("vern7", 2e-2)])
def test_ball_with_a_translated_event_matches_reference_kernel(alg, dt0):
    """The bouncing ball, its RHS, condition and affect unregistered:
    vern7 from dt0 2e-2 (from 1e-3 its first error estimates sit at
    rounding level, ROADMAP queue 3)."""
    jens, u0s, ps = _ball()
    kw = dict(alg=alg, t0=0.0, tf=2.0, dt0=dt0, rtol=1e-8, atol=1e-8)
    sv = np.linspace(0.5, 2.0, 4)
    want = jsolve(jens, ensemble="kernel", backend="pallas", lane_tile=4,
                  saveat=jnp.asarray(sv), event=jdp.bouncing_ball_event(),
                  **kw)
    ev = tdp.bouncing_ball_event()
    plain = ev._replace(condition=unregistered(ev.condition),
                        affect=unregistered(ev.affect))
    prob = _traced(tdp.bouncing_ball_problem())
    got = tsolve(ensemble_problem(prob, u0s, ps), ensemble="kernel",
                 backend="cuda", device="cpu", saveat=list(sv),
                 event=_traced_event(plain, 2, 2), **kw)
    # the compiled reference locates each impact within one bisection
    # quantum of the widest step, 2^-30 of 2 s: the state moves by at most
    # the impact speed sqrt(2 g x0) = 14 m/s times that
    quantum = 2.0 * 2.0 ** -30
    _assert_same(got, want, 14.0 * quantum, quantum)
    assert float(got.us[:, :, 0].min()) > -1e-6


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_vdp_rodas4_with_an_event_matches_reference_kernel(dtype):
    """Van der Pol on rodas4 with a terminal event on u[0] = 0 downward
    (mu in [2, 3], so every lane crosses before t = 4), its RHS and event
    translated.  The reference runs in float64 (under the tests' x64 mode
    its solver's loop carry promotes a float32 state): in f64 counts
    identical, the event within one bisection quantum of the compiled
    reference and the states within 1e-10 plus the speed times that
    quantum; in f32 the run is the untranslated
    f32 run bit for bit, and against the f64 reference its event times
    within 1e-6 relative and its states within 5 rtol (f32 and f64 take
    their own accept decisions near rtol 1e-4)."""
    N = 4
    mus = np.linspace(2.0, 3.0, N)[:, None]
    u0s = np.tile([2.0, 0.0], (N, 1))
    kw = dict(alg="rodas4", t0=0.0, tf=4.0, dt0=1e-3, rtol=1e-4,
              atol=1e-6)
    sv = np.linspace(0.0, 4.0, 5)
    want = _vdp_reference()
    tp = tdp.vdp_problem(tspan=(0.0, 4.0), dtype=dtype)
    ev = Event(condition=lambda u, p, t: u[0], terminal=True, direction=-1)
    got = tsolve(ensemble_problem(_traced(tp), u0s, mus, dtype=dtype),
                 ensemble="kernel", backend="cuda", device="cpu",
                 saveat=list(sv), event=_traced_event(ev, 2, 1), **kw)
    assert bool((got.t_final < 4.0).all())
    if dtype == F64:
        # the located root within one bisection quantum of the span,
        # 2^-30 of 4 s, and the state there within |u0'| <= 3 times that
        quantum = 4.0 * 2.0 ** -30
        _assert_same(got, want, 1e-10 + 3.0 * quantum, quantum)
    else:
        raw = tsolve(ensemble_problem(tp, u0s, mus, dtype=dtype),
                     ensemble="kernel", backend="cuda", device="cpu",
                     saveat=list(sv), event=ev, **kw)
        for k in ("us", "u_final", "t_final", "naccept", "nreject"):
            assert torch.equal(getattr(got, k), getattr(raw, k)), k
        np.testing.assert_allclose(got.t_final.numpy(),
                                   np.asarray(want.t_final), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us),
                                   rtol=0, atol=5 * kw["rtol"])
    # the hand-written Van der Pol with this event on the card: a unit
    unit = k3.route(tdp.vdp_rhs, None, get_rosenbrock_tableau("rodas4"), ev,
                    n=2, m=1, dtype=dtype)[0]
    assert isinstance(unit, units.Unit)


@functools.lru_cache(maxsize=None)
def _vdp_reference():
    N = 4
    mus = np.linspace(2.0, 3.0, N)[:, None]
    u0s = np.tile([2.0, 0.0], (N, 1))
    jp = jdp.vdp_problem(tspan=(0.0, 4.0))
    jev = JEvent(condition=lambda u, p, t: u[0], terminal=True, direction=-1)
    return jsolve(JEnsembleProblem(jp, N, u0s=jnp.asarray(u0s),
                                   ps=jnp.asarray(mus)),
                  ensemble="kernel", backend="pallas", lane_tile=4,
                  saveat=jnp.asarray(np.linspace(0.0, 4.0, 5)), event=jev,
                  alg="rodas4", t0=0.0, tf=4.0, dt0=1e-3, rtol=1e-4,
                  atol=1e-6)
