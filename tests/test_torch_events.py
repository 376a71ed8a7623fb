"""The port's event machinery (`repro_torch.core.events`) and the ERK
engine's event branch against the reference's (`repro.core.events`,
`repro.core.solvers`), on the same numpy-seeded inputs in float64, and the
device event functors' constants (`csrc/events.cuh`) against the Python
events they stand for.

Bars: the event primitives equal the reference's bit for bit (both round
every operation alone in the same order); the solver-level cases hold
event counts identical and event times, final times and states within
1e-10 of the reference run op by op (`jax.disable_jit`).  Compiled, XLA
contracts the reference's products into fused multiply-adds, which moves
its step grid at roundoff and so its located event time by up to one
bisection quantum, dt·2^-bisect_iters (ROADMAP queue 3);
`test_compiled_reference_within_one_bisection_quantum` holds that bar.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import AdaptiveOptions as JOptions
from repro.core import events as jev
from repro.core import get_tableau as jget_tableau
from repro.core import solve_adaptive as jsolve_adaptive
from repro_torch.configs import de_problems as tdp
from repro_torch.core import events as tev
from repro_torch.core.solvers import AdaptiveOptions, solve_adaptive
from repro_torch.core.tableaus import get_tableau

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10
B = 16


def lanes_state(seed=0):
    """(u_old, u_cand) (2, B) float64 around the threshold 0.3 of u[0],
    with lanes whose u_old[0] sits exactly on it (g_old == 0)."""
    rng = np.random.default_rng(seed)
    u_old = rng.uniform(-1.0, 1.0, (2, B))
    u_cand = rng.uniform(-1.0, 1.0, (2, B))
    u_old[0, :4] = 0.3
    return u_old, u_cand


def both(ev_kwargs, cond, affect=None):
    """The same event in both packages: cond/affect are (xp) -> callables."""
    return (jev.Event(condition=cond(jnp), affect=affect and affect(jnp),
                      **ev_kwargs),
            tev.Event(condition=cond(torch), affect=affect and affect(torch),
                      **ev_kwargs))


def cond_03(xp):
    return lambda u, p, t: u[0] - 0.3


def affect_flip(xp):
    return lambda u, p, t: xp.stack([u[0] * 0.0, -p[0] * u[1]])


@pytest.mark.parametrize("direction", [-1, 0, 1])
def test_event_crossing_matches_reference(direction):
    rng = np.random.default_rng(direction + 5)
    g_old = rng.standard_normal(64)
    g_new = rng.standard_normal(64)
    g_old[:6] = 0.0
    g_new[3:9] = 0.0
    g_new[20] = np.nan
    jv, tv = both(dict(direction=direction), cond_03)
    want = np.asarray(jev.event_crossing(jv, jnp.asarray(g_old),
                                         jnp.asarray(g_new)))
    got = tev.event_crossing(tv, torch.from_numpy(g_old),
                             torch.from_numpy(g_new)).numpy()
    np.testing.assert_array_equal(got, want)


def test_interpolants_match_reference():
    rng = np.random.default_rng(1)
    u0, u1, f0, f1 = (rng.standard_normal((3, B)) for _ in range(4))
    dt, th = rng.uniform(0.01, 0.1, B), rng.uniform(0.0, 1.0, B)
    np.testing.assert_array_equal(
        tev.linear_interp(*map(torch.from_numpy, (u0, u1, th)),
                          lanes=True).numpy(),
        np.asarray(jev.linear_interp(*map(jnp.asarray, (u0, u1, th)),
                                     lanes=True)))
    np.testing.assert_array_equal(
        tev.hermite_interp(*map(torch.from_numpy, (u0, f0, u1, f1, dt, th)),
                           lanes=True).numpy(),
        np.asarray(jev.hermite_interp(*map(jnp.asarray,
                                           (u0, f0, u1, f1, dt, th)),
                                      lanes=True)))


def test_bisect_event_matches_reference():
    u_old, u_cand = lanes_state(2)
    t_old, dt = 0.25, np.full(B, 0.125)
    jv, tv = both(dict(direction=0, bisect_iters=30), cond_03)
    ju = [jnp.asarray(x) for x in (u_old, u_cand)]
    tu = [torch.from_numpy(x) for x in (u_old, u_cand)]
    g_old = u_old[0] - 0.3 + 1e-3
    jth, jus = jev.bisect_event(
        jv, lambda th: jev.linear_interp(*ju, th, lanes=True), None, t_old,
        jnp.asarray(dt), jnp.asarray(g_old))
    tth, tus = tev.bisect_event(
        tv, lambda th: tev.linear_interp(*tu, th, lanes=True), None, t_old,
        torch.from_numpy(dt), torch.from_numpy(g_old))
    np.testing.assert_array_equal(tth.numpy(), np.asarray(jth))
    np.testing.assert_array_equal(tus.numpy(), np.asarray(jus))


@pytest.mark.parametrize("terminal", [False, True])
@pytest.mark.parametrize("with_affect", [False, True])
@pytest.mark.parametrize("direction", [-1, 0, 1])
def test_handle_event_matches_reference(terminal, with_affect, direction):
    """Lanes mode: some lanes start on the root (g_old == 0, the theta_eps
    re-anchor), some are rejected (accept false); every output bitwise."""
    u_old, u_cand = lanes_state(3)
    p = np.full((1, B), 0.8)
    t_old = np.linspace(0.0, 1.0, B)
    dt = np.full(B, 0.0625)
    accept = np.arange(B) % 5 != 4
    event_t = np.full(B, np.inf)
    event_count = np.arange(B, dtype=np.int32) % 3
    jv, tv = both(dict(direction=direction, terminal=terminal),
                  cond_03, affect_flip if with_affect else None)
    ju = [jnp.asarray(x) for x in (u_old, u_cand)]
    tu = [torch.from_numpy(x) for x in (u_old, u_cand)]
    want = jev.handle_event(
        jv, lambda th: jev.linear_interp(*ju, th, lanes=True), *ju,
        jnp.asarray(p), jnp.asarray(t_old), jnp.asarray(dt),
        jnp.asarray(t_old + dt), jnp.asarray(accept), jnp.asarray(event_t),
        jnp.asarray(event_count), lanes=True)
    got = tev.handle_event(
        tv, lambda th: tev.linear_interp(*tu, th, lanes=True), *tu,
        torch.from_numpy(p), torch.from_numpy(t_old), torch.from_numpy(dt),
        torch.from_numpy(t_old + dt), torch.from_numpy(accept),
        torch.from_numpy(event_t), torch.from_numpy(event_count), lanes=True)
    assert int(np.asarray(want[3]).sum() - event_count.sum()) > 0  # hits
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_handle_event_scalar_mode_matches_reference():
    """Per-trajectory control (0-d), the g_old == 0 re-anchor included."""
    jv, tv = both(dict(direction=1), cond_03, affect_flip)
    for u_old, u_cand in (([0.3, 1.0], [0.5, 2.0]), ([0.1, 1.0], [0.5, 2.0]),
                          ([0.4, 1.0], [0.5, 2.0])):
        ju = [jnp.asarray(u_old), jnp.asarray(u_cand)]
        tu = [torch.tensor(u_old, dtype=torch.float64),
              torch.tensor(u_cand, dtype=torch.float64)]
        want = jev.handle_event(
            jv, lambda th: jev.linear_interp(*ju, th), *ju,
            jnp.asarray([0.8]), jnp.asarray(0.5), jnp.asarray(0.1),
            jnp.asarray(0.6), jnp.asarray(True), jnp.asarray(jnp.inf),
            jnp.asarray(0, jnp.int32))
        got = tev.handle_event(
            tv, lambda th: tev.linear_interp(*tu, th), *tu,
            torch.tensor([0.8], dtype=torch.float64),
            torch.tensor(0.5, dtype=torch.float64),
            torch.tensor(0.1, dtype=torch.float64),
            torch.tensor(0.6, dtype=torch.float64), torch.tensor(True),
            torch.tensor(float("inf"), dtype=torch.float64),
            torch.tensor(0, dtype=torch.int32))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the ERK engine's event branch: the reference's tests/test_events.py cases
# ---------------------------------------------------------------------------

def _ball_inputs(e, x0=10.0, lanes=None):
    if lanes is None:
        return np.array([x0, 0.0]), np.array([9.8, e])
    es = np.linspace(0.3, 0.9, lanes)
    return (np.stack([np.full(lanes, x0), np.zeros(lanes)]),
            np.stack([np.full(lanes, 9.8), es]))


T1 = float(np.sqrt(2 * 10.0 / 9.8))
E05_IMPACTS = [T1 + 2 * T1 * sum(0.5 ** j for j in range(1, k + 1))
               for k in range(4)]
SOLVER_CASES = {
    # name: (e, lanes, tf, rtol, terminal, max_iters)
    "first_impact": (0.8, None, T1 + 0.3, 1e-9, False, 100_000),
    "bounce_sequence": (0.5, None, E05_IMPACTS[-1] + 0.05, 1e-10, False,
                        200_000),
    "terminal_stop": (0.9, None, 15.0, 1e-9, True, 100_000),
    "lanes_restitution": (None, 5, T1 + 0.2, 1e-9, False, 100_000),
}


def _events_for(terminal):
    if terminal:
        return (jev.Event(condition=lambda u, p, t: u[0], terminal=True,
                          direction=-1),
                tev.Event(condition=lambda u, p, t: u[0], terminal=True,
                          direction=-1))
    return jdp.bouncing_ball_event(), tdp.bouncing_ball_event()


def _solve_both(case, compiled=False):
    e, lanes, tf, tol, terminal, max_iters = SOLVER_CASES[case]
    u0, p = _ball_inputs(e, lanes=lanes)
    jv, tv = _events_for(terminal)

    def ref():
        return jsolve_adaptive(
            jdp.bouncing_ball_rhs, jget_tableau("tsit5"), jnp.asarray(u0),
            jnp.asarray(p), 0.0, tf, 1e-3, saveat=jnp.asarray([tf]),
            opts=JOptions(rtol=tol, atol=tol, max_iters=max_iters), event=jv,
            lanes=lanes is not None)

    if compiled:
        want = ref()
    else:
        with jax.disable_jit():
            want = ref()
    got = solve_adaptive(
        tdp.bouncing_ball_rhs, get_tableau("tsit5"), torch.from_numpy(u0),
        torch.from_numpy(p), 0.0, tf, 1e-3, saveat=[tf],
        opts=AdaptiveOptions(rtol=tol, atol=tol, max_iters=max_iters),
        event=tv, lanes=lanes is not None)
    return want, got


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solve_adaptive_events_match_reference(case):
    lanes = SOLVER_CASES[case][1]
    (want, wlog), (got, glog) = _solve_both(case)
    np.testing.assert_array_equal(glog["event_count"].numpy(),
                                  np.asarray(wlog["event_count"]))
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    for g, w in ((glog["event_t"], wlog["event_t"]),
                 (got.t_final, want.t_final), (got.u_final, want.u_final),
                 (got.us, want.us)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
    # and the reference's own exactness bars, on the port
    if case == "first_impact":
        assert int(glog["event_count"]) == 1
        assert abs(float(glog["event_t"]) - T1) < 1e-6
    if case == "bounce_sequence":
        assert int(glog["event_count"]) == 4
        assert abs(float(glog["event_t"]) - E05_IMPACTS[-1]) < 1e-4
    if case == "terminal_stop":
        assert abs(float(got.t_final) - T1) < 1e-6
    if case == "lanes_restitution":
        np.testing.assert_array_equal(glog["event_count"].numpy(),
                                      np.ones(lanes, np.int32))


def test_compiled_reference_within_one_bisection_quantum():
    """Against the compiled reference the step counts hold and the event
    time moves by less than one bisection quantum of the event step."""
    (want, wlog), (got, glog) = _solve_both("first_impact", compiled=True)
    assert int(got.naccept) == int(want.naccept)
    assert int(glog["event_count"]) == int(wlog["event_count"]) == 1
    quantum = float(want.t_final) * 2.0 ** -30   # dt_step < t_final here
    assert abs(float(glog["event_t"]) - float(wlog["event_t"])) < quantum


def test_array_mode_events_raise():
    """One lock-step dt cannot stop one trajectory: the port refuses, the
    reference fails on its loop carry's shape."""
    u0, p = _ball_inputs(None, lanes=4)
    with pytest.raises(ValueError, match="per-trajectory"):
        solve_adaptive(tdp.bouncing_ball_rhs, get_tableau("tsit5"),
                       torch.from_numpy(u0), torch.from_numpy(p), 0.0, 2.0,
                       1e-3, event=tdp.bouncing_ball_event(), lanes=False)
    with pytest.raises(TypeError):
        jsolve_adaptive(jdp.bouncing_ball_rhs, jget_tableau("tsit5"),
                        jnp.asarray(u0), jnp.asarray(p), 0.0, 2.0, 1e-3,
                        event=jdp.bouncing_ball_event(), lanes=False)


# ---------------------------------------------------------------------------
# the device event functors (csrc/events.cuh) against the Python events
# ---------------------------------------------------------------------------

def _functor_source(name):
    text = (ROOT / "src/repro_torch/csrc/events.cuh").read_text()
    m = re.search(r"struct " + name + r" \{(.*?)\n\};", text, re.S)
    assert m, name
    return m.group(1)


def _literals(src):
    return [float(x) for x in re.findall(r"T\(([-0-9.e]+)\)", src)]


@pytest.mark.parametrize("functor,event,want_cond,want_affect", [
    ("BallBounce", tdp.bouncing_ball_event(), [], [0.0]),
    ("DecayHalf", tdp.half_event(), [0.5], None),
    ("RoberHalf", tdp.rober_half_event(), [0.5], None),
    ("GbmBarrier", tdp.gbm_barrier_event(), [0.18], None),
    ("RampSawtooth", tdp.ramp_sawtooth_event(), [0.15], [0.1]),
])
def test_device_event_functors_match_python(functor, event, want_cond,
                                            want_affect):
    """The functor's literals are the Python event's constants; its id and
    affect flag are the registry's; the condition reads the same state
    component; and the Python event is registered with it."""
    from repro_torch.kernels.events import EVENT_FUNCTORS
    src = _functor_source(functor)
    cond = re.search(r"condition\(.*?\{(.*?)\n  \}", src, re.S).group(1)
    affect = re.search(r"affect\(.*?\{(.*?)\n  \}", src, re.S)
    assert _literals(cond) == want_cond
    name = event.condition.device_event
    fun = EVENT_FUNCTORS[name]
    assert f"kEventId = {fun.id};" in src
    assert f"kAffect = {'true' if fun.affect else 'false'};" in src
    assert (affect is not None) == fun.affect == (want_affect is not None)
    if affect is not None:
        assert _literals(affect.group(1)) == want_affect
        assert event.affect.device_event == name
    # the condition reads the component the Python event reads
    comp = {"BallBounce": 0, "DecayHalf": 0, "RoberHalf": 2, "GbmBarrier": 0,
            "RampSawtooth": 0}[functor]
    assert f"u[{comp}]" in cond
    u = torch.full((3, 2), 0.25, dtype=torch.float64)
    u[comp] = 0.75
    p = torch.tensor([[9.8, 9.8], [0.5, 0.5]], dtype=torch.float64)
    want = 0.75 - (want_cond[0] if want_cond else 0.0)
    assert torch.equal(event.condition(u, p, 0.0),
                       torch.full((2,), want, dtype=torch.float64))


def test_device_restitution_is_parameter_row_one():
    """The bounce's affect flips v by p[1], as the Python affect does."""
    src = _functor_source("BallBounce")
    assert "p[1]" in re.search(r"affect\(.*?\{(.*?)\n  \}", src,
                               re.S).group(1)
    u = torch.tensor([[-0.0], [-3.0]], dtype=torch.float64)
    p = torch.tensor([[9.8], [0.25]], dtype=torch.float64)
    out = tdp.bouncing_ball_affect(u, p, 0.0)
    assert out[0].item() == 0.0 and out[1].item() == 0.75


def test_theta_eps_is_the_reference_constant():
    """events.cuh re-anchors g_old == 0 at theta = 1e-4, as both Python
    packages do."""
    text = (ROOT / "src/repro_torch/csrc/events.cuh").read_text()
    assert "kThetaEps = 1e-4;" in text
    import inspect
    for mod in (jev, tev):
        assert "1e-4" in inspect.getsource(mod.handle_event)
