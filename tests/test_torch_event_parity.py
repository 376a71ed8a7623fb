"""Events through the port's front door (`solve_ensemble_local(event=)`)
against the reference's, for every family and strategy, on the same
numpy-seeded inputs in float64.

Each port strategy is held to the same reference strategy ("kernel" with
backend "torch" or "cuda" — the CUDA kernel's plain version on CPU tensors
— to the reference's "kernel"/"xla"):

  * ERK and Rosenbrock, terminal events: per-lane counts identical,
    t_final within rtol 1e-9, states within 1e-10.
  * ERK and Rosenbrock, the bouncing ball (non-terminal): against the
    reference run op by op (`jax.disable_jit`), counts identical and states
    within 1e-10.  Compiled, XLA contracts products into fused
    multiply-adds, which moves the step grid at roundoff and each located
    bounce by up to one bisection quantum (ROADMAP queue 3).
  * ROBER's half-conversion event at rtol 1e-6, where counts are held
    (ROADMAP queue 3): counts identical, states within the reference's
    ROBER bar (rtol 1e-6, atol 1e-14), and t_final within two bisection
    quanta of the widest step, 2·tf·2^-30 (the compiled reference's fused
    multiply-adds move its step grid at roundoff, and the event step here
    spans thousands of seconds).
  * SDE fixed dt with a shared noise table: paths within 1e-12.
  * SDE adaptive with the reference's bridge normals substituted (as
    tests/test_torch_adaptive_sde.py does): counts identical, states within
    1e-12, the re-anchoring sawtooth with both estimators included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import EnsembleProblem as JEnsembleProblem
from repro.core import solve_ensemble_local as jsolve
from repro.core.events import Event as JEvent
from repro.core.problem import ODEProblem as JODEProblem
from repro.core.problem import SDEProblem as JSDEProblem
from repro.kernels import rng as jrng
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem, noise_table
from repro_torch.core import solve_ensemble_local as tsolve
from repro_torch.kernels import rng as trng

TOL = 1e-10
SDE_TOL = 1e-12
ODE_ROUTES = [("vmap", "torch", "vmap"), ("kernel", "torch", "kernel"),
              ("kernel", "cuda", "kernel")]

# the reference's HALF_EVENT (tests/test_event_parity.py)
J_HALF = JEvent(condition=lambda u, p, t: u[0] - 0.5, terminal=True,
                direction=-1)


def assert_same(got, want, *, tol=TOL, t_rtol=1e-9, counts=True):
    if counts:
        np.testing.assert_array_equal(got.naccept.numpy(),
                                      np.asarray(want.naccept))
        np.testing.assert_array_equal(got.nreject.numpy(),
                                      np.asarray(want.nreject))
    np.testing.assert_allclose(got.t_final.numpy(), np.asarray(want.t_final),
                               rtol=t_rtol, atol=0)
    for g, w in ((got.u_final, want.u_final), (got.us, want.us)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


def decay(N=6):
    lams = np.linspace(0.5, 2.0, N)
    jp = JODEProblem(lambda u, p, t: -p[0] * u, jnp.asarray([1.0]),
                     jnp.asarray([1.0]), (0.0, 3.0))
    u0s = np.ones((N, 1))
    return (JEnsembleProblem(jp, N, u0s=jnp.asarray(u0s),
                             ps=jnp.asarray(lams[:, None])),
            ensemble_problem(tdp.linear_decay_problem(), u0s, lams[:, None]),
            np.log(2.0) / lams)


@pytest.mark.parametrize("alg", ["tsit5", "dopri5", "rosenbrock23"])
def test_terminal_event_parity_every_strategy(alg):
    jens, tens, exact = decay()
    kw = dict(alg=alg, t0=0.0, tf=3.0, dt0=1e-3, rtol=1e-9, atol=1e-9)
    routes = list(ODE_ROUTES)
    if alg == "rosenbrock23":
        routes.append(("array", "torch", "array"))
    for ens, backend, ref_ens in routes:
        want = jsolve(jens, ensemble=ref_ens, backend="xla",
                      saveat=jnp.asarray([3.0]), event=J_HALF, **kw)
        got = tsolve(tens, ensemble=ens, backend=backend, saveat=[3.0],
                     event=tdp.half_event(), device="cpu", **kw)
        assert_same(got, want)
        # the exact answer: t* = ln 2 / lam, the state on the threshold
        np.testing.assert_allclose(got.t_final.numpy(), exact, atol=1e-6)
        np.testing.assert_allclose(got.u_final.numpy()[:, 0], 0.5, atol=1e-6)


def ball(N=8):
    """e linear over (0.3, 0.9); t in [0, 2] stays short of every lane's
    accumulation point t1 (1 + 2e / (1 - e)) (2.65 s for e = 0.3)."""
    es = np.linspace(0.3, 0.9, N)
    u0s = np.stack([np.full(N, 10.0), np.zeros(N)], 1)
    ps = np.stack([np.full(N, 9.8), es], 1)
    return (JEnsembleProblem(jdp.bouncing_ball_problem(), N,
                             u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
            ensemble_problem(tdp.bouncing_ball_problem(), u0s, ps))


@pytest.mark.parametrize("alg", ["tsit5", "dopri5", "rosenbrock23"])
def test_bouncing_ball_matches_reference_op_by_op(alg):
    jens, tens = ball()
    kw = dict(alg=alg, t0=0.0, tf=2.0, dt0=1e-3, rtol=1e-8, atol=1e-8)
    sv = np.linspace(0.5, 2.0, 4)
    with jax.disable_jit():
        want = jsolve(jens, ensemble="kernel", backend="xla", lane_tile=8,
                      saveat=jnp.asarray(sv), event=jdp.bouncing_ball_event(),
                      **kw)
    for ens, backend, _ in ODE_ROUTES:
        got = tsolve(tens, ensemble=ens, backend=backend, saveat=list(sv),
                     event=tdp.bouncing_ball_event(), device="cpu", **kw)
        assert_same(got, want)
        assert float(got.us[:, :, 0].min()) > -1e-6   # bounced, never sank


@pytest.mark.parametrize("alg,w_reuse", [("rodas4", False), ("rodas4", True),
                                         ("rodas5p", False)])
def test_rober_half_conversion_event(alg, w_reuse):
    """ROBER with the terminal y3 = 0.5 event (tests/test_stiff.py), on a
    k1 sweep, at rtol 1e-6: counts identical, states within the ROBER bar,
    event times within two bisection quanta, the located state on the
    threshold within the reference's 1e-6."""
    N = 4
    k1 = np.exp(np.linspace(np.log(0.01), np.log(0.1), N))
    ps = np.stack([k1, np.full(N, 3e7), np.full(N, 1e4)], 1)
    u0s = np.tile([1.0, 0.0, 0.0], (N, 1))
    jens = JEnsembleProblem(jdp.rober_problem(tspan=(0.0, 1e4)), N,
                            u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    tens = ensemble_problem(tdp.rober_problem(tspan=(0.0, 1e4)), u0s, ps)
    jv = JEvent(condition=lambda u, p, t: u[2] - 0.5, terminal=True,
                direction=1)
    kw = dict(alg=alg, t0=0.0, tf=1e4, dt0=1e-6, rtol=1e-6, atol=1e-8,
              w_reuse=w_reuse)
    want = jsolve(jens, ensemble="kernel", backend="xla",
                  saveat=jnp.asarray([1e4]), event=jv, **kw)
    for ens, backend in (("kernel", "torch"), ("kernel", "cuda")):
        got = tsolve(tens, ensemble=ens, backend=backend, saveat=[1e4],
                     event=tdp.rober_half_event(), device="cpu", **kw)
        np.testing.assert_array_equal(got.naccept.numpy(),
                                      np.asarray(want.naccept))
        np.testing.assert_array_equal(got.nreject.numpy(),
                                      np.asarray(want.nreject))
        np.testing.assert_allclose(got.t_final.numpy(),
                                   np.asarray(want.t_final), rtol=0,
                                   atol=2 * 1e4 * 2.0 ** -30)
        for g, w in ((got.u_final, want.u_final), (got.us, want.us)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-14)
        assert bool((got.t_final < 1e4).all())
        np.testing.assert_allclose(got.u_final.numpy()[:, 2], 0.5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# SDE: fixed dt with a shared noise table, adaptive on the same normals
# ---------------------------------------------------------------------------

# the reference's SDE_EV
J_BARRIER = JEvent(condition=lambda u, p, t: u[0] - 0.18, terminal=True,
                   direction=1)


def gbm(N=10):
    u0s = np.full((N, 3), 0.1)
    ps = np.tile([1.5, 0.2], (N, 1))
    return (JEnsembleProblem(jdp.gbm_problem(r=1.5, v=0.2,
                                             dtype=jnp.float64), N,
                             u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
            ensemble_problem(tdp.gbm_problem(r=1.5, v=0.2,
                                             dtype=torch.float64), u0s, ps))


def ramp(N=4):
    jp = JSDEProblem(lambda u, p, t: jnp.ones_like(u) * p[0],
                     lambda u, p, t: p[1] * u, jnp.asarray([0.0]),
                     jnp.asarray([1.0, 1e-10]), (0.0, 1.0),
                     noise="diagonal", name="ramp")
    u0s, ps = np.zeros((N, 1)), np.tile([1.0, 1e-10], (N, 1))
    jv = JEvent(condition=lambda u, p, t: u[0] - 0.15, direction=1,
                affect=lambda u, p, t: u - 0.1)
    return (JEnsembleProblem(jp, N, u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
            ensemble_problem(tdp.ramp_problem(), u0s, ps), jv)


SDE_ROUTES = [("vmap", "torch", "vmap"), ("array", "torch", "array"),
              ("kernel", "torch", "kernel"), ("kernel", "cuda", "kernel")]


@pytest.mark.parametrize("problem,alg", [("gbm", "em"), ("gbm", "platen_w2"),
                                         ("ramp", "em")])
def test_sde_fixed_dt_event_parity(problem, alg):
    if problem == "gbm":
        (jens, tens), jv, tv = gbm(), J_BARRIER, tdp.gbm_barrier_event()
        dt, n_steps = 0.025, 40
    else:
        jens, tens, jv = ramp()
        tv, dt, n_steps = tdp.ramp_sawtooth_event(), 0.0125, 80
    N, m = tens.n_trajectories, tens.prob.noise_dim()
    Z = np.random.default_rng(3).standard_normal((n_steps, m, N))
    kw = dict(alg=alg, t0=0.0, tf=1.0, dt0=dt, n_steps=n_steps,
              save_every=8)
    for ens, backend, ref_ens in SDE_ROUTES:
        want = jsolve(jens, ensemble=ref_ens, backend="xla", event=jv,
                      noise_table=jnp.asarray(Z), **kw)
        got = tsolve(tens, ensemble=ens, backend=backend, event=tv,
                     noise_table=noise_table(Z), device="cpu", **kw)
        assert_same(got, want, tol=SDE_TOL, t_rtol=SDE_TOL)
    if problem == "gbm":
        # the barrier fired on every lane, and froze it on the threshold
        assert bool((got.t_final < 1.0).all())
        np.testing.assert_allclose(got.u_final.numpy()[:, 0], 0.18,
                                   atol=1e-3)


_ref_normals = jax.jit(jrng.bridge_normals, static_argnums=(0,))


def ref_normals(seed, node, lane, row, dtype=torch.float32):
    shape = torch.broadcast_shapes(node.shape, lane.shape, row.shape)
    args = [jnp.asarray(x.expand(shape).numpy().astype(np.uint32))
            for x in (node, lane, row)]
    return torch.from_numpy(np.array(_ref_normals(seed, *args))).to(dtype)


@pytest.fixture
def same_normals(monkeypatch):
    monkeypatch.setattr(trng, "bridge_normals", ref_normals)


@pytest.mark.parametrize("problem,est", [("gbm", "embedded"),
                                         ("gbm", "doubling"),
                                         ("ramp", "embedded"),
                                         ("ramp", "doubling")])
def test_sde_adaptive_event_parity(same_normals, problem, est):
    if problem == "gbm":
        (jens, tens), jv, tv = gbm(), J_BARRIER, tdp.gbm_barrier_event()
    else:
        jens, tens, jv = ramp()
        tv = tdp.ramp_sawtooth_event()
    kw = dict(alg="em", t0=0.0, tf=1.0, dt0=0.05, adaptive=True, rtol=1e-3,
              atol=1e-5, seed=11, error_est=est)
    sv = [0.25, 0.5, 0.75, 1.0]
    for ens, backend, ref_ens in SDE_ROUTES:
        want = jsolve(jens, ensemble=ref_ens, backend="xla", event=jv,
                      saveat=jnp.asarray(sv), **kw)
        got = tsolve(tens, ensemble=ens, backend=backend, event=tv,
                     saveat=sv, lane_tile=4, device="cpu", **kw)
        assert_same(got, want, tol=SDE_TOL, t_rtol=SDE_TOL)
    if problem == "gbm":
        assert bool((got.t_final < 1.0).all())
        np.testing.assert_allclose(got.u_final.numpy()[:, 0], 0.18,
                                   atol=1e-6)
    else:
        # re-anchoring quantizes each resume to one dyadic cell past the
        # event: 9 events lose at most 9 h_res (h_res = 2^-11 here)
        np.testing.assert_allclose(got.u_final.numpy()[:, 0], 0.1,
                                   atol=9 * 2.0 ** -11 + 1e-4)


# ---------------------------------------------------------------------------
# where the front door refuses an event
# ---------------------------------------------------------------------------

def test_events_refused_where_the_reference_refuses():
    jens, tens, _ = decay(2)
    kw = dict(alg="tsit5", t0=0.0, tf=1.0, dt0=1e-3)
    with pytest.raises(NotImplementedError, match="array_eager"):
        tsolve(tens, ensemble="array_eager", event=tdp.half_event(),
               device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="array_eager"):
        jsolve(jens, ensemble="array_eager", event=J_HALF, **kw)
    # the erk lock-step array strategy: one dt cannot stop one trajectory
    with pytest.raises(ValueError, match="per-trajectory"):
        tsolve(tens, ensemble="array", event=tdp.half_event(), device="cpu",
               **kw)
    with pytest.raises(TypeError):
        jsolve(jens, ensemble="array", event=J_HALF, **kw)


def test_event_capability_flag_enforced():
    from repro_torch.core.methods import MethodSpec, valid_dispatch
    from repro_torch.core.tableaus import get_tableau
    spec = MethodSpec(name="noev", family="erk", order=5,
                      tableau=get_tableau("tsit5"), events=False)
    _, tens, _ = decay(2)
    with pytest.raises(ValueError, match="events"):
        tsolve(tens, alg=spec, t0=0.0, tf=0.1, dt0=1e-3,
               event=tdp.half_event(), device="cpu")
    assert not valid_dispatch(spec, "kernel", events=True)[0]
    for ens, ok in (("kernel", True), ("vmap", True), ("array", False),
                    ("array_eager", False)):
        assert valid_dispatch(spec.__class__(**{**spec.__dict__,
                                                "events": True}),
                              ens, events=True)[0] == ok


def test_solvers_reexport_event():
    """`repro_torch.core.solvers.Event` is the events module's, as the
    reference's de_problems imports it from solvers."""
    from repro_torch.core import events, solvers
    assert solvers.Event is events.Event
