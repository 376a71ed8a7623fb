"""The port's adaptive SDE path on its own counter stream, and its
contracts, against the reference (`repro.core.sde`, `repro.core.methods`,
`repro.core.ensemble`), in float64.

Without a shared noise source the float32 bridge normals of the two
packages differ by a few ulps (tests/test_torch_bridge.py).  Nudging every
bridge normal by 2 float32 ulps changed the per-lane step counts of the
reference on 0.1–0.2% of 1024 GBM lanes, moved u_final by at most 9.6e-8
relative on the lanes whose counts held and by at most 2.3e-3 on any lane.
So the bars here: counts equal on all lanes but one, u_final within 1e-6
relative on the lanes whose counts are equal and within 1e-2 on every lane.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import controller as jctrl
from repro.core import methods as jmethods
from repro.core import sde as jsde
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro_torch.configs import de_problems as tdp
from repro_torch.configs.de_problems import lorenz_ensemble
from repro_torch.convert import ensemble_problem
from repro_torch.core import controller as tctrl
from repro_torch.core import methods as tmethods
from repro_torch.core import sde as tsde
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import EnsembleProblem
from repro_torch.kernels.em import adaptive as k5

R, V = 1.5, 0.2
SAME_COUNTS_TOL, ANY_LANE_TOL = 1e-6, 1e-2
GBM_KW = dict(t0=0.0, tf=1.0, dt0=0.05, rtol=1e-3, atol=1e-5, seed=7,
              saveat=[0.25, 0.5, 0.75, 1.0])


def gbm_arrays(N, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 + 0.01 * rng.random((N, 3)),
            np.array([R, V]) + 0.01 * rng.random((N, 2)))


def both(name, N, **kw):
    if name == "gbm":
        jp = jdp.gbm_problem(r=R, v=V, dtype=jnp.float64)
        tp = tdp.gbm_problem(r=R, v=V, dtype=torch.float64)
        u0s, ps = gbm_arrays(N)
        kw = dict(GBM_KW, **kw)
    else:
        jp = jdp.crn_problem(tspan=(0.0, 1.0), dtype=jnp.float64)
        tp = tdp.crn_problem(tspan=(0.0, 1.0), dtype=torch.float64)
        u0s, ps = tdp.crn_sweep_arrays(N, 0)
        kw = dict(t0=0.0, tf=1.0, dt0=0.1, rtol=1e-3, atol=1e-5, seed=7,
                  saveat=[0.25, 0.5, 0.75, 1.0], **kw)
    want = jsolve(JEnsembleProblem(jp, N, u0s=jnp.asarray(u0s),
                                   ps=jnp.asarray(ps)),
                  ensemble="kernel", backend="xla", adaptive=True,
                  **dict(kw, saveat=jnp.asarray(kw["saveat"])))
    got = tsolve(ensemble_problem(tp, u0s, ps), ensemble="kernel",
                 backend="cuda", device="cpu", adaptive=True, **kw)
    return got, want


@pytest.mark.parametrize("name,alg,est,N,offset", [
    ("gbm", "em", "embedded", 64, 0), ("gbm", "em", "doubling", 64, 0),
    ("gbm", "milstein", "embedded", 64, 0),
    ("gbm", "milstein", "doubling", 64, 0),
    ("gbm", "heun_strat", "doubling", 64, 0),
    ("gbm", "platen_w2", "doubling", 64, 0),
    ("crn", "em", "doubling", 24, 2 ** 32 - 20)])
def test_front_door_counter_stream_close_to_reference(name, alg, est, N,
                                                      offset):
    got, want = both(name, N, alg=alg, error_est=est, lane_offset=offset)
    same = ((got.naccept.numpy() == np.asarray(want.naccept))
            & (got.nreject.numpy() == np.asarray(want.nreject)))
    assert same.sum() >= N - 1, same
    uf, wf = got.u_final.numpy(), np.asarray(want.u_final)
    fin = np.isfinite(wf).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(uf).all(axis=1), fin)
    err = (np.abs(uf - wf) / np.abs(wf)).max(axis=1)
    assert err[same & fin].max() <= SAME_COUNTS_TOL
    assert err[fin].max() <= ANY_LANE_TOL
    assert int(got.status) == int(want.status)


@pytest.mark.parametrize("est", ["embedded", "doubling"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_lane_offset_shards_equal_global_slices(est, backend):
    """Shard-local solves with `lane_offset` are slices of the global
    solve, bitwise; without the offset a shard replays shard 0's paths."""
    u0s, ps = gbm_arrays(10)
    prob = tdp.gbm_problem(r=R, v=V, dtype=torch.float64)
    kw = dict(alg="em", ensemble="kernel", backend=backend, device="cpu",
              adaptive=True, error_est=est, t0=0.0, tf=1.0, dt0=0.025,
              rtol=1e-3, atol=1e-5, seed=3, saveat=[1.0])
    full = tsolve(ensemble_problem(prob, u0s, ps), **kw)
    r0 = tsolve(ensemble_problem(prob, u0s[:5], ps[:5]), lane_offset=0,
                **kw)
    r1 = tsolve(ensemble_problem(prob, u0s[5:], ps[5:]), lane_offset=5,
                **kw)
    assert torch.equal(full.u_final, torch.cat([r0.u_final, r1.u_final]))
    assert torch.equal(full.naccept, torch.cat([r0.naccept, r1.naccept]))
    replay = tsolve(ensemble_problem(prob, u0s[5:], ps[5:]), lane_offset=0,
                    **kw)
    assert not torch.equal(r1.u_final, replay.u_final)


def test_registry_adaptive_fields_equal_the_reference():
    for name in ("em", "gpuem", "euler_maruyama", "milstein", "heun_strat",
                 "platen_w2", "siea", "gpusiea"):
        spec, ref = tmethods.get_method(name), jmethods.get_method(name)
        assert (spec.name, spec.adaptive, spec.error_est, spec.order) == \
            (ref.name, ref.adaptive, ref.error_est, ref.order)
        assert (spec.embedded is None) == (ref.embedded is None)
        if ref.embedded is not None:
            assert (spec.embedded.est_order, spec.embedded.nf_per_attempt) \
                == (ref.embedded.est_order, ref.embedded.nf_per_attempt)
            assert spec.embedded.fn is tsde.SDE_EMBEDDED[spec.name].fn
    assert set(tsde.SDE_EMBEDDED) == set(jsde.SDE_EMBEDDED)
    assert tmethods.get_method("em").adaptive


@pytest.mark.parametrize("alg,ensemble,backend,adaptive,error_est", [
    ("em", "kernel", "torch", True, "embedded"),
    ("em", "kernel", "torch", True, "doubling"),
    ("heun_strat", "kernel", "torch", True, "embedded"),
    ("platen_w2", "vmap", "torch", True, "doubling"),
    ("milstein", "kernel", "cuda", True, "embedded"),
    ("tsit5", "kernel", "torch", None, "embedded"),
    ("rodas5p", "kernel", "torch", None, "doubling")])
def test_valid_dispatch_error_est_matches_reference(alg, ensemble, backend,
                                                    adaptive, error_est):
    ref_backend = {"torch": "xla", "cuda": "pallas"}[backend]
    got = tmethods.valid_dispatch(tmethods.get_method(alg), ensemble,
                                  backend, adaptive=adaptive,
                                  error_est=error_est)
    want = jmethods.valid_dispatch(jmethods.get_method(alg), ensemble,
                                   ref_backend, adaptive=adaptive,
                                   error_est=error_est)
    assert got == want


def test_controller_for_order_1_and_bridge_depth_equal_the_reference():
    assert tuple(tctrl.PIController.for_order(1)) == \
        tuple(jctrl.PIController.for_order(1))
    for t0, tf, dt0 in ((0.0, 1.0, 0.05), (0.0, 1.0, 0.02), (0.0, 10.0, 0.1),
                        (2.0, 3.0, 1.0), (0.0, 1e4, 1e-6), (0.0, 1.0, 0.5)):
        assert tsde.default_bridge_depth(t0, tf, dt0) == \
            jsde.default_bridge_depth(t0, tf, dt0)


@pytest.mark.parametrize("pair", ["em", "milstein"])
def test_embedded_steps_match_reference(pair):
    rng = np.random.default_rng(4)
    B = 32
    u = 0.1 + rng.random((3, B))
    p = np.stack([1.5 + 0.1 * rng.random(B), 0.2 + 0.1 * rng.random(B)])
    dt = 0.01 + 0.05 * rng.random(B)
    dW = np.sqrt(dt) * rng.standard_normal((3, B))
    jp = jdp.gbm_problem(dtype=jnp.float64)
    tp = tdp.gbm_problem(dtype=torch.float64)
    want = jsde.SDE_EMBEDDED[pair].fn(jp.f, jp.g, *map(jnp.asarray,
                                                       (u, p, 0.3, dt, dW)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    got = tsde.SDE_EMBEDDED[pair].fn(tp.f, tp.g, t(u), t(p), t(0.3), t(dt),
                                     t(dW))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=0)


def test_milstein_pair_ddb_is_the_device_functors():
    """The nested JVP of the milstein pair on GBM computes p1·(p1·(p1·u)),
    the hand-written `ddb` of csrc/sde_problems.cuh, bit for bit."""
    rng = np.random.default_rng(5)
    u = torch.from_numpy(0.1 + rng.random((3, 16)))
    p = torch.from_numpy(np.stack([np.full(16, 1.5),
                                   0.2 + rng.random(16)]))
    dt = torch.from_numpy(0.01 + 0.05 * rng.random(16))
    dW = torch.from_numpy(rng.standard_normal((3, 16)))
    prob = tdp.gbm_problem(dtype=torch.float64)
    _, err = tsde.milstein_embedded_step(prob.f, prob.g, u, p, 0.0, dt, dW)
    a0 = p[0] * u
    ddb = p[1] * (p[1] * (p[1] * u))
    want = ((a0 - a0 / (1.0 + dt * a0.abs())) * dt
            + ddb.abs() * (dt * torch.sqrt(dt)) / torch.sqrt(
                torch.tensor(6.0, dtype=torch.float64)))
    assert torch.equal(err, want)


def test_scalar_mode_is_one_lane():
    prob = tdp.gbm_problem(r=R, v=V, dtype=torch.float64)
    u0s, ps = gbm_arrays(3)
    kw = dict(seed=9, m_noise=3, saveat=torch.tensor([0.5, 1.0],
                                                     dtype=torch.float64),
              rtol=1e-3, atol=1e-5, depth=12, error_est="embedded",
              embedded=tsde.em_embedded_step)
    lanes = tsde.sde_solve_adaptive(
        prob.f, prob.g, tsde.em_step, "diagonal", torch.from_numpy(u0s.T),
        torch.from_numpy(ps.T), 0.0, 1.0, 0.05,
        lane_idx=torch.tensor([7, 8, 9]), lanes=True, **kw)
    one = tsde.sde_solve_adaptive(
        prob.f, prob.g, tsde.em_step, "diagonal", torch.from_numpy(u0s[1]),
        torch.from_numpy(ps[1]), 0.0, 1.0, 0.05, lane_idx=8, **kw)
    assert torch.equal(one.us, lanes.us[..., 1])
    assert torch.equal(one.u_final, lanes.u_final[:, 1])
    assert int(one.naccept) == int(lanes.naccept[1])
    assert int(one.status) == 0 and one.t_final.dim() == 0


def ens4():
    return EnsembleProblem(tdp.gbm_problem(r=R, v=V, dtype=torch.float64), 4)


def jens4():
    return JEnsembleProblem(jdp.gbm_problem(r=R, v=V, dtype=jnp.float64), 4)


ADAPT = dict(alg="em", t0=0.0, tf=1.0, dt0=0.05, adaptive=True, rtol=1e-3,
             atol=1e-5, seed=11)


@pytest.mark.parametrize("kw,match", [
    (dict(ADAPT, ensemble="vmap", error_est="magic"), "error_est"),
    (dict(alg="em", t0=0.0, tf=1.0, dt0=0.05, seed=1, save_every=20,
          error_est="embedded"), "adaptive"),
    (dict(ADAPT, alg="heun_strat", ensemble="vmap", error_est="embedded"),
     "doubling"),
    (dict(alg="tsit5", t0=0.0, tf=0.1, dt0=1e-3, error_est="embedded"),
     "estimator"),
    (dict(ADAPT, noise_table=np.zeros((4, 3, 4))), "fixed-dt only"),
    (dict(ADAPT, ensemble="array_eager"), "vmap"),
])
def test_adaptive_errors_as_the_reference_raises(kw, match):
    """The reference's error cases (tests/test_adaptive_sde.py) raise the
    same exception types in the port."""
    ode = kw["alg"] == "tsit5"
    from repro.configs.de_problems import lorenz_ensemble as jlorenz
    jep = jlorenz(2, dtype=jnp.float64) if ode else jens4()
    tep = lorenz_ensemble(2, dtype=torch.float64) if ode else ens4()
    jkw = dict(kw)
    if "noise_table" in jkw:
        jkw["noise_table"] = jnp.asarray(jkw["noise_table"])
    with pytest.raises(Exception) as want:
        jsolve(jep, **jkw)
    with pytest.raises(type(want.value), match=match):
        tsolve(tep, device="cpu", **kw)


def test_adaptive_general_noise_embedded_and_later_slices_raise():
    crn = EnsembleProblem(tdp.crn_problem(dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="diagonal-noise only"):
        tsolve(crn, device="cpu", **dict(ADAPT, error_est="embedded"))
    # events and the bounded loop run on the adaptive path now.  Event +
    # adjoint without a bound is the reference's refusal, word for word;
    # with one, the gradient reaches u0s through the event on the stream
    with pytest.raises(ValueError) as want:
        jsolve(jens4(), sensitivity="adjoint",
               event=jsde.Event(condition=lambda u, p, t: u[0] - 0.18,
                                terminal=True, direction=1), **ADAPT)
    with pytest.raises(ValueError) as got:
        tsolve(ens4(), device="cpu", event=tdp.gbm_barrier_event(),
               sensitivity="adjoint", **ADAPT)
    assert str(got.value) == str(want.value)
    u = torch.full((4, 3), 0.1, dtype=torch.float64, requires_grad=True)
    res = tsolve(EnsembleProblem(tdp.gbm_problem(r=R, v=V,
                                                 dtype=torch.float64), 4,
                                 u0s=u), device="cpu",
                 event=tdp.gbm_barrier_event(), sensitivity="adjoint",
                 adjoint_steps=200, **ADAPT)
    g, = torch.autograd.grad(res.u_final.sum(), u)
    assert int(res.status) == 0 and bool(torch.isfinite(g).all())
    # the bounded loop (with and without an event) equals the while loop
    # bitwise once the bound covers the attempts, and reports status 1
    # below them
    prob = tdp.gbm_problem(dtype=torch.float64)
    args = (prob.f, prob.g, tsde.em_step, "diagonal", prob.u0, prob.p, 0.0,
            1.0, 0.1)
    kw = dict(seed=0, lane_idx=0, m_noise=3, depth=8)
    for extra in (dict(event=tdp.gbm_barrier_event()), {}):
        plain = tsde.sde_solve_adaptive(*args, **kw, **extra)
        r0 = plain[0] if extra else plain
        K = int(r0.naccept + r0.nreject)
        for bound in (dict(bounded_steps=K + 3),
                      dict(bounded_steps=K + 3, checkpoint_every=2)):
            out = tsde.sde_solve_adaptive(*args, **kw, **extra, **bound)
            o0 = out[0] if extra else out
            for a, b in zip(o0, r0):
                assert torch.equal(a, b) if torch.is_tensor(a) else a == b
        short = tsde.sde_solve_adaptive(*args, **kw, **extra,
                                        bounded_steps=max(1, K // 2))
        assert int((short[0] if extra else short).status) == 1


def test_kernel_binding_refuses_combinations_it_has_no_instantiation_of():
    """What the kernel does not compile in raises before any launch; an
    unregistered pair goes to a generated unit."""
    gbm = (tdp.gbm_drift, tdp.gbm_diffusion)
    crn = (tdp.crn_drift, tdp.crn_diffusion)
    with pytest.raises(ValueError, match="diagonal-noise only"):
        k5._device_functor(*crn, "em", "general", 8, "embedded")
    with pytest.raises(ValueError, match="no embedded pair"):
        k5._device_functor(*gbm, "heun_strat", "diagonal", 3, "embedded")
    with pytest.raises(ValueError, match="diagonal noise only"):
        k5._device_functor(*crn, "platen_w2", "general", 8, "doubling")
    name, fun, unit = k5._device_functor(
        lambda u, p, t: u, tdp.gbm_diffusion, "em", "diagonal", 3,
        "doubling", n=3, k=2)
    assert name is None and unit is not None and (fun.n, fun.k) == (3, 2)
    assert "repro_sde_adaptive::launch<Real, Prob, St, false" in unit.text
    assert k5._device_functor(*gbm, "milstein", "diagonal", 3,
                              "embedded")[0] == "gbm"
    assert k5._device_functor(*crn, "heun_strat", "general", 8,
                              "doubling")[0] == "crn"
    beta1, beta2, *_, richardson = k5.controller_constants(1, 0.5)
    assert (beta1, beta2) == (0.35, 0.2)
    assert richardson == 1.0 / (2.0 ** 0.5 - 1.0)
    u0 = torch.ones(3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="depth"):
        k5.sde_adaptive_ensemble(*gbm, "em", u0, u0[:2], u0[0, :1],
                                 noise="diagonal", m_noise=3, t0=0.0,
                                 tf=1.0, dt0=0.1, rtol=1e-3, atol=1e-5,
                                 max_iters=10, seed=0, depth=31, order=0.5,
                                 error_est="embedded", est_order=1,
                                 nf_per_attempt=1)
