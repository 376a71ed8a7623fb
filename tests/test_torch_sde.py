"""The port's fixed-dt SDE path (`repro_torch.core.sde`, the front door's
sde family, `repro_torch.kernels.em` on the CPU) against the reference
(`repro.core.sde`, `repro.core.ensemble`, the Pallas SDE kernel in
interpret mode), on the same numpy inputs, in float64.

Bars: with JAX's normals injected through a noise table the two packages
do the same arithmetic, and states agree to 1e-12 relative.  With the
counter RNG the Threefry words are equal but the float32 Box–Muller
normals differ by up to ~5e-7 (XLA's and PyTorch's f32 log/cos,
tests/test_torch_rng.py); over these short horizons that moved states by
at most 3.2e-8 relative (measured on every strategy below), so the bar is
3e-7.  The CUDA kernel itself: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import sde as jsde
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro.kernels.em.ops import solve_sde_ensemble_pallas
from repro_torch.configs import de_problems as tdp
from repro_torch.configs.de_problems import lorenz_ensemble
from repro_torch.convert import ensemble_problem, noise_table
from repro_torch.core import sde as tsde
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import EnsembleProblem, SDEProblem
from repro_torch.kernels.em import kernel as sde_kernel
from repro_torch.kernels.em.ops import solve_sde_ensemble_cuda
from repro_torch.kernels.ensemble_kernel import run_ensemble_kernel

TABLE_TOL = 1e-12
RNG_TOL = 3e-7
R, V = 1.5, 0.2


def problems(name):
    if name == "gbm":
        return (jdp.gbm_problem(r=R, v=V, dtype=jnp.float64),
                tdp.gbm_problem(r=R, v=V, dtype=torch.float64))
    return (jdp.crn_problem(tspan=(0.0, 10.0), dtype=jnp.float64),
            tdp.crn_problem(tspan=(0.0, 10.0), dtype=torch.float64))


def arrays(name, N, seed=0):
    if name == "crn":
        return tdp.crn_sweep_arrays(N, seed)
    rng = np.random.default_rng(seed)
    return (0.1 + 0.01 * rng.random((N, 3)),
            np.array([R, V]) + 0.01 * rng.random((N, 2)))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def both(name, *, alg, ensemble, backend, N=16, n_steps=20, dt=0.05,
         save_every=5, table=False, seed=7, lane_offset=0):
    jp, tp = problems(name)
    u0s, ps = arrays(name, N)
    m = jp.noise_dim()
    Z = (np.random.default_rng(1).standard_normal((n_steps, m, N))
         if table else None)
    kw = dict(alg=alg, ensemble=ensemble, t0=0.0, dt0=dt, n_steps=n_steps,
              save_every=save_every, seed=seed, lane_offset=lane_offset)
    want = jsolve(JEnsembleProblem(jp, N, u0s=jnp.asarray(u0s),
                                   ps=jnp.asarray(ps)),
                  backend="pallas" if backend == "cuda" else "xla",
                  noise_table=None if Z is None else jnp.asarray(Z), **kw)
    got = tsolve(ensemble_problem(tp, u0s, ps), backend=backend,
                 device="cpu", noise_table=Z, **kw)
    return got, want


def assert_same_run(got, want, tol):
    assert tuple(got.us.shape) == tuple(np.shape(want.us))
    assert rel(got.us.numpy(), want.us) <= tol
    assert rel(got.u_final.numpy(), want.u_final) <= tol
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
    np.testing.assert_array_equal(got.t_final.numpy(),
                                  np.asarray(want.t_final))
    for name in ("naccept", "nreject", "status", "nf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# ---------------------------------------------------------------------------
# steppers, with the reference's normals injected
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,name", [
    ("em", "gbm"), ("em", "crn"), ("heun_strat", "gbm"),
    ("heun_strat", "crn"), ("platen_w2", "gbm"), ("siea", "gbm"),
    ("milstein", "gbm")])
def test_stepper_with_injected_table_matches_reference(method, name):
    """`sde_solve_fixed` in lanes mode (n, B) on the same noise table."""
    jp, tp = problems(name)
    u0s, ps = arrays(name, 8)
    n_steps, dt = 30, 0.05
    Z = np.random.default_rng(2).standard_normal(
        (n_steps, jp.noise_dim(), 8))
    want = jsde.sde_solve_fixed(jp, jnp.asarray(u0s.T), jnp.asarray(ps.T),
                                0.0, dt, n_steps, key=None, method=method,
                                save_every=10, noise_table=jnp.asarray(Z))
    got = tsde.sde_solve_fixed(tp, torch.from_numpy(u0s.T.copy()),
                               torch.from_numpy(ps.T.copy()), 0.0, dt,
                               n_steps, key=None, method=method,
                               save_every=10, noise_table=torch.from_numpy(Z))
    assert rel(got.us.numpy(), want.us) <= TABLE_TOL
    assert rel(got.u_final.numpy(), want.u_final) <= TABLE_TOL
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
    assert float(got.t_final) == float(want.t_final)
    assert int(got.nf) == int(want.nf) and int(got.naccept) == n_steps


def test_em_pathwise_exact_structure():
    """EM on GBM has the closed form X_{k+1} = X_k (1 + r dt + V dW_k);
    with an injected table the port reproduces it (the reference's own
    test, on the port)."""
    prob = tdp.gbm_problem(r=R, v=V, dtype=torch.float64)
    n_steps, dt = 50, 0.02
    Z = np.random.default_rng(0).standard_normal((n_steps, 3))
    res = tsde.sde_solve_fixed(prob, prob.u0, prob.p, 0.0, dt, n_steps,
                               key=None, method="em", save_every=n_steps,
                               noise_table=torch.from_numpy(Z))
    X = prob.u0.numpy().copy()
    for k in range(n_steps):
        X = X * (1.0 + R * dt + V * np.sqrt(dt) * Z[k])
    np.testing.assert_allclose(res.u_final.numpy(), X, rtol=1e-12)


# ---------------------------------------------------------------------------
# the front door, strategy by strategy, against the reference's same one
# ---------------------------------------------------------------------------

STRATEGIES = [("vmap", "torch"), ("array", "torch"), ("kernel", "torch"),
              ("kernel", "cuda")]


@pytest.mark.parametrize("ensemble,backend", STRATEGIES)
@pytest.mark.parametrize("name,alg", [("gbm", "milstein"), ("gbm", "siea"),
                                      ("crn", "em")])
def test_front_door_counter_rng_matches_reference(name, alg, ensemble,
                                                  backend):
    """The same (seed; step, row, lane) stream on both sides; `kernel`/
    `cuda` on CPU tensors is the kernel's plain version, held against the
    Pallas kernel in interpret mode."""
    got, want = both(name, alg=alg, ensemble=ensemble, backend=backend)
    assert_same_run(got, want, RNG_TOL)


@pytest.mark.parametrize("ensemble,backend", STRATEGIES)
@pytest.mark.parametrize("name,alg", [("gbm", "platen_w2"),
                                      ("crn", "heun_strat")])
def test_front_door_noise_table_matches_reference(name, alg, ensemble,
                                                  backend):
    got, want = both(name, alg=alg, ensemble=ensemble, backend=backend,
                     table=True)
    assert_same_run(got, want, TABLE_TOL)


@pytest.mark.parametrize("ensemble,backend", [("vmap", "torch"),
                                              ("kernel", "cuda")])
def test_lane_offset_wraps_like_the_reference(ensemble, backend):
    """Global lane indices past 2^32 wrap; shards with an offset draw the
    reference's streams."""
    got, want = both("gbm", alg="em", ensemble=ensemble, backend=backend,
                     lane_offset=2 ** 32 - 5)
    assert_same_run(got, want, RNG_TOL)
    base, _ = both("gbm", alg="em", ensemble=ensemble, backend=backend)
    assert rel(got.u_final.numpy(), base.u_final.numpy()) > 1e-3


def test_strategies_agree_with_each_other_on_the_port():
    """vmap, array, kernel/torch and kernel/cuda (CPU) replay one stream:
    their paths are the same to rounding."""
    jp, tp = problems("crn")
    u0s, ps = arrays("crn", 12)
    ep = ensemble_problem(tp, u0s, ps)
    kw = dict(alg="heun_strat", t0=0.0, dt0=0.1, n_steps=30, save_every=10,
              seed=3, device="cpu")
    runs = [tsolve(ep, ensemble=e, backend=b, **kw) for e, b in STRATEGIES]
    for r in runs[1:]:
        assert rel(r.us.numpy(), runs[0].us.numpy()) <= 1e-13


def test_crn_nan_placement_matches_reference():
    """Table-4 sweep: lanes whose sigma goes negative meet a non-integer
    Hill exponent and turn NaN; that is the reference's behaviour, and the
    port puts its NaNs on the same lanes and saves."""
    N, n_steps = 64, 200
    u0s, ps = tdp.crn_sweep_arrays(N, 1)
    kw = dict(alg="em", ensemble="array", t0=0.0, dt0=0.1, n_steps=n_steps,
              save_every=50, seed=1)
    want = jsolve(JEnsembleProblem(jdp.crn_problem(dtype=jnp.float64), N,
                                   u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
                  backend="xla", **kw)
    for ens, be in (("array", "torch"), ("kernel", "cuda")):
        got = tsolve(ensemble_problem(tdp.crn_problem(dtype=torch.float64),
                                      u0s, ps), backend=be, device="cpu",
                     **dict(kw, ensemble=ens))
        a, b = got.us.numpy(), np.asarray(want.us)
        assert (~np.isfinite(b)).any(), "the sweep should produce NaN lanes"
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert rel(a[fin], b[fin]) <= RNG_TOL


def test_em_moments_match_discrete_closed_form_on_the_port():
    """E[X_n] = X0 (1+r dt)^n and E[X_n^2] = X0^2 ((1+r dt)^2 + V^2 dt)^n
    are the exact moments of the EM chain (the reference's test, on the
    port alone, through its counter RNG)."""
    prob = tdp.gbm_problem(r=R, v=V, dtype=torch.float64)
    N, n_steps, dt = 20000, 20, 0.05
    res = tsde.solve_sde_ensemble(EnsembleProblem(prob, N), None, dt,
                                  n_steps, method="em", save_every=n_steps,
                                  seed=1, device="cpu")
    X = res.u_final.numpy()[:, 0]
    mean_exact = 0.1 * (1 + R * dt) ** n_steps
    m2_exact = 0.01 * ((1 + R * dt) ** 2 + V * V * dt) ** n_steps
    assert abs(X.mean() - mean_exact) < 5 * X.std() / np.sqrt(N) + 1e-12
    assert abs((X ** 2).mean() - m2_exact) < \
        5 * (X ** 2).std() / np.sqrt(N) + 1e-12


def test_key_gives_the_seed_as_in_the_reference():
    """A reference PRNG key, carried as an array, seeds the port with its
    last word — the SDE-shaped entry points agree."""
    key = jax.random.PRNGKey(3)
    jp, tp = problems("gbm")
    u0s, ps = arrays("gbm", 8)
    want = solve_sde_ensemble_pallas(jp, jnp.asarray(u0s), jnp.asarray(ps),
                                     key, 0.0, 0.05, 20, method="em",
                                     save_every=10)
    got = solve_sde_ensemble_cuda(tp, torch.from_numpy(u0s),
                                  torch.from_numpy(ps), np.asarray(key), 0.0,
                                  0.05, 20, method="em", save_every=10)
    assert rel(got.us.numpy(), want.us) <= RNG_TOL
    assert int(got.nf) == int(want.nf)
    ep = ensemble_problem(tp, u0s, ps)
    a = tsolve(ep, alg="em", t0=0.0, dt0=0.05, n_steps=20, save_every=10,
               key=np.asarray(key), device="cpu")
    b = tsolve(ep, alg="em", t0=0.0, dt0=0.05, n_steps=20, save_every=10,
               seed=3, device="cpu")
    assert torch.equal(a.us, b.us) and torch.equal(a.us, got.us)


def test_noise_table_converts_from_numpy():
    Z = np.random.default_rng(0).standard_normal((4, 3, 5))
    t = noise_table(Z, dtype=torch.float32)
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert torch.equal(t, torch.from_numpy(Z).float())
    with pytest.raises(ValueError, match="n_steps, m, N"):
        noise_table(Z[0])


# ---------------------------------------------------------------------------
# errors, as the reference raises them (or naming the ROADMAP item)
# ---------------------------------------------------------------------------

def gbm_ep(N=4):
    return EnsembleProblem(tdp.gbm_problem(dtype=torch.float64), N)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(adaptive=True, noise_table=np.zeros((10, 3, 4))),
     NotImplementedError, "fixed-dt only"),
    (dict(saveat=[0.5, 1.0]), NotImplementedError, "save_every"),
    (dict(ensemble="array_eager"), NotImplementedError, "vmap"),
    # the event + adjoint path runs at fixed dt (held to the reference's
    # gradient in tests/test_torch_grad_parity.py); adaptive, it needs the
    # bound, as the reference does
    (dict(event=tdp.gbm_barrier_event(), sensitivity="adjoint",
          adaptive=True), ValueError, "adjoint_steps"),
    (dict(dt0=None), ValueError, "explicit dt0"),
    (dict(n_steps=10, save_every=3), ValueError, "divide"),
    (dict(seed=2 ** 32), ValueError, "seed"),
    (dict(lane_offset=-1), ValueError, "lane_offset"),
    (dict(noise_table=np.zeros((10, 2, 4))), ValueError, "noise_table"),
    (dict(ensemble="kernel", backend="triton"), ValueError, "backend"),
    (dict(alg="tsit5"), TypeError, "stochastic"),
])
def test_sde_front_door_errors(kw, exc, match):
    args = dict(alg="em", t0=0.0, dt0=0.1, n_steps=10, device="cpu")
    args.update(kw)
    with pytest.raises(exc, match=match):
        tsolve(gbm_ep(), **args)


def test_sde_method_on_ode_problem_and_noise_kinds_raise():
    with pytest.raises(TypeError, match="SDE stepper"):
        tsolve(lorenz_ensemble(4), alg="em", dt0=0.1, device="cpu")
    crn = EnsembleProblem(tdp.crn_problem(dtype=torch.float64), 4)
    for alg in ("platen_w2", "milstein"):
        with pytest.raises(ValueError, match="supports noise"):
            tsolve(crn, alg=alg, t0=0.0, dt0=0.1, n_steps=2, device="cpu")
    prob = tdp.gbm_problem(dtype=torch.float64)
    # sde_solve_fixed(key=...) draws the reference's jax.random stream
    # (it raised before the key stream was ported): one trajectory and a
    # lanes tile, against the reference on the same key
    jprob = jdp.gbm_problem(dtype=jnp.float64)
    key = jax.random.PRNGKey(3)
    lanes = np.stack([np.asarray(jprob.u0)] * 5, 1) * np.linspace(
        0.5, 1.5, 5)
    for u0 in (np.asarray(jprob.u0), lanes):
        p = np.asarray(jprob.p) if u0.ndim == 1 else np.stack(
            [np.asarray(jprob.p)] * 5, 1)
        ref = jsde.sde_solve_fixed(jprob, jnp.asarray(u0), jnp.asarray(p),
                                   0.0, 0.1, 4, key=key, save_every=2)
        got = tsde.sde_solve_fixed(prob, torch.tensor(u0), torch.tensor(p),
                                   0.0, 0.1, 4, key=np.asarray(key),
                                   save_every=2)
        np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us),
                                   rtol=TABLE_TOL, atol=0)
    with pytest.raises(ValueError, match="diagonal"):
        tsde.platen_w2_step(None, None, prob.u0, prob.p, 0.0, 0.1,
                            prob.u0, noise="general")


def test_device_sde_registry_and_wrapper_guards():
    with pytest.raises(ValueError, match="no device functor"):
        sde_kernel.device_sde("lorenz")
    assert tdp.gbm_drift.device_sde == tdp.gbm_diffusion.device_sde == "gbm"
    assert tdp.crn_drift.device_sde == tdp.crn_diffusion.device_sde == "crn"
    u0 = torch.ones(3, 4, dtype=torch.float64)
    p = torch.ones(2, 4, dtype=torch.float64)
    kw = dict(noise="diagonal", m_noise=3, t0=0.0, dt=0.1, save_every=1,
              seed=0)
    with pytest.raises(ValueError, match="n_steps"):
        sde_kernel.sde_ensemble(tdp.gbm_drift, tdp.gbm_diffusion, "em", u0,
                                p, n_steps=3, **dict(kw, save_every=2))
    # nf = n_steps * nf_per_step is an int32 row of the stats
    with pytest.raises(ValueError, match="nf_per_step"):
        sde_kernel.sde_ensemble(tdp.gbm_drift, tdp.gbm_diffusion,
                                "heun_strat", u0, p, n_steps=2 ** 30, **kw)
    with pytest.raises(ValueError, match="2\\^32"):
        sde_kernel.sde_ensemble(tdp.gbm_drift, tdp.gbm_diffusion, "em", u0,
                                p, n_steps=3, **dict(kw, seed=-1))
    # CPU tensors run the plain version: counts and t_final as the kernel's
    before = sde_kernel.launches
    us, uf, tf, stats = sde_kernel.sde_ensemble(
        tdp.gbm_drift, tdp.gbm_diffusion, "platen_w2", u0, p, n_steps=3,
        **kw)
    assert sde_kernel.launches == before
    assert tuple(us.shape) == (3, 3, 4) and torch.equal(us[-1], uf)
    assert stats.tolist() == [[3] * 4, [0] * 4, [0] * 4, [6] * 4, [0] * 4,
                              [0] * 4]
    assert torch.allclose(tf, torch.full((4,), 0.3, dtype=torch.float64))


def test_run_ensemble_kernel_extras_are_checked():
    body = lambda u0, p, ex: None
    u0s, ps = torch.zeros(4, 3), torch.zeros(4, 2)
    with pytest.raises(ValueError, match="extra kind"):
        run_ensemble_kernel(body, u0s, ps, ts=torch.zeros(1),
                            extras=[("tiles", torch.zeros(3))])
    # "table" (a dataset leaf) is a kind since the data forms: it reaches
    # the body contiguous, in its own shape
    seen = []
    ok = lambda u0, p, ex: seen.append(ex) or (
        torch.zeros(1, 3, 4), torch.zeros(3, 4), torch.zeros(4),
        torch.zeros(6, 4, dtype=torch.int32))
    run_ensemble_kernel(ok, u0s, ps, ts=torch.zeros(1),
                        extras=[("table", torch.zeros(3, 5).T)])
    assert seen[0][0].shape == (5, 3) and seen[0][0].is_contiguous()
    with pytest.raises(ValueError, match="N=4"):
        run_ensemble_kernel(body, u0s, ps, ts=torch.zeros(1),
                            extras=[("lanes", torch.zeros(2, 5))])


def test_sde_problem_shape_and_registry():
    prob = tdp.crn_problem()
    assert isinstance(prob, SDEProblem)
    assert (prob.n_states, prob.n_params, prob.noise_dim()) == (4, 6, 8)
    g = prob.g(prob.u0, prob.p, 0.0)
    assert tuple(g.shape) == (4, 8)
    jg = jdp.crn_problem().g(jnp.asarray(prob.u0.numpy()),
                             jnp.asarray(prob.p.numpy()), 0.0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    assert tdp.gbm_problem().noise_dim() == 3
