"""The slice as a whole against the JAX package: an RHS that carries no
device registration goes through the reference's front door on its
Pallas kernel (``ensemble="kernel"``, ``backend="pallas"``, interpret mode
on the CPU, as its own tests run it) and through the port's front door
(``backend="cuda"``, whose plain version runs on CPU tensors) with the
problem's callbacks replaced by their translation's plain version,
``ir.as_function(trace(f))`` — the function the generated functor is held
to on the card.

Cases (N = 8, short spans): tsit5 (adaptive and fixed dt) on the
reference quickstart's inline Lorenz, t in [0, 0.5]; a user tableau,
Heun–Euler 2(1), built from its arrays in both packages (adaptive at rtol
1e-5); rodas5p on ROBER with ``jac=None`` (the derived Jacobian against
the reference's jacfwd), t in [0, 10]; em on the CRN sweep with an
injected noise table, 30 steps.
Bars (ROADMAP): per-lane counts identical, states within 1e-10 (adaptive)
or 1e-12 (fixed dt, noise table), ROBER within its bar (rtol 1e-6, atol
1e-14).  The reference runs once a case (`functools.cache`)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tableaus as jtab
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro.core.problem import ODEProblem as JODEProblem
from repro.core.problem import SDEProblem as JSDEProblem
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem, tableau_from_arrays
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import ODEProblem, SDEProblem
from repro_torch.translate import derive
from repro_torch.translate.ir import as_function, evaluate
from repro_torch.translate.trace import trace, trace_pair

N = 8
HEUN = dict(a=[[0.0, 0.0], [1.0, 0.0]], b=[0.5, 0.5], btilde=[-0.5, 0.5],
            c=[0.0, 1.0], order=2, embedded_order=1, fsal=False)


def j_lorenz(u, p, t):
    s, r, b = p[0], p[1], p[2]
    return jnp.stack([s * (u[1] - u[0]), r * u[0] - u[1] - u[0] * u[2],
                      u[0] * u[1] - b * u[2]])


def t_lorenz(u, p, t):
    s, r, b = p[0], p[1], p[2]
    return torch.stack([s * (u[1] - u[0]), r * u[0] - u[1] - u[0] * u[2],
                        u[0] * u[1] - b * u[2]])


def j_rober(u, p, t):
    k1, k2, k3 = p[0], p[1], p[2]
    return jnp.stack([-k1 * u[0] + k3 * u[1] * u[2],
                      k1 * u[0] - k2 * u[1] * u[1] - k3 * u[1] * u[2],
                      k2 * u[1] * u[1]])


def t_rober(u, p, t):
    return tdp.rober_rhs(u, p, t)


def lorenz_arrays(seed=0):
    rng = np.random.default_rng(seed)
    u0s = np.stack([1.0 + 0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N)], axis=1)
    ps = np.stack([np.full(N, 10.0), rng.uniform(0.0, 21.0, N),
                   np.full(N, 8.0 / 3.0)], axis=1)
    return u0s, ps


# Heun–Euler is second order: rtol 1e-5 keeps its interpret-mode run short
ERK_KW = {"adaptive": (dict(dt0=1e-3, rtol=1e-8, atol=1e-8), 1e-10),
          "fixed": (dict(dt0=1e-2, adaptive=False), 1e-12)}
LOOSE = dict(rtol=1e-5, atol=1e-5)
TF = 0.5
SAVEAT = np.linspace(0.0, TF, 6)


def _erk_kw(alg, mode):
    kw = dict(ERK_KW[mode][0])
    if alg == "heun_euler" and mode == "adaptive":
        kw.update(LOOSE)
    return kw


def _j_tableau():
    a = dict(HEUN)
    return jtab.Tableau("heun_euler", np.array(a["a"]), np.array(a["b"]),
                        np.array(a["btilde"]), np.array(a["c"]), a["order"],
                        a["embedded_order"], a["fsal"])


@functools.cache
def erk_reference(alg, mode):
    u0s, ps = lorenz_arrays()
    prob = JODEProblem(j_lorenz, jnp.zeros(3), jnp.zeros(3), (0.0, 1.0))
    ep = JEnsembleProblem(prob, N, u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    r = jsolve(ep, alg=_j_tableau() if alg == "heun_euler" else alg,
               ensemble="kernel", backend="pallas", t0=0.0, tf=TF,
               saveat=SAVEAT, lane_tile=4, **_erk_kw(alg, mode))
    return {k: np.asarray(v) for k, v in r._asdict().items()}


def _port(prob, u0s, ps, **kw):
    r = tsolve(ensemble_problem(prob, u0s, ps), ensemble="kernel",
               backend="cuda", device="cpu", **kw)
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in r._asdict().items()}


def _same_counts(got, want):
    for k in ("naccept", "nreject"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["status"]) == int(want["status"])
    assert int(got["nf"]) == int(want["nf"])


@pytest.mark.parametrize("alg,mode", [("tsit5", "adaptive"),
                                      ("tsit5", "fixed"),
                                      ("heun_euler", "adaptive"),
                                      ("heun_euler", "fixed")])
def test_unregistered_lorenz_matches_reference_kernel(alg, mode):
    u0s, ps = lorenz_arrays()
    traced = trace(t_lorenz, 3, 3, outputs=(3,))
    prob = ODEProblem(as_function(traced), torch.zeros(3, dtype=torch.float64),
                      torch.zeros(3, dtype=torch.float64), (0.0, 1.0))
    tab = (tableau_from_arrays("heun_euler", **HEUN) if alg == "heun_euler"
           else alg)
    kw, tol = _erk_kw(alg, mode), ERK_KW[mode][1]
    got = _port(prob, u0s, ps, alg=tab, t0=0.0, tf=TF, saveat=SAVEAT, **kw)
    want = erk_reference(alg, mode)
    _same_counts(got, want)
    for k in ("us", "u_final", "t_final"):
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)
    # the raw function gives the same run as its translation, bit for bit
    raw = _port(ODEProblem(t_lorenz, prob.u0, prob.p, (0.0, TF)), u0s, ps,
                alg=tab, t0=0.0, tf=TF, saveat=SAVEAT, **kw)
    for k in ("us", "u_final", "naccept"):
        assert np.array_equal(raw[k], got[k]), k


ROBER_SAVEAT = np.array([1e-2, 1.0, 10.0])
ROBER_KW = dict(alg="rodas5p", dt0=1e-6, rtol=1e-6, atol=1e-8, t0=0.0,
                tf=10.0)


def rober_arrays():
    k1 = np.exp(np.linspace(np.log(0.01), np.log(0.1), N))
    ps = np.stack([k1, np.full(N, 3e7), np.full(N, 1e4)], axis=1)
    u0s = np.tile([1.0, 0.0, 0.0], (N, 1))
    return u0s, ps


@functools.cache
def rober_reference():
    u0s, ps = rober_arrays()
    prob = JODEProblem(j_rober, jnp.zeros(3), jnp.zeros(3), (0.0, 10.0))
    ep = JEnsembleProblem(prob, N, u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    r = jsolve(ep, ensemble="kernel", backend="pallas", lane_tile=4,
               saveat=jnp.asarray(ROBER_SAVEAT), **ROBER_KW)
    return {k: np.asarray(v) for k, v in r._asdict().items()}


def test_rober_derived_jacobian_matches_reference_kernel():
    """jac=None: the port's plain version takes `torch.func.jacfwd`, which
    the derived Jacobian equals bit for bit on ROBER (and so does the
    analytic one: tests/test_torch_translate.py)."""
    u0s, ps = rober_arrays()
    traced = trace(t_rober, 3, 3, outputs=(3,))
    prob = ODEProblem(as_function(traced), torch.zeros(3, dtype=torch.float64),
                      torch.zeros(3, dtype=torch.float64), (0.0, 10.0))
    got = _port(prob, u0s, ps, saveat=ROBER_SAVEAT, **ROBER_KW)
    want = rober_reference()
    _same_counts(got, want)
    for k in ("us", "u_final"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-14,
                                   err_msg=k)
    J = derive.jacobian(traced)
    u = torch.from_numpy(want["u_final"].T.copy())
    p = torch.from_numpy(ps.T.copy())
    t = torch.zeros(N, dtype=torch.float64)
    assert torch.equal(evaluate(J, u, p, t), tdp.rober_jac(u, p, t))


CRN_KW = dict(alg="em", t0=0.0, dt0=0.1, n_steps=30, save_every=10, seed=7)


def j_crn_drift(u, p, t):
    S, D, tau, v0, n = p[0], p[1], p[2], p[3], p[4]
    hill = (S * u[0]) ** n / ((S * u[0]) ** n + (D * u[3]) ** n + 1.0)
    return jnp.stack([v0 + hill - u[0], (u[0] - u[1]) / tau,
                      (u[1] - u[2]) / tau, (u[2] - u[3]) / tau])


def j_crn_diffusion(u, p, t):
    S, D, tau, v0, n, eta = p[0], p[1], p[2], p[3], p[4], p[5]
    pos = lambda x: jnp.sqrt(jnp.maximum(x, 0.0))  # noqa: E731
    hill = (S * u[0]) ** n / ((S * u[0]) ** n + (D * u[3]) ** n + 1.0)
    z = jnp.zeros_like(u[0])
    rows = [
        [eta * pos(v0 + hill), -eta * pos(u[0]), z, z, z, z, z, z],
        [z, z, eta * pos(u[0] / tau), -eta * pos(u[1] / tau), z, z, z, z],
        [z, z, z, z, eta * pos(u[1] / tau), -eta * pos(u[2] / tau), z, z],
        [z, z, z, z, z, z, eta * pos(u[2] / tau), -eta * pos(u[3] / tau)],
    ]
    return jnp.stack([jnp.stack(r) for r in rows])


def crn_inputs():
    u0s, ps = tdp.crn_sweep_arrays(N, 0)
    Z = np.random.default_rng(1).standard_normal((CRN_KW["n_steps"], 8, N))
    return u0s, ps, Z


@functools.cache
def crn_reference():
    u0s, ps, Z = crn_inputs()
    prob = JSDEProblem(j_crn_drift, j_crn_diffusion, jnp.zeros(4),
                       jnp.zeros(6), (0.0, 3.0), noise="general",
                       n_noise=8)
    ep = JEnsembleProblem(prob, N, u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    r = jsolve(ep, ensemble="kernel", backend="pallas",
               noise_table=jnp.asarray(Z), **CRN_KW)
    return {k: np.asarray(v) for k, v in r._asdict().items()}


def test_unregistered_crn_with_noise_table_matches_reference_kernel():
    u0s, ps, Z = crn_inputs()
    f = lambda u, p, t: tdp.crn_drift(u, p, t)  # noqa: E731
    g = lambda u, p, t: tdp.crn_diffusion(u, p, t)  # noqa: E731
    tf, tg = trace_pair(f, g, 4, 6, f_outputs=(4,), g_outputs=(4, 8))
    prob = SDEProblem(as_function(tf), as_function(tg),
                      torch.zeros(4, dtype=torch.float64),
                      torch.zeros(6, dtype=torch.float64), (0.0, 3.0),
                      noise="general", n_noise=8)
    got = _port(prob, u0s, ps, noise_table=torch.from_numpy(Z), **CRN_KW)
    want = crn_reference()
    for k in ("us", "u_final"):
        a, b = got[k], want[k]
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    for k in ("naccept", "nf", "t_final"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
