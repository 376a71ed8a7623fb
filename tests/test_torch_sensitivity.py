"""Sensitivities through the port (`repro_torch.core.sensitivity` and the
front door's ``sensitivity=``) against independent oracles, in float64 —
the counterpart of tests/test_sensitivity.py, tests/test_grad_props.py and
the oracle cases of tests/test_grad_parity.py.

  * central finite differences on four entries, rel 1e-4 (adaptive erk on
    Lorenz, rosenbrock23 on Van der Pol, rodas5p on ROBER d/dk1, on the
    kernel route, whose backward replays the plain loops);
  * GBM is linear, so the Euler–Maruyama path's delta is exact:
    dS_T/ds0 = S_T/s0 per path, fixed dt and adaptive, rel 1e-12;
  * its mean, Π(1 + r dt) = (1 + r dt)^n, within four standard errors;
  * the counter streams are global: the gradient of a shard at
    ``lane_offset`` equals the full ensemble's rows bitwise;
  * the continuous adjoint (`adjoint_continuous`) against the discrete one,
    rel 2e-3 (the reference's bar: the discretization error);
  * `forward_sensitivity` against the decay's closed form and against the
    reference's (`jax.jvp` through the same loops) at 1e-10;
  * the vjp is the transpose of the jvp on the bounded program:
    <v, J w> = <Jᵀ v, w>, rel 1e-9 (tests/test_grad_props.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core.problem import EnsembleProblem as JEP
from repro.core.sensitivity import forward_sensitivity as jfwd
from repro_torch import convert
from repro_torch.configs import de_problems as tdp
from repro_torch.core import ODEProblem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import EnsembleProblem as TEP
from repro_torch.core.sensitivity import (adjoint_continuous,
                                          ensemble_value_and_grad,
                                          forward_sensitivity,
                                          suggest_adjoint_steps)
from repro_torch.core.tableaus import get_tableau

FD_REL = 1e-4
EXACT = 1e-12
TAB = get_tableau("tsit5")



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The inputs are a few lanes: one intra-op thread a process keeps the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loss_of(res):
    return (res.us ** 2).sum() + (res.u_final ** 2).sum()


def grad_ps(tprob, u0s, ps, **kw):
    """dL/dps through the front door's adjoint, and the loss as a function
    of ps for finite differences."""
    u0 = torch.tensor(u0s)

    def L(p):
        return loss_of(tsolve(TEP(tprob, u0.shape[0], u0s=u0, ps=p),
                              sensitivity="adjoint", device="cpu", **kw))

    p = torch.tensor(ps, requires_grad=True)
    g, = torch.autograd.grad(L(p), p)
    return g, L


def check_fd(g, L, ps, entries, eps=1e-6):
    for i, j in entries:
        d = torch.zeros(ps.shape, dtype=torch.float64)
        d[i, j] = eps * max(1.0, abs(float(ps[i, j])))
        with torch.no_grad():
            fd = (L(torch.tensor(ps) + d) - L(torch.tensor(ps) - d)) / (
                2 * d[i, j])
        np.testing.assert_allclose(float(g[i, j]), float(fd), rtol=FD_REL)


# ---------------------------------------------------------------------------
# central finite differences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", [("kernel", "cuda")])
def test_erk_adaptive_grad_matches_fd(route):
    rng = np.random.default_rng(0)
    u0s = np.array([-8.0, 7.0, 27.0]) + 0.1 * rng.standard_normal((4, 3))
    ps = np.array([10.0, 28.0, 8.0 / 3.0]) + 0.05 * rng.standard_normal(
        (4, 3))
    tprob = tdp.lorenz_problem(torch.float64)
    kw = dict(alg="tsit5", t0=0.0, tf=1.5, dt0=1e-2, rtol=1e-8, atol=1e-8,
              saveat=torch.linspace(0.0, 1.5, 4, dtype=torch.float64),
              ensemble=route[0], backend=route[1])
    bound = suggest_adjoint_steps(convert.ensemble_problem(tprob, u0s, ps),
                                  device="cpu", **kw)
    g, L = grad_ps(tprob, u0s, ps, adjoint_steps=bound, **kw)
    check_fd(g, L, ps, [(0, 0), (1, 1), (2, 2), (3, 0)])


def test_rosenbrock_grad_matches_fd():
    """rosenbrock23 on Van der Pol (no Jacobian hook) on the kernel route;
    the reference's case with its span cut from 3 to 0.25."""
    rng = np.random.default_rng(1)
    u0s = np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((3, 2))
    ps = np.array([5.0]) + 0.2 * rng.standard_normal((3, 1))
    tprob = tdp.vdp_problem()
    kw = dict(alg="rosenbrock23", t0=0.0, tf=0.25, dt0=1e-3, rtol=1e-7,
              atol=1e-9, saveat=torch.linspace(0.0, 0.25, 4,
                                               dtype=torch.float64),
              ensemble="kernel", backend="cuda")
    bound = suggest_adjoint_steps(convert.ensemble_problem(tprob, u0s, ps),
                                  device="cpu", **kw)
    g, L = grad_ps(tprob, u0s, ps, adjoint_steps=bound, **kw)
    check_fd(g, L, ps, [(0, 0), (1, 0), (2, 0)])


def test_rober_dk1_matches_fd():
    """d/dk1 of ROBER's state at t = 1 (rodas5p, the analytic Jacobian
    hook, lazy W) against central differences on the kernel route, on the
    first and last of four lanes."""
    u0s = np.tile([1.0, 0.0, 0.0], (4, 1))
    ps = np.tile([0.04, 3e7, 1e4], (4, 1)) * np.linspace(0.8, 1.2, 4)[:,
                                                                     None]
    tprob = tdp.rober_problem()
    kw = dict(alg="rodas5p", t0=0.0, tf=1.0, dt0=1e-6, rtol=1e-8,
              atol=1e-10, w_reuse=True, ensemble="kernel", backend="cuda",
              saveat=torch.tensor([0.1, 1.0], dtype=torch.float64))
    bound = suggest_adjoint_steps(convert.ensemble_problem(tprob, u0s, ps),
                                  device="cpu", **kw)
    g, L = grad_ps(tprob, u0s, ps, adjoint_steps=bound, **kw)
    check_fd(g, L, ps, [(0, 0), (3, 0)], eps=1e-5)


# ---------------------------------------------------------------------------
# GBM: the pathwise delta, its mean, shard invariance
# ---------------------------------------------------------------------------

GBM_KW = dict(alg="em", t0=0.0, tf=1.0, n_steps=128, save_every=32, seed=7)
ROUTES = [("vmap", "torch"), ("array", "torch"), ("kernel", "torch"),
          ("kernel", "cuda")]


def gbm_ens(N, r=0.05, v=0.2):
    prob = tdp.gbm_problem(r=r, v=v, dtype=torch.float64)
    return prob, np.full((N, 3), 1.0), np.tile([r, v], (N, 1))


def grad_u0(prob, u0s, ps, loss=lambda r: r.u_final.sum(), **kw):
    u = torch.tensor(u0s, requires_grad=True)
    res = tsolve(TEP(prob, u.shape[0], u0s=u, ps=torch.tensor(ps)),
                 sensitivity="adjoint", device="cpu", **kw)
    g, = torch.autograd.grad(loss(res), u)
    return g, res


@pytest.mark.parametrize("route", ROUTES)
def test_sde_pathwise_grad_closed_form(route):
    prob, s0, ps = gbm_ens(64)
    g, res = grad_u0(prob, s0, ps, ensemble=route[0], backend=route[1],
                     dt0=1.0 / 128, **GBM_KW)
    exact = res.u_final.detach() / torch.tensor(s0)
    np.testing.assert_allclose(g.numpy(), exact.numpy(), rtol=EXACT)


@pytest.mark.parametrize("route", [("kernel", "torch"), ("kernel", "cuda")])
def test_sde_adaptive_pathwise_grad(route):
    prob, s0, ps = gbm_ens(16)
    kw = dict(alg="em", t0=0.0, tf=1.0, dt0=1e-2, adaptive=True, rtol=1e-3,
              atol=1e-4, seed=11, ensemble=route[0], backend=route[1],
              saveat=torch.linspace(0.0, 1.0, 3, dtype=torch.float64))
    bound = suggest_adjoint_steps(convert.ensemble_problem(prob, s0, ps),
                                  device="cpu", **kw)
    g, res = grad_u0(prob, s0, ps, adjoint_steps=bound, **kw)
    assert int(res.status) == 0
    np.testing.assert_allclose(
        g.numpy(), (res.u_final.detach() / torch.tensor(s0)).numpy(),
        rtol=EXACT)


def test_sde_gbm_expected_delta():
    """E[dS_T/ds0] = (1 + r dt)^n for the EM scheme (its mean, not the
    exact e^{rT}): within four standard errors over 512 x 3 paths."""
    r, n = 0.05, 128
    prob, s0, ps = gbm_ens(512, r=r)
    _, (g_u0, _) = ensemble_value_and_grad(
        lambda res: res.u_final.sum(), convert.ensemble_problem(prob, s0, ps),
        ensemble="kernel", backend="cuda", dt0=1.0 / n, device="cpu",
        **GBM_KW)
    d = g_u0.numpy().ravel()
    se = d.std(ddof=1) / np.sqrt(d.size)
    assert abs(d.mean() - (1 + r / n) ** n) < 4 * se


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sde_sharded_grad_equals_local_via_lane_offset(backend):
    prob, s0, ps = gbm_ens(8)
    kw = dict(ensemble="kernel", backend=backend, dt0=1.0 / 128, **GBM_KW)

    def shard(lo, hi):
        return grad_u0(prob, s0[lo:hi], ps[lo:hi], lane_offset=lo, **kw)[0]

    full = shard(0, 8)
    assert torch.equal(torch.cat([shard(0, 3), shard(3, 8)]), full)


# ---------------------------------------------------------------------------
# the continuous adjoint, the closed forms, forward mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True])
def test_discrete_adjoint_matches_continuous_adjoint(adaptive):
    prob = tdp.lorenz_problem(torch.float64)
    dt, n = 0.001, 400
    loss_c, gu_c, gp_c = adjoint_continuous(
        lambda uf: (uf ** 2).sum(), prob.f, TAB, prob.u0, prob.p, 0.0, dt, n)
    ep = TEP(prob, 1, u0s=prob.u0[None], ps=prob.p[None])
    kw = (dict(ensemble="vmap", rtol=1e-9, atol=1e-9, adjoint_steps=2 * n,
               saveat=torch.tensor([dt * n], dtype=torch.float64))
          if adaptive else
          dict(ensemble="kernel", adaptive=False, n_steps=n, save_every=n))
    loss_d, (gu_d, gp_d) = ensemble_value_and_grad(
        lambda r: (r.u_final ** 2).sum(), ep, alg="tsit5", t0=0.0,
        tf=dt * n, dt0=dt, device="cpu", **kw)
    np.testing.assert_allclose(float(loss_c), float(loss_d), rtol=1e-5)
    np.testing.assert_allclose(gp_c.numpy(), gp_d[0].numpy(), rtol=2e-3)
    np.testing.assert_allclose(gu_c.numpy(), gu_d[0].numpy(), rtol=2e-3)


def decay_ens(lams):
    prob = tdp.linear_decay_problem(lam=0.7)
    N = len(lams)
    return convert.ensemble_problem(prob, np.ones((N, 1)),
                                    np.asarray(lams)[:, None])


def test_adjoint_grad_vs_analytic_decay():
    """L = u(T)^2: dL/dλ = -2 T u(T)^2 and dL/du0 = 2 u(T)^2 (u0 = 1)."""
    lams, T = [0.4, 0.9], 2.0
    ep = decay_ens(lams)
    kw = dict(alg="tsit5", ensemble="vmap", t0=0.0, tf=T, dt0=0.01,
              rtol=1e-10, atol=1e-10, device="cpu",
              saveat=torch.tensor([T], dtype=torch.float64))
    bound = suggest_adjoint_steps(ep, **kw)
    _, (g_u0, g_p) = ensemble_value_and_grad(
        lambda r: (r.u_final ** 2).sum(), ep, adjoint_steps=bound, **kw)
    for i, lam in enumerate(lams):
        uT = np.exp(-lam * T)
        np.testing.assert_allclose(float(g_p[i, 0]), -2 * T * uT ** 2,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(g_u0[i, 0]), 2 * uT ** 2, rtol=1e-6)


@pytest.mark.parametrize("wrt", ["ps", "u0s"])
def test_forward_sensitivity_vs_analytic_decay(wrt):
    lams, t = [0.4, 0.7, 1.3], 2.0
    sens = forward_sensitivity(decay_ens(lams), wrt=wrt, ensemble="vmap",
                               alg="tsit5", t0=0.0, tf=t, dt0=0.01,
                               rtol=1e-10, atol=1e-10, device="cpu",
                               saveat=torch.tensor([t], dtype=torch.float64))
    assert sens.shape == (3, 1, 1, 1)
    for i, lam in enumerate(lams):
        want = -t * np.exp(-lam * t) if wrt == "ps" else np.exp(-lam * t)
        np.testing.assert_allclose(float(sens[i, 0, 0, 0]), want, rtol=1e-6)


@pytest.mark.parametrize("ensemble", ["vmap"])
def test_forward_sensitivity_matches_reference_jvp(ensemble):
    """One `torch.func.jvp` per column through the adaptive while loop,
    against the reference's `jax.jvp` through its while loop."""
    rng = np.random.default_rng(2)
    u0s = np.array([-8.0, 7.0, 27.0]) + 0.1 * rng.standard_normal((3, 3))
    ps = np.array([10.0, 28.0, 8.0 / 3.0]) + 0.05 * rng.standard_normal(
        (3, 3))
    kw = dict(alg="tsit5", ensemble=ensemble, t0=0.0, tf=0.5, dt0=1e-2,
              rtol=1e-8, atol=1e-8)
    sv = np.array([0.25, 0.5])
    got = forward_sensitivity(
        convert.ensemble_problem(tdp.lorenz_problem(torch.float64), u0s, ps),
        wrt="ps", device="cpu", saveat=torch.tensor(sv), **kw)
    want = jfwd(JEP(jdp.lorenz_problem(jnp.float64), 3, u0s=jnp.asarray(u0s),
                    ps=jnp.asarray(ps)), wrt="ps",
                backend="xla", saveat=jnp.asarray(sv), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def _linear_problem(rng, dim=3):
    """u' = A u with A = skew - SSᵀ/dim - 0.1 I (decaying)."""
    S = rng.standard_normal((dim, dim))
    A = (S - S.T) / 2 - 0.5 * (S @ S.T) / dim - 0.1 * np.eye(dim)

    def f(u, p, t):
        P = p.reshape((dim, dim) + tuple(p.shape[1:]))
        return (P * u.unsqueeze(0)).sum(1)

    return ODEProblem(f, torch.tensor(rng.standard_normal(dim)),
                      torch.tensor(A.reshape(-1)), (0.0, 1.0), name="randlin")


@pytest.mark.parametrize("seed", [0, 1])
def test_vjp_is_transpose_of_jvp(seed):
    rng = np.random.default_rng(seed)
    prob = _linear_problem(rng)
    u0s = torch.tensor(rng.standard_normal((2, 3)))
    ps = prob.p[None].repeat(2, 1)
    kw = dict(alg="tsit5", ensemble="vmap", t0=0.0, tf=1.0, dt0=1e-2,
              rtol=1e-8, atol=1e-8, device="cpu",
              saveat=torch.tensor([1.0], dtype=torch.float64))
    bound = suggest_adjoint_steps(TEP(prob, 2, u0s=u0s, ps=ps), **kw)

    def fn(u, p):
        return tsolve(TEP(prob, 2, u0s=u, ps=p), sensitivity="adjoint",
                      adjoint_steps=bound, **kw).u_final

    w = (torch.tensor(rng.standard_normal(u0s.shape)),
         torch.tensor(rng.standard_normal(ps.shape)))
    v = torch.tensor(rng.standard_normal((2, 3)))
    _, jvp_out = torch.func.jvp(fn, (u0s, ps), w)
    u = u0s.clone().requires_grad_(True)
    p = ps.clone().requires_grad_(True)
    vjp_out = torch.autograd.grad(fn(u, p), (u, p), v)
    lhs = float((v * jvp_out).sum())
    rhs = float(sum((a * b).sum() for a, b in zip(vjp_out, w)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9, atol=1e-10)
