"""Gradients through the port's front door (``sensitivity="adjoint"``)
against the reference's (`jax.grad` of the same loss on the same numpy
inputs), in float64 — the counterpart of tests/test_grad_parity.py.

The port's routes are ``vmap``, ``array`` and ``kernel``/``torch`` (the
bounded, checkpointed lanes loops; on the adaptive families ``vmap`` and
``kernel``/``torch`` run the same lanes engine over one tile) and
``kernel``/``cuda`` (on the CPU its plain version runs the forward solve
and `kernel_adjoint` replays the bounded loop in the backward pass).  Each
case runs on a few of them, and together the cases cover each.  The
reference side runs its ``kernel``/``xla`` route, whose gradient its
Pallas route reproduces (the same replay).  Bars:

  * adaptive erk (tsit5, dopri5 on Lorenz, the reference's LORENZ_KW) and
    rosenbrock23 on Van der Pol (no Jacobian hook: `jacfwd` is
    differentiated inside the checkpointed segments): per-lane naccept and
    nreject equal first, then value and gradients rel 1e-10, abs 1e-12;
  * rodas5p on ROBER (analytic Jacobian hook), eager and lazy W: per-lane
    counts equal, gradients at the reference's ROBER states bar, rel 1e-8
    (XLA fuses the LU's multiply-subtracts; tests/test_torch_stiff_tight.py);
  * fixed-dt erk and the SDE paths on an injected noise table: 1e-12; the
    counter stream: 3e-7 (the float32 normals differ by ulps between
    XLA-CPU and PyTorch, tests/test_torch_sde.py), elementwise on the value
    and dL/du0s, and relative to the largest entry on dL/dps (dL/dσ sums
    the increments, Σ dW, so an entry near a cancellation has no relative
    bar; one of 16 entries sat at 3.2e-7 elementwise); the adaptive SDE on the
    reference's bridge normals (tests/test_torch_adaptive_sde.py): 1e-12;
  * table values (tests/test_texture_data.py::
    test_grad_wrt_table_values_matches_fd_all_paths): abs 1e-10 on every
    port route;
  * events (the decay half point on tsit5, the GBM barrier on em): rel 1e-10
    and 1e-12.

The reference's gradients are computed once per case (`functools.cache`):
its `jax.grad` compiles are the slow part of this file.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.events import Event as JEvent
from repro.core.interp import UniformTable1D as JTable
from repro.core.problem import EnsembleProblem as JEP
from repro.kernels import rng as jrng
from repro_torch import convert
from repro_torch.configs import de_problems as tdp
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import EnsembleProblem as TEP
from repro_torch.core.sensitivity import suggest_adjoint_steps
from repro_torch.kernels import rng as trng

VM, KT, KC = ("vmap", "torch"), ("kernel", "torch"), ("kernel", "cuda")
REL, ABS = 1e-10, 1e-12
FIXED_TOL = 1e-12
RNG_TOL = 3e-7
ROBER_REL = 1e-8



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The inputs are a few lanes: one intra-op thread a process keeps the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jloss(res):
    return jnp.sum(res.us ** 2) + jnp.sum(res.u_final ** 2)


def tloss(res):
    return (res.us ** 2).sum() + (res.u_final ** 2).sum()


def jgrad(jprob, u0s, ps, **kw):
    """(loss, dL/du0s, dL/dps, result) of the reference's adjoint."""
    N = u0s.shape[0]

    def L(u, p):
        res = jsolve(JEP(jprob, N, u0s=u, ps=p), sensitivity="adjoint", **kw)
        return jloss(res), res

    (v, res), g = jax.value_and_grad(L, argnums=(0, 1), has_aux=True)(
        jnp.asarray(u0s), jnp.asarray(ps))
    return float(v), np.asarray(g[0]), np.asarray(g[1]), res


def tgrad(tprob, u0s, ps, **kw):
    """The same through the port."""
    u = torch.tensor(u0s, requires_grad=True)
    p = torch.tensor(ps, requires_grad=True)
    res = tsolve(TEP(tprob, u.shape[0], u0s=u, ps=p), sensitivity="adjoint",
                 device="cpu", **kw)
    L = tloss(res)
    gu, gp = torch.autograd.grad(L, (u, p))
    return float(L.detach()), gu.numpy(), gp.numpy(), res


def assert_grads(got, want, *, rtol, atol=0.0, counts=True):
    if counts:
        np.testing.assert_array_equal(got[3].naccept.numpy(),
                                      np.asarray(want[3].naccept))
        np.testing.assert_array_equal(got[3].nreject.numpy(),
                                      np.asarray(want[3].nreject))
    assert int(got[3].status) == 0
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# erk: adaptive and fixed dt
# ---------------------------------------------------------------------------

def lorenz_inputs(N=4):
    rng = np.random.default_rng(0)
    u0s = np.array([-8.0, 7.0, 27.0]) + 0.1 * rng.standard_normal((N, 3))
    ps = (np.array([10.0, 28.0, 8.0 / 3.0])
          + 0.05 * rng.standard_normal((N, 3)))
    return u0s, ps


LORENZ_KW = dict(t0=0.0, tf=1.5, dt0=1e-2, rtol=1e-8, atol=1e-8)
LORENZ_SAVEAT = np.linspace(0.0, 1.5, 4)


@functools.cache
def lorenz_case(alg):
    u0s, ps = lorenz_inputs()
    tprob = tdp.lorenz_problem(torch.float64)
    kw = dict(LORENZ_KW, alg=alg)
    bound = suggest_adjoint_steps(
        convert.ensemble_problem(tprob, u0s, ps), device="cpu",
        saveat=torch.tensor(LORENZ_SAVEAT), **kw)
    want = jgrad(jdp.lorenz_problem(jnp.float64), u0s, ps,
                 ensemble="kernel", backend="xla", adjoint_steps=bound,
                 saveat=jnp.asarray(LORENZ_SAVEAT), **kw)
    return u0s, ps, tprob, dict(kw, adjoint_steps=bound,
                                saveat=torch.tensor(LORENZ_SAVEAT)), want


@pytest.mark.parametrize("alg,route", [("tsit5", KT), ("tsit5", KC),
                                       ("dopri5", KC)])
def test_erk_adaptive_grad_matches_reference(alg, route):
    u0s, ps, tprob, kw, want = lorenz_case(alg)
    got = tgrad(tprob, u0s, ps, ensemble=route[0], backend=route[1], **kw)
    assert_grads(got, want, rtol=REL, atol=ABS)


@functools.cache
def fixed_case():
    u0s, ps = lorenz_inputs()
    kw = dict(alg="tsit5", t0=0.0, tf=1.0, dt0=0.01, adaptive=False,
              n_steps=100, save_every=25)
    want = jgrad(jdp.lorenz_problem(jnp.float64), u0s, ps,
                 ensemble="kernel", backend="xla", **kw)
    return u0s, ps, kw, want


@pytest.mark.parametrize("route", [KT, KC])
def test_erk_fixed_dt_grad_matches_reference(route):
    """Fixed dt on the kernel strategy's save_every grid: the step loop
    checkpointed (`solve_fixed(remat=True)`) on kernel/torch, the lanes
    loop at adaptive=False with n_steps + 1 bounded iterations in the
    kernel's replay."""
    u0s, ps, kw, want = fixed_case()
    got = tgrad(tdp.lorenz_problem(torch.float64), u0s, ps,
                ensemble=route[0], backend=route[1], **kw)
    assert_grads(got, want, rtol=FIXED_TOL, counts=False)


# ---------------------------------------------------------------------------
# rosenbrock: Van der Pol without a Jacobian hook, ROBER with one
# ---------------------------------------------------------------------------

@functools.cache
def vdp_case():
    N = 3
    u0s = np.tile([2.0, 0.0], (N, 1))
    ps = np.linspace(4.0, 6.0, N)[:, None]
    # the reference's case (tests/test_grad_parity.py:153)
    kw = dict(alg="rosenbrock23", t0=0.0, tf=2.0, dt0=1e-3, rtol=1e-7,
              atol=1e-9)
    sv = np.linspace(0.0, 2.0, 3)
    tprob = tdp.vdp_problem()
    bound = suggest_adjoint_steps(convert.ensemble_problem(tprob, u0s, ps),
                                  device="cpu", saveat=torch.tensor(sv), **kw)
    want = jgrad(jdp.vdp_problem(), u0s, ps, ensemble="kernel",
                 backend="xla", adjoint_steps=bound, saveat=jnp.asarray(sv),
                 **kw)
    return u0s, ps, tprob, dict(kw, adjoint_steps=bound,
                                saveat=torch.tensor(sv)), want


@pytest.mark.parametrize("route", [KC])
def test_rosenbrock23_vdp_grad_matches_reference(route):
    u0s, ps, tprob, kw, want = vdp_case()
    assert tprob.jac is None
    got = tgrad(tprob, u0s, ps, ensemble=route[0], backend=route[1], **kw)
    assert_grads(got, want, rtol=REL, atol=ABS)


@functools.cache
def rober_case(w_reuse):
    N = 3
    u0s = np.tile([1.0, 0.0, 0.0], (N, 1))
    ps = np.tile([0.04, 3e7, 1e4], (N, 1)) * np.array([[1.0], [0.8],
                                                       [1.3]])
    kw = dict(alg="rodas5p", t0=0.0, tf=1.0, dt0=1e-6, rtol=1e-6,
              atol=1e-8, w_reuse=w_reuse)
    sv = np.array([0.1, 1.0])
    tprob = tdp.rober_problem()
    bound = suggest_adjoint_steps(convert.ensemble_problem(tprob, u0s, ps),
                                  device="cpu", saveat=torch.tensor(sv), **kw)
    want = jgrad(jdp.rober_problem(), u0s, ps, ensemble="kernel",
                 backend="xla", adjoint_steps=bound, saveat=jnp.asarray(sv),
                 **kw)
    return u0s, ps, tprob, dict(kw, adjoint_steps=bound,
                                saveat=torch.tensor(sv)), want


@pytest.mark.parametrize("w_reuse,route", [(None, KC), (True, KT)])
def test_rodas5p_rober_grad_matches_reference(w_reuse, route):
    u0s, ps, tprob, kw, want = rober_case(w_reuse)
    assert tprob.jac is not None
    got = tgrad(tprob, u0s, ps, ensemble=route[0], backend=route[1], **kw)
    assert_grads(got, want, rtol=ROBER_REL)


# ---------------------------------------------------------------------------
# sde: fixed dt on a noise table and on the counter stream; adaptive on the
# reference's bridge normals
# ---------------------------------------------------------------------------

def gbm_inputs(N=8):
    rng = np.random.default_rng(3)
    u0s = 0.5 + 0.1 * rng.random((N, 3))
    ps = np.array([0.05, 0.2]) + 0.01 * rng.random((N, 2))
    return u0s, ps


SDE_KW = dict(t0=0.0, dt0=1.0 / 32, n_steps=32, save_every=8)


@functools.cache
def sde_fixed_case(alg, table):
    u0s, ps = gbm_inputs()
    z = (np.random.default_rng(5).standard_normal((32, 3, 8))
         if table else None)
    kw = dict(SDE_KW, alg=alg, seed=7)
    want = jgrad(jdp.gbm_problem(r=0.05, v=0.2, dtype=jnp.float64), u0s,
                 ps, ensemble="kernel", backend="xla",
                 noise_table=None if z is None else jnp.asarray(z), **kw)
    if z is not None:
        kw["noise_table"] = convert.noise_table(z)
    return u0s, ps, kw, want


@pytest.mark.parametrize("alg,table,route", [
    ("em", True, VM), ("em", True, KT), ("em", True, KC),
    ("platen_w2", True, KC), ("em", False, KC)])
def test_sde_fixed_grad_matches_reference(alg, table, route):
    u0s, ps, kw, want = sde_fixed_case(alg, table)
    got = tgrad(tdp.gbm_problem(r=0.05, v=0.2, dtype=torch.float64), u0s,
                ps, ensemble=route[0], backend=route[1], **kw)
    if table:
        assert_grads(got, want, rtol=FIXED_TOL, counts=False)
        return
    np.testing.assert_allclose(got[0], want[0], rtol=RNG_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RNG_TOL)
    assert np.abs(got[2] - want[2]).max() <= RNG_TOL * np.abs(want[2]).max()


_ref_normals = jax.jit(jrng.bridge_normals, static_argnums=(0,))


def ref_normals(seed, node, lane, row, dtype=torch.float32):
    shape = torch.broadcast_shapes(node.shape, lane.shape, row.shape)
    args = [jnp.asarray(x.expand(shape).numpy().astype(np.uint32))
            for x in (node, lane, row)]
    return torch.from_numpy(np.array(_ref_normals(seed, *args))).to(dtype)


@functools.cache
def sde_adaptive_case(est):
    u0s, ps = gbm_inputs(6)
    kw = dict(alg="em", t0=0.0, tf=1.0, dt0=0.05, adaptive=True, rtol=1e-3,
              atol=1e-5, seed=11, error_est=est)
    sv = np.array([0.5, 1.0])
    jres = jsolve(JEP(jdp.gbm_problem(r=0.05, v=0.2, dtype=jnp.float64), 6,
                      u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
                  ensemble="kernel", backend="xla", saveat=jnp.asarray(sv),
                  **kw)
    bound = int(np.max(np.asarray(jres.naccept + jres.nreject))) + 4
    want = jgrad(jdp.gbm_problem(r=0.05, v=0.2, dtype=jnp.float64), u0s, ps,
                 ensemble="kernel", backend="xla", adjoint_steps=bound,
                 saveat=jnp.asarray(sv), **kw)
    return u0s, ps, dict(kw, adjoint_steps=bound,
                         saveat=torch.tensor(sv)), want


@pytest.mark.parametrize("est,route", [("embedded", KT), ("embedded", KC),
                                       ("doubling", KC)])
def test_sde_adaptive_grad_matches_reference(est, route, monkeypatch):
    u0s, ps, kw, want = sde_adaptive_case(est)
    monkeypatch.setattr(trng, "bridge_normals", ref_normals)
    got = tgrad(tdp.gbm_problem(r=0.05, v=0.2, dtype=torch.float64), u0s,
                ps, ensemble=route[0], backend=route[1], **kw)
    assert_grads(got, want, rtol=FIXED_TOL)


# ---------------------------------------------------------------------------
# gradients with respect to table values, on every port route
# ---------------------------------------------------------------------------

@functools.cache
def table_case():
    jprob = jdp.forced_oscillator_problem(dtype=jnp.float64)
    N = 8
    u0s = np.stack([np.asarray(jprob.u0)] * N) * np.linspace(
        0.5, 1.5, N)[:, None]
    ps = np.stack([np.asarray(jprob.p)] * N)
    tab = jprob.data["force"]
    kw = dict(alg="tsit5", adaptive=False, dt0=0.01, adjoint_steps=520)
    sv = np.linspace(1.0, 5.0, 5)

    def L(vals):
        p2 = dataclasses.replace(
            jprob, data={"force": JTable(vals, tab.x0, tab.dx)})
        r = jsolve(JEP(p2, N, u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
                   ensemble="kernel", backend="xla", sensitivity="adjoint",
                   saveat=jnp.asarray(sv), **kw)
        return jloss(r)

    g = np.asarray(jax.grad(L)(tab.values))
    return u0s, ps, np.asarray(tab.values), float(tab.x0), float(tab.dx), \
        dict(kw, saveat=torch.tensor(sv)), g


@pytest.mark.parametrize("route", [VM, ("array", "torch"), KC])
def test_grad_wrt_table_values_matches_reference(route):
    from repro_torch.core.interp import UniformTable1D
    u0s, ps, vals, x0, dx, kw, want = table_case()
    v = torch.tensor(vals, requires_grad=True)
    prob = dataclasses.replace(
        tdp.forced_oscillator_problem(),
        data={"force": UniformTable1D(v, x0, dx)})
    res = tsolve(TEP(prob, u0s.shape[0], u0s=torch.tensor(u0s),
                     ps=torch.tensor(ps)), ensemble=route[0],
                 backend=route[1], sensitivity="adjoint", device="cpu", **kw)
    g, = torch.autograd.grad(tloss(res), v)
    np.testing.assert_allclose(g.numpy(), want, atol=1e-10)


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

J_HALF = JEvent(condition=lambda u, p, t: u[0] - 0.5, terminal=True,
                direction=-1)
J_BARRIER = JEvent(condition=lambda u, p, t: u[0] - 0.18, terminal=True,
                   direction=1)


@functools.cache
def decay_event_case():
    lams = np.array([[0.4], [0.7], [1.3]])
    u0s = np.ones((3, 1))
    kw = dict(alg="tsit5", t0=0.0, tf=3.0, dt0=0.01, rtol=1e-10,
              atol=1e-10)
    sv = np.array([0.5, 1.0, 3.0])
    tprob = tdp.linear_decay_problem()
    bound = suggest_adjoint_steps(
        convert.ensemble_problem(tprob, u0s, lams), device="cpu",
        saveat=torch.tensor(sv), event=tdp.half_event(), **kw)
    want = jgrad(jdp.linear_decay_problem(), u0s, lams, ensemble="kernel",
                 backend="xla", adjoint_steps=bound, event=J_HALF,
                 saveat=jnp.asarray(sv), **kw)
    return u0s, lams, tprob, dict(kw, adjoint_steps=bound,
                                  saveat=torch.tensor(sv)), want


@pytest.mark.parametrize("route", [KT, KC])
def test_grad_with_terminal_event_matches_reference(route):
    u0s, ps, tprob, kw, want = decay_event_case()
    got = tgrad(tprob, u0s, ps, ensemble=route[0], backend=route[1],
                event=tdp.half_event(), **kw)
    assert_grads(got, want, rtol=REL, atol=ABS)
    # the located event time carries no gradient
    assert not got[3].t_final.requires_grad


@functools.cache
def barrier_case():
    N = 10
    u0s = np.full((N, 3), 0.1)
    ps = np.tile([1.5, 0.2], (N, 1))
    z = np.random.default_rng(9).standard_normal((40, 3, N))
    kw = dict(alg="em", t0=0.0, dt0=0.025, n_steps=40, save_every=10)
    want = jgrad(jdp.gbm_problem(r=1.5, v=0.2, dtype=jnp.float64), u0s, ps,
                 ensemble="kernel", backend="xla", event=J_BARRIER,
                 noise_table=jnp.asarray(z), **kw)
    return u0s, ps, dict(kw, noise_table=convert.noise_table(z)), want


@pytest.mark.parametrize("route", [VM, KC])
def test_sde_grad_with_barrier_event_matches_reference(route):
    u0s, ps, kw, want = barrier_case()
    got = tgrad(tdp.gbm_problem(r=1.5, v=0.2, dtype=torch.float64), u0s, ps,
                ensemble=route[0], backend=route[1],
                event=tdp.gbm_barrier_event(), **kw)
    assert_grads(got, want, rtol=FIXED_TOL, counts=False)
    np.testing.assert_array_equal(got[3].naccept.numpy(),
                                  np.asarray(want[3].naccept))
