"""`kernel_adjoint` (`repro_torch.kernels.ensemble_kernel`) on the CPU,
where ``backend="cuda"`` runs the kernels' plain versions as the forward
solve — as the reference's tests run its Pallas kernels in interpret mode —
and the refusals of the gradient front door, in float64.

  * The primal under ``sensitivity="adjoint"`` equals the same solve
    without it, bit for bit, on every family (erk adaptive and fixed dt,
    rosenbrock eager and lazy W, fixed-dt and adaptive SDE, a data-driven
    problem).
  * Its gradient equals autograd through the bounded plain version (the
    ``"torch"`` backend's lanes path with the same bound), bit for bit.
  * The statistics and ``t_final`` carry no gradient; table values receive
    one.
  * A launch refuses an input that requires grad outside `kernel_adjoint`
    (the reference's `jax.grad` fails on a bare `pallas_call`).
  * A bound too small on the kernel path: the reference's Pallas path
    reports the kernel's status (0) and differentiates the truncated
    replay; the port does the same (ROADMAP queue 3).
  * The CRN sweep's NaN lanes (about 2% by design) leave the other lanes'
    gradients finite and equal to a solve without them.
  * Every refusal the reference makes, matched by message.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.methods import get_method as jget
from repro.core.methods import valid_dispatch as jvalid
from repro.core.problem import EnsembleProblem as JEP
from repro_torch import convert
from repro_torch.configs import de_problems as tdp
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.interp import UniformTable1D
from repro_torch.core.methods import get_method, valid_dispatch
from repro_torch.core.problem import EnsembleProblem as TEP
from repro_torch.core.sensitivity import suggest_adjoint_steps
from repro_torch.kernels.tsit5 import kernel as k1



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The inputs are a few lanes: one intra-op thread a process keeps the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lorenz(N=4):
    rng = np.random.default_rng(0)
    u0s = np.array([-8.0, 7.0, 27.0]) + 0.1 * rng.standard_normal((N, 3))
    ps = np.array([10.0, 28.0, 8.0 / 3.0]) + 0.05 * rng.standard_normal(
        (N, 3))
    return tdp.lorenz_problem(torch.float64), u0s, ps


def gbm(N=6):
    return (tdp.gbm_problem(r=0.05, v=0.2, dtype=torch.float64),
            0.5 + 0.1 * np.random.default_rng(1).random((N, 3)),
            np.tile([0.05, 0.2], (N, 1)))


def rober(N=3):
    return (tdp.rober_problem(), np.tile([1.0, 0.0, 0.0], (N, 1)),
            np.tile([0.04, 3e7, 1e4], (N, 1)) * np.linspace(0.8, 1.2, N)[
                :, None])


SV = lambda *v: torch.tensor(v, dtype=torch.float64)
# (problem factory, solve settings, adaptive) per family
CASES = {
    "erk": (lorenz, dict(alg="tsit5", t0=0.0, tf=1.0, dt0=1e-2, rtol=1e-8,
                         atol=1e-8, saveat=SV(0.5, 1.0)), True),
    "erk-fixed": (lorenz, dict(alg="tsit5", t0=0.0, tf=0.5, dt0=0.01,
                               adaptive=False, n_steps=50, save_every=25),
                  False),
    # the stiff kernel inlines the lanes LU; the replay takes the solve's
    # linsolve, so "lanes" makes the kernel's outputs (the cotangents'
    # base) those of the replay
    "rodas5p": (rober, dict(alg="rodas5p", t0=0.0, tf=10.0, dt0=1e-6,
                            rtol=1e-6, atol=1e-8, linsolve="lanes",
                            saveat=SV(1.0, 10.0)), True),
    "rodas5p-lazy": (rober, dict(alg="rodas5p", t0=0.0, tf=10.0, dt0=1e-6,
                                 rtol=1e-6, atol=1e-8, w_reuse=True,
                                 linsolve="lanes", saveat=SV(1.0, 10.0)),
                     True),
    "em": (gbm, dict(alg="em", t0=0.0, dt0=1.0 / 32, n_steps=32,
                     save_every=8, seed=7), False),
    "em-adaptive": (gbm, dict(alg="em", t0=0.0, tf=1.0, dt0=0.05,
                              adaptive=True, rtol=1e-3, atol=1e-5, seed=11,
                              saveat=SV(0.5, 1.0)), True),
}


def run(case, backend, *, bound=None, sensitivity="adjoint", extra=()):
    make, kw, adaptive = CASES[case]
    prob, u0s, ps = make()
    kw = dict(kw, **dict(extra))
    if adaptive and bound is None and sensitivity == "adjoint":
        bound = suggest_adjoint_steps(convert.ensemble_problem(prob, u0s, ps),
                                      device="cpu", **kw)
    u = torch.tensor(u0s, requires_grad=sensitivity is not None)
    p = torch.tensor(ps, requires_grad=sensitivity is not None)
    res = tsolve(TEP(prob, u.shape[0], u0s=u, ps=p), ensemble="kernel",
                 backend=backend, sensitivity=sensitivity,
                 adjoint_steps=bound, device="cpu", **kw)
    if sensitivity is None:
        return res, None
    L = (res.us ** 2).sum() + (res.u_final ** 2).sum()
    return res, torch.autograd.grad(L, (u, p))


FIELDS = ("ts", "us", "u_final", "t_final", "naccept", "nreject", "nf",
          "status", "njac", "nfact")


def assert_same_result(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if torch.is_tensor(x):
            assert torch.equal(x.detach(), y.detach()), name
        else:
            assert x == y, name


@pytest.mark.parametrize("case", list(CASES))
def test_primal_equals_plain_kernel_solve_bitwise(case):
    adj, _ = run(case, "cuda")
    plain, _ = run(case, "cuda", sensitivity=None)
    assert_same_result(adj, plain)
    assert int(adj.status) == 0
    # only the states carry gradients
    assert adj.us.requires_grad and adj.u_final.requires_grad
    for name in ("t_final", "naccept", "nreject", "nf", "status"):
        assert not getattr(adj, name).requires_grad, name


@pytest.mark.parametrize("case", list(CASES))
def test_grad_equals_bounded_plain_version_bitwise(case):
    """The replay is the torch backend's lanes path with the same bound (for
    fixed-dt erk: the lanes path at adaptive=False on the save grid, which
    an explicit saveat selects)."""
    _, g_cuda = run(case, "cuda")
    extra = ()
    if case == "erk-fixed":
        extra = dict(saveat=SV(0.25, 0.5))
    _, g_torch = run(case, "torch", extra=extra)
    for a, b in zip(g_cuda, g_torch):
        assert torch.equal(a, b)


def test_table_leaves_receive_gradients_bitwise_to_torch_backend():
    prob0 = tdp.forced_oscillator_problem()
    tab = prob0.data["force"]
    N = 4
    u0s = torch.stack([prob0.u0] * N) * torch.linspace(
        0.5, 1.5, N, dtype=torch.float64)[:, None]
    grads = {}
    for backend in ("cuda", "torch"):
        v = tab.values.clone().requires_grad_(True)
        prob = dataclasses.replace(
            prob0, data={"force": UniformTable1D(v, tab.x0, tab.dx)})
        res = tsolve(TEP(prob, N, u0s=u0s), alg="tsit5", ensemble="kernel",
                     backend=backend, adaptive=False, dt0=0.01,
                     saveat=torch.linspace(1.0, 2.0, 3,
                                           dtype=torch.float64),
                     t0=0.0, tf=2.0, sensitivity="adjoint",
                     adjoint_steps=210, device="cpu")
        grads[backend], = torch.autograd.grad((res.us ** 2).sum(), v)
    assert grads["cuda"].abs().max() > 0
    assert torch.equal(grads["cuda"], grads["torch"])


def test_launch_refuses_grad_outside_kernel_adjoint(monkeypatch):
    """The wrapper's entry on the front door's path (`_erk_ensemble`, the
    wrapper without its device-side grid check, the grid being checked on
    the host) is stubbed: a refused call never reaches it, and under
    kernel_adjoint it receives detached inputs with grad disabled."""
    calls = []
    real = k1._erk_ensemble

    def stub(f, tab, u0, p, saveat, **kw):
        calls.append((u0.requires_grad, p.requires_grad,
                      torch.is_grad_enabled()))
        return real(f, tab, u0, p, saveat, **kw)

    monkeypatch.setattr(k1, "_erk_ensemble", stub)
    prob, u0s, ps = lorenz()
    kw = dict(alg="tsit5", t0=0.0, tf=0.2, dt0=1e-2, ensemble="kernel",
              backend="cuda", device="cpu")
    p = torch.tensor(ps, requires_grad=True)
    ep = TEP(prob, 4, u0s=torch.tensor(u0s), ps=p)
    with pytest.raises(ValueError, match='sensitivity="adjoint"'):
        tsolve(ep, **kw)
    assert calls == []
    with torch.no_grad():
        tsolve(ep, **kw)
    res = tsolve(ep, sensitivity="adjoint", adjoint_steps=40, **kw)
    torch.autograd.grad(res.u_final.sum(), p)
    assert calls == [(False, False, False)] * 2
    # the batched LU kernel's path refuses too
    from repro_torch.kernels.lu.ops import batched_solve
    W = torch.eye(2, dtype=torch.float64).repeat(3, 1, 1).requires_grad_()
    with pytest.raises(ValueError, match='sensitivity="adjoint"'):
        batched_solve(W, torch.ones(3, 2, dtype=torch.float64))


def test_too_small_bound_on_kernel_path_keeps_kernel_status():
    """As the reference's Pallas path: the primal (and its status) is the
    kernel's, and the gradient is the vjp of the replay truncated at the
    bound (which the torch backend reports as status 1) with the
    cotangents of the kernel's outputs."""
    adj, g_cuda = run("erk", "cuda", bound=8)
    full, _ = run("erk", "cuda", sensitivity=None)
    assert_same_result(adj, full)
    prob, u0s, ps = lorenz()
    u = torch.tensor(u0s, requires_grad=True)
    p = torch.tensor(ps, requires_grad=True)
    short = tsolve(TEP(prob, 4, u0s=u, ps=p), ensemble="kernel",
                   backend="torch", sensitivity="adjoint", adjoint_steps=8,
                   device="cpu", **CASES["erk"][1])
    assert int(adj.status) == 0 and int(short.status) == 1
    g_short = torch.autograd.grad(
        (short.us, short.u_final), (u, p),
        (2 * adj.us.detach(), 2 * adj.u_final.detach()))
    for a, b in zip(g_cuda, g_short):
        assert torch.equal(a, b)


def test_crn_nan_lanes_leave_other_gradients_finite():
    """About 2% of the CRN sweep's lanes turn NaN by design ((S·sig)^n with
    sig < 0).  Lanes are independent, so a loss over the finite lanes
    differentiates to NaN on the NaN lanes only, and the finite lanes'
    gradients equal those of solves without the NaN lanes (each lane at
    its own global index, `lane_offset`)."""
    N = 64
    u0s, ps = tdp.crn_sweep_arrays(N, 1)
    prob = tdp.crn_problem(dtype=torch.float64)
    kw = dict(alg="em", t0=0.0, dt0=0.1, n_steps=200, save_every=200, seed=1,
              ensemble="kernel", backend="cuda", sensitivity="adjoint",
              device="cpu")

    def grads(lo, hi):
        u = torch.tensor(u0s[lo:hi], requires_grad=True)
        res = tsolve(TEP(prob, hi - lo, u0s=u, ps=torch.tensor(ps[lo:hi])),
                     lane_offset=lo, **kw)
        fin = torch.isfinite(res.u_final).all(dim=1)
        loss = torch.where(fin[:, None], res.u_final, 0.0).pow(2).sum()
        return torch.autograd.grad(loss, u)[0], fin

    g, fin = grads(0, N)
    bad = torch.nonzero(~fin).flatten().tolist()
    assert 0 < len(bad) < N // 5
    assert torch.isfinite(g[fin]).all()
    # every finite lane's gradient equals a solve of that lane alone
    for i in torch.nonzero(fin).flatten().tolist()[:6]:
        gi, _ = grads(i, i + 1)
        assert torch.equal(gi[0], g[i])


# ---------------------------------------------------------------------------
# refusals, matched to the reference's
# ---------------------------------------------------------------------------

LKW = dict(alg="tsit5", t0=0.0, tf=1.5, dt0=1e-2, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("kw,match,ref_kw", [
    (dict(ensemble="array_eager", sensitivity="adjoint"), "array_eager",
     dict(ensemble="array_eager", sensitivity="adjoint")),
    (dict(ensemble="vmap", sensitivity="adjoint"), "adjoint_steps",
     dict(ensemble="vmap", sensitivity="adjoint")),
    (dict(ensemble="vmap", sensitivity="backprop"), "sensitivity",
     dict(ensemble="vmap", sensitivity="backprop")),
    (dict(ensemble="kernel", backend="cuda", sensitivity="forward"),
     "backend='torch'",
     dict(ensemble="kernel", backend="pallas", sensitivity="forward")),
    (dict(ensemble="kernel", alg="rodas5p", sensitivity="adjoint"),
     "adjoint_steps",
     dict(ensemble="kernel", alg="rodas5p", sensitivity="adjoint")),
    (dict(ensemble="kernel", alg="em", adaptive=True,
          sensitivity="adjoint"), "adjoint_steps",
     dict(ensemble="kernel", alg="em", adaptive=True,
          sensitivity="adjoint")),
])
def test_refusals_match_reference(kw, match, ref_kw):
    sde = kw.get("alg") == "em"
    jprob = (jdp.gbm_problem(dtype=jnp.float64) if sde
             else jdp.lorenz_problem(jnp.float64))
    tprob = (tdp.gbm_problem(dtype=torch.float64) if sde
             else tdp.lorenz_problem(torch.float64))
    base = dict(LKW, **({"tf": 1.0} if sde else {}))
    with pytest.raises(ValueError) as want:
        jsolve(JEP(jprob, 2), **dict(base, **ref_kw))
    with pytest.raises(ValueError, match=match) as got:
        tsolve(TEP(tprob, 2), device="cpu", **dict(base, **kw))
    if "pallas" not in str(want.value).lower():
        assert str(got.value) == str(want.value)
    else:
        assert "cuda" in str(got.value).lower()


def test_non_differentiable_method_refused_as_reference():
    spec = dataclasses.replace(get_method("tsit5"), name="nodiff",
                               differentiable=False)
    jspec = dataclasses.replace(jget("tsit5"), name="nodiff",
                                differentiable=False)
    assert spec.sensitivity == () and get_method("tsit5").sensitivity == (
        "forward", "adjoint")
    with pytest.raises(ValueError, match="differentiable=False"):
        tsolve(TEP(tdp.lorenz_problem(torch.float64), 2),
               sensitivity="adjoint", adjoint_steps=10, device="cpu",
               **dict(LKW, alg=spec))
    with pytest.raises(ValueError, match="differentiable=False"):
        jsolve(JEP(jdp.lorenz_problem(jnp.float64), 2),
               **dict(LKW, alg=jspec, sensitivity="adjoint",
                      adjoint_steps=10))


@pytest.mark.parametrize("ensemble,backend,sens", [
    ("vmap", "torch", "adjoint"), ("kernel", "cuda", "adjoint"),
    ("kernel", "cuda", "forward"), ("array_eager", "torch", "adjoint"),
    ("kernel", "torch", "forward"), ("vmap", "torch", "backprop")])
def test_valid_dispatch_sensitivity_rules_match_reference(ensemble, backend,
                                                          sens):
    rb = {"torch": "xla", "cuda": "pallas"}[backend]
    ok, _ = valid_dispatch(get_method("tsit5"), ensemble, backend,
                           sensitivity=sens)
    rok, _ = jvalid(jget("tsit5"), ensemble, rb, sensitivity=sens)
    assert ok == rok
