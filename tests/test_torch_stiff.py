"""The port's stiff family against the reference's (`repro.core.rosenbrock`,
`repro.core.controller`'s lazy-W policy, `repro.configs.de_problems`'
stiff problems), in float64, and the CUDA source's Rosenbrock constants
against the port's tableaus.  The ROBER front-door parity is
tests/test_torch_stiff_rober.py; the kernel itself needs the card:
tests/test_torch_cuda.py.

Bars: building blocks within 1e-12; whole solves with per-lane
naccept/nreject equal to the reference's and states within the reference's
ROBER bar (rtol 1e-6, atol 1e-14)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import controller as jctl
from repro.core import ensemble as jens
from repro.core import events as jev
from repro.core import rosenbrock as jrb
from repro.core import tableaus as jtab
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem
from repro_torch.core import controller as tctl
from repro_torch.core import events as tev
from repro_torch.core import rosenbrock as trb
from repro_torch.core import tableaus as ttab
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.methods import MethodSpec, get_method

CU = (Path(__file__).resolve().parents[1]
      / "src/repro_torch/csrc/rosenbrock_ensemble.cu").read_text()
NAMES = ["rosenbrock23", "rodas4", "rodas5p"]
TOL = 1e-12


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# tableaus: the new property and the CUDA constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_fnew_from_last_stage_and_nf_per_step_match(name):
    j, t = (jtab.get_rosenbrock_tableau(name),
            ttab.get_rosenbrock_tableau(name))
    assert t.fnew_from_last_stage == j.fnew_from_last_stage
    assert t.fnew_from_last_stage == (name == "rosenbrock23")
    assert trb.rosenbrock_nf_per_step(t) == jrb.rosenbrock_nf_per_step(j)


def _cu_values(struct, fn):
    body = CU.split(f"struct {struct} {{", 1)[1].split("\n};", 1)[0]
    block = body.split(f"static constexpr double {fn}(", 1)[1]
    block = block.split("= {", 1)[1].split("};", 1)[0]
    return np.array([float(x) for x in
                     re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?", block)])


def _cu_scalar(struct, what):
    body = CU.split(f"struct {struct} {{", 1)[1].split("\n};", 1)[0]
    return re.search(rf"static constexpr \w+ {what} = ([^;]+);", body).group(1)


@pytest.mark.parametrize("struct,name", [("Ros23w", "rosenbrock23"),
                                         ("Rodas4", "rodas4"),
                                         ("Rodas5p", "rodas5p")])
def test_cuda_kernel_constants_equal_tableau(struct, name):
    """The kernel's compiled-in coefficients, the products γ·C and γ·d it
    folds, and its flags are the tableau's, bit for bit."""
    tab = ttab.get_rosenbrock_tableau(name)
    g = float(tab.gamma)
    assert float(_cu_scalar(struct, "gamma")) == g
    for fn, want in (("a", tab.a.ravel()), ("C", tab.C.ravel()),
                     ("gC", (g * tab.C).ravel()), ("b", tab.b),
                     ("btilde", tab.btilde), ("c", tab.c), ("d", tab.d),
                     ("gd", g * tab.d)):
        np.testing.assert_array_equal(_cu_values(struct, fn), want, fn)
    if tab.interp_h is None:
        assert int(_cu_scalar(struct, "n_interp")) == 0
    else:
        np.testing.assert_array_equal(_cu_values(struct, "h"),
                                      tab.interp_h.ravel())
        assert int(_cu_scalar(struct, "n_interp")) == tab.interp_h.shape[0]
    assert int(_cu_scalar(struct, "stages")) == tab.stages
    assert _cu_scalar(struct, "fnew_from_last_stage") == \
        str(tab.fnew_from_last_stage).lower()


# ---------------------------------------------------------------------------
# controller: the lazy-W policy
# ---------------------------------------------------------------------------

def test_w_reuse_policy_and_helpers_match():
    assert tuple(tctl.WReusePolicy()) == tuple(jctl.WReusePolicy())
    assert tctl.WReusePolicy._fields == jctl.WReusePolicy._fields
    rng = np.random.default_rng(3)
    B = 64
    dt = 10.0 ** rng.uniform(-6, -1, B)
    dt_fact = dt * (1.0 + rng.choice([0.0, 1e-3, 0.05, -0.05], B))
    stale = rng.random(B) < 0.3
    accept = rng.random(B) < 0.7
    fresh = rng.random(B) < 0.5
    enorm = rng.uniform(0.0, 1.5, B)
    enorm[::9] = np.nan
    enorm_prev = rng.uniform(0.01, 1.0, B)
    age = rng.integers(0, 25, B).astype(np.int32)
    for pol_j, pol_t in ((jctl.WReusePolicy(), tctl.WReusePolicy()),
                         (jctl.WReusePolicy(secant=0.0, max_age=10,
                                            growth=2.0),
                          tctl.WReusePolicy(secant=0.0, max_age=10,
                                            growth=2.0))):
        for gam in (0.25, 0.21193756319429014):
            want = jctl.w_refresh(pol_j, gam, jnp.asarray(dt),
                                  jnp.asarray(dt_fact), jnp.asarray(stale))
            got = tctl.w_refresh(pol_t, gam, _t(dt), _t(dt_fact),
                                 torch.from_numpy(stale))
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        want = jctl.w_mark_stale(pol_j, jnp.asarray(accept),
                                 jnp.asarray(enorm), jnp.asarray(enorm_prev),
                                 jnp.asarray(age), jnp.asarray(fresh))
        got = tctl.w_mark_stale(pol_t, torch.from_numpy(accept), _t(enorm),
                                _t(enorm_prev), torch.from_numpy(age),
                                torch.from_numpy(fresh))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jctl.w_dt_blame(jnp.asarray(accept), jnp.asarray(fresh),
                           jnp.asarray(dt), jnp.asarray(dt_fact))
    got = tctl.w_dt_blame(torch.from_numpy(accept), torch.from_numpy(fresh),
                          _t(dt), _t(dt_fact))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lanes", [False, True])
def test_hermite_interp_matches(lanes):
    rng = np.random.default_rng(4)
    n, B = 3, 8
    u0, f0, u1, f1 = (rng.standard_normal((n, B)) for _ in range(4))
    if lanes:
        dt, th = rng.uniform(0.1, 1.0, B), rng.uniform(0.0, 1.0, B)
    else:
        dt, th = rng.uniform(0.1, 1.0, (1, B)), rng.uniform(0.0, 1.0, (1, B))
    want = jev.hermite_interp(*(jnp.asarray(x) for x in
                                (u0, f0, u1, f1, dt, th)), lanes=lanes)
    got = tev.hermite_interp(*(_t(x) for x in (u0, f0, u1, f1, dt, th)),
                             lanes=lanes)
    _close(got.numpy(), want)


def test_secant_update_matches():
    rng = np.random.default_rng(5)
    B, n = 16, 3
    J = rng.standard_normal((B, n, n))
    du = rng.standard_normal((n, B)) * 1e-3
    du[:, 3] = 0.0                  # Δu = 0: no update
    dF = rng.standard_normal((n, B))
    dF[0, 5] = np.inf               # a non-finite correction: no update
    mask = rng.random(B) < 0.8
    want = jrb._secant_update(jnp.asarray(J), jnp.asarray(du),
                              jnp.asarray(dF), 2.0, jnp.asarray(mask), True)
    got = trb._secant_update(_t(J), _t(du), _t(dF), 2.0,
                             torch.from_numpy(mask))
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[3], J[3])
    np.testing.assert_array_equal(got.numpy()[5], J[5])


# ---------------------------------------------------------------------------
# one step, and the Jacobians
# ---------------------------------------------------------------------------

def _rober_state(B=6, seed=6):
    rng = np.random.default_rng(seed)
    u = np.stack([rng.uniform(0.5, 1.0, B), rng.uniform(0.0, 3.6e-5, B),
                  rng.uniform(0.0, 0.5, B)])
    p = np.stack([rng.uniform(0.01, 0.1, B), np.full(B, 3e7),
                  np.full(B, 1e4)])
    return u, p, rng.uniform(0.0, 10.0, B), 10.0 ** rng.uniform(-6, 0, B)


@pytest.mark.parametrize("linsolve", [("jnp", "torch"), ("lanes", "lanes"),
                                      ("pallas", "cuda")],
                         ids=lambda v: v[1])
@pytest.mark.parametrize("name", NAMES)
def test_rosenbrock_step_matches(name, linsolve):
    """One lanes-mode step on ROBER states, with the analytic Jacobian, on
    every linear-solve route."""
    jl, tl = linsolve
    u, p, t, dt = _rober_state()
    want = jrb.rosenbrock_step(jdp.rober_rhs, jtab.get_rosenbrock_tableau(
        name), jnp.asarray(u), jnp.asarray(p), jnp.asarray(t),
        jnp.asarray(dt), lanes=True, linsolve=jl, jac=jdp.rober_jac)
    got = trb.rosenbrock_step(tdp.rober_rhs, ttab.get_rosenbrock_tableau(
        name), _t(u), _t(p), _t(t), _t(dt), linsolve=tl, jac=tdp.rober_jac)
    for g_, w_ in zip(got[:4], want[:4]):
        assert (g_ is None) == (w_ is None)
        if w_ is not None:
            _close(g_.numpy(), w_)
    assert len(got[4]) == len(want[4])
    for g_, w_ in zip(got[4], want[4]):
        _close(g_.numpy(), w_)


@pytest.mark.parametrize("name,expected", [("rosenbrock23", 2),
                                           ("rodas4", 4), ("rodas5p", 5)])
def test_rosenbrock_step_converges_at_its_order(name, expected):
    """u' = λ(u − sin t) + cos t, u = sin t: non-autonomous, so the c and d
    coefficients and the f_t term of the stage loop are exercised; the
    slopes of tests/test_stiff.py's convergence test."""
    rtab = ttab.get_rosenbrock_tableau(name)
    p = _t([[-5.0]])

    def f(u, p_, t):
        return p_[0] * (u - torch.sin(t)) + torch.cos(t)

    def endpoint_err(n):
        u, t, dt = _t([[0.0]]), _t([0.0]), _t([1.5 / n])
        for _ in range(n):
            u = trb.rosenbrock_step(f, rtab, u, p, t, dt)[0]
            t = t + dt
        return abs(float(u[0, 0]) - np.sin(1.5))

    errs = [endpoint_err(n) for n in (20, 40, 80)]
    slopes = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(slopes) > expected - 0.35, (errs, slopes)


def test_analytic_jacobians_match_jacfwd_and_the_reference():
    u, p, t, _ = _rober_state()
    J = tdp.rober_jac(_t(u), _t(p), _t(t))
    _close(J.numpy(), np.asarray(jdp.rober_jac(jnp.asarray(u),
                                               jnp.asarray(p), t)))
    J_ad = trb._jac_lanes(tdp.rober_rhs, _t(u), _t(p), _t(t))
    _close(J.movedim(-1, 0).numpy(), J_ad.numpy())
    # jacfwd of the other problems against the reference's
    for jf, tf_, uu, pp in ((jdp.orego_rhs, tdp.orego_rhs,
                             np.array([[1.0, 2.0], [2.0, 0.5], [3.0, 1.0]]),
                             np.array([[77.27] * 2, [8.375e-6] * 2,
                                       [0.161] * 2])),
                            (jdp.vdp_rhs, tdp.vdp_rhs,
                             np.array([[2.0, -1.0], [0.0, 0.7]]),
                             np.array([[10.0, 5.0]]))):
        want = jrb._jac_lanes(jf, jnp.asarray(uu), jnp.asarray(pp),
                              jnp.zeros(2))
        got = trb._jac_lanes(tf_, _t(uu), _t(pp), torch.zeros(2,
                                                              dtype=torch.float64))
        _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# problems, and whole solves beside ROBER
# ---------------------------------------------------------------------------

def test_stiff_problem_constructors_match():
    for k in (1, 5):
        ej, et = jdp.rober_ensemble(k), tdp.rober_ensemble(k)
        for a, b in zip(et.materialize(), ej.materialize()):
            _close(a.numpy(), b, tol=1e-15)
    assert tdp.rober_problem().jac is tdp.rober_jac
    assert tdp.rober_problem(analytic_jac=False).jac is None
    vj, vt = jdp.vdp_ensemble(4), tdp.vdp_ensemble(4)
    _close(vt.materialize()[1].numpy(), vj.materialize()[1], tol=1e-15)
    for jp, tp in ((jdp.orego_problem(), tdp.orego_problem()),
                   (jdp.vdp_problem(), tdp.vdp_problem())):
        np.testing.assert_array_equal(tp.u0.numpy(), np.asarray(jp.u0))
        np.testing.assert_array_equal(tp.p.numpy(), np.asarray(jp.p))
        assert tp.tspan == jp.tspan and tp.name == jp.name


@pytest.mark.parametrize("case", ["orego-rodas5p", "vdp-rodas4",
                                  "vdp-rodas4-lazy"])
def test_other_stiff_problems_match_reference(case):
    """OREGO on rodas5p (jacfwd on both sides) and Van der Pol on rodas4
    through the front doors, kernel strategy: per-lane counts equal, states
    within the ROBER bar."""
    if case.startswith("orego"):
        jp, tp, alg = (jdp.orego_problem(tspan=(0.0, 2.0)),
                       tdp.orego_problem(tspan=(0.0, 2.0)), "rodas5p")
        u0s = np.array([[1.0, 2.0, 3.0], [1.5, 1.0, 2.0]])
        ps = np.tile(np.asarray(jp.p), (2, 1))
        kw = dict(dt0=1e-4, rtol=1e-7, atol=1e-8,
                  saveat=np.linspace(0.0, 2.0, 5))
    else:
        jp, tp, alg = jdp.vdp_problem(), tdp.vdp_problem(), "rodas4"
        u0s, ps = (np.asarray(x) for x in jdp.vdp_ensemble(3).materialize())
        kw = dict(dt0=1e-3, rtol=1e-6, atol=1e-6,
                  saveat=np.linspace(0.0, 1.0, 5),
                  w_reuse=case.endswith("lazy"))
    want = jens.solve_ensemble_local(
        jens.EnsembleProblem(jp, len(u0s), u0s=jnp.asarray(u0s),
                             ps=jnp.asarray(ps)),
        alg=alg, ensemble="kernel", backend="xla", **kw)
    for backend in ("torch", "cuda"):
        got = tsolve(ensemble_problem(tp, u0s, ps), alg=alg,
                     ensemble="kernel", backend=backend, device="cpu", **kw)
        np.testing.assert_array_equal(got.naccept.numpy(),
                                      np.asarray(want.naccept))
        np.testing.assert_array_equal(got.nreject.numpy(),
                                      np.asarray(want.nreject))
        assert int(got.status) == 0 and int(got.njac) == int(want.njac)
        np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us),
                                   rtol=1e-6, atol=1e-14)


# ---------------------------------------------------------------------------
# argument checks and the dispatch rules
# ---------------------------------------------------------------------------

def test_stiff_dispatch_rules_and_errors():
    from repro_torch.core.methods import valid_dispatch
    ens = tdp.rober_ensemble(2, tspan=(0.0, 1.0))
    kw = dict(dt0=1e-6, device="cpu")
    rodas4 = get_method("rodas4")
    assert get_method(ttab.RODAS4).rtableau is ttab.RODAS4
    assert get_method(ttab.RODAS4).family == "rosenbrock"
    with pytest.raises(ValueError, match="rtableau"):
        MethodSpec(name="bad_rb", family="rosenbrock", order=3)
    no_pair = ttab.RODAS4._replace(name="rodas4_nopair",
                                   btilde=np.zeros_like(ttab.RODAS4.btilde))
    assert not get_method(no_pair).adaptive
    with pytest.raises(ValueError, match="btilde"):
        tsolve(ens, alg=no_pair, ensemble="vmap", **kw)
    with pytest.raises(NotImplementedError, match="item 7"):
        tsolve(ens, alg="rodas4", event=object(), **kw)
    with pytest.raises(ValueError, match="w_reuse"):
        tsolve(ens, alg="tsit5", w_reuse=True, **kw)
    with pytest.raises(ValueError, match="linsolve"):
        tsolve(ens, alg="rodas4", linsolve="jnp", **kw)
    with pytest.raises(NotImplementedError, match="array_eager"):
        tsolve(ens, alg="rodas4", ensemble="array_eager", **kw)
    with pytest.raises(ValueError, match="backend"):
        tsolve(ens, alg="rodas4", backend="pallas", **kw)
    u0s, ps = ens.materialize()
    with pytest.raises(NotImplementedError, match="item 9"):
        trb.solve_rosenbrock(tdp.rober_rhs, ttab.RODAS4, u0s[0], ps[0], 0.0,
                             1.0, 1e-6, lanes=False)
    with pytest.raises(NotImplementedError, match="item 9"):
        trb.solve_rosenbrock(tdp.rober_rhs, ttab.RODAS4, u0s.T, ps.T, 0.0,
                             1.0, 1e-6, bounded_steps=100)
    assert valid_dispatch(rodas4, "kernel", "cuda", w_reuse=True)[0]
    assert not valid_dispatch(rodas4, "array_eager")[0]
    assert not valid_dispatch(get_method("tsit5"), "kernel", w_reuse=True)[0]
    assert not valid_dispatch(get_method(no_pair), "kernel")[0]
    # w_reuse=False stays a no-op for every family
    res = tsolve(ens, alg="tsit5", tf=1e-3, dt0=1e-5, w_reuse=False,
                 device="cpu")
    assert int(res.status) == 0


def test_dt0_none_takes_initial_dt_and_counts_its_probes():
    ens = tdp.rober_ensemble(2, tspan=(0.0, 1.0))
    jens_ = jdp.rober_ensemble(2, tspan=(0.0, 1.0))
    got = tsolve(ens, alg="rodas5p", dt0=None, rtol=1e-6, atol=1e-8,
                 device="cpu")
    want = jens.solve_ensemble_local(jens_, alg="rodas5p", dt0=None,
                                     rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    assert int(got.nf) == int(want.nf)
    np.testing.assert_allclose(got.u_final.numpy(), np.asarray(want.u_final),
                               rtol=1e-6, atol=1e-14)


def test_kernel_wrapper_plain_version_and_controller_constants():
    """On CPU tensors the kernel's wrapper runs the lanes engine with the
    inline LU; the constants it would hand the kernel are the engine's."""
    from repro_torch.kernels.rosenbrock import kernel as rk
    rtab = ttab.RODAS5P
    c = rk.controller_constants(rtab, True)
    ctrl = tctl.PIController.for_order(4)
    assert c[:7] == (ctrl.beta1, ctrl.beta2, ctrl.safety, ctrl.qmin,
                     ctrl.qmax, ctrl.dtmin, ctrl.dtmax)
    assert c[7:] == tuple(float(v) for v in tctl.WReusePolicy())
    assert rk.controller_constants(rtab, None)[7:] == (0.0,) * 5
    ens = tdp.rober_ensemble(3, tspan=(0.0, 1.0))
    u0s, ps = ens.materialize()
    sv = _t([0.5, 1.0])
    us, uf, tfin, stats = rk.rosenbrock_ensemble(
        tdp.rober_rhs, rtab, u0s.T.contiguous(), ps.T.contiguous(), sv,
        jac=tdp.rober_jac, t0=0.0, tf=1.0, dt0=1e-6, rtol=1e-6, atol=1e-8,
        max_iters=100_000, w_reuse=None)
    res = trb.solve_rosenbrock(tdp.rober_rhs, rtab, u0s.T, ps.T, 0.0, 1.0,
                               1e-6, rtol=1e-6, atol=1e-8, saveat=sv,
                               linsolve="lanes", jac=tdp.rober_jac)
    assert torch.equal(us, res.us) and torch.equal(uf, res.u_final)
    assert stats.dtype == torch.int32 and tuple(stats.shape) == (6, 3)
    assert torch.equal(stats[4], stats[0] + stats[1])   # eager: njac
