"""The PyTorch port's explicit-RK building blocks held against `repro`.

Inputs are made once with numpy from a seed and handed to both packages;
the reference runs on the CPU in float64 (tests/conftest.py enables x64).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core import solvers as jsol
from repro.core import tableaus as jtab
from repro.configs.de_problems import lorenz_rhs as j_lorenz
from repro_torch.configs.de_problems import lorenz_rhs as t_lorenz
from repro_torch.core import controller as tctl
from repro_torch.core import solvers as tsol
from repro_torch.core import tableaus as ttab

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
# K1's two translation units: tsit5 and dopri5, and the other six tableaus
CU_FILES = (CSRC / "erk_ensemble.cu", CSRC / "erk_tableaus.cu")


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _lorenz_lanes(B, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(3, B)) * 5.0
    p = np.stack([np.full(B, 10.0), rng.uniform(0, 21, B), np.full(B, 8 / 3)])
    dt = rng.uniform(1e-3, 2e-2, B)
    return u, p, dt


# ---------------------------------------------------------------------------
# tableaus: copied data, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jtab.TABLEAUS))
def test_erk_tableau_data_equal(name):
    j, t = jtab.get_tableau(name), ttab.get_tableau(name)
    for field in ("a", "b", "btilde", "c"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert (t.order, t.embedded_order, t.fsal, t.stages) == \
        (j.order, j.embedded_order, j.fsal, j.stages)
    assert (t.interp_bpoly is None) == (j.interp_bpoly is None)


@pytest.mark.parametrize("name", sorted(jtab.ROSENBROCK_TABLEAUS))
def test_rosenbrock_tableau_data_equal(name):
    j = jtab.get_rosenbrock_tableau(name)
    t = ttab.get_rosenbrock_tableau(name)
    for field in ("a", "C", "b", "btilde", "c", "d"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert (t.gamma, t.order, t.embedded_order) == \
        (j.gamma, j.order, j.embedded_order)
    if j.interp_h is None:
        assert t.interp_h is None
    else:
        np.testing.assert_array_equal(t.interp_h, j.interp_h)


def test_tsit5_bpoly_matches_at_50_thetas():
    theta = np.linspace(0.0, 1.0, 50)
    want = np.asarray(jtab._tsit5_bpoly(jnp.asarray(theta)))
    got = ttab._tsit5_bpoly(_t(theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def _cu_struct(struct):
    """The text of `struct` from whichever of K1's sources defines it."""
    for cu in CU_FILES:
        text = cu.read_text()
        if f"struct {struct} {{" in text:
            return text.split(f"struct {struct} {{", 1)[1].split("\n};", 1)[0]
    raise AssertionError(f"no struct {struct} in {CU_FILES}")


def _cu_array(struct, fn):
    body = _cu_struct(struct)
    block = body.split(f"static constexpr double {fn}(", 1)[1]
    block = block.split("= {", 1)[1].split("};", 1)[0]
    return np.array([float(x) for x in
                     re.findall(r"-?\d+\.\d+(?:e-?\d+)?", block)])


K1_STRUCTS = [("Tsit5", "tsit5"), ("Dopri5", "dopri5"), ("Rkck54", "rkck54"),
              ("Bs3", "bs3"), ("Rkf45", "rkf45"), ("Rk4", "rk4"),
              ("Vern7", "vern7"), ("Gbs10", "gbs10")]


@pytest.mark.parametrize("struct,name", K1_STRUCTS)
def test_cuda_kernel_constants_equal_tableau(struct, name):
    """The kernel's compiled-in coefficients are the tableau's floats, and
    its stage count and FSAL flag the tableau's."""
    tab = ttab.get_tableau(name)
    body = _cu_struct(struct)
    assert f"static constexpr int stages = {tab.stages};" in body
    assert (f"static constexpr bool fsal = {'true' if tab.fsal else 'false'}"
            in body)
    assert ("free_interp = true" in body) == (tab.interp_bpoly is not None)
    np.testing.assert_array_equal(_cu_array(struct, "a"), tab.a.ravel())
    np.testing.assert_array_equal(_cu_array(struct, "b"), tab.b)
    np.testing.assert_array_equal(_cu_array(struct, "btilde"), tab.btilde)
    np.testing.assert_array_equal(_cu_array(struct, "c"), tab.c)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [None, 0])
def test_hairer_norm_matches(dim):
    rng = np.random.default_rng(1)
    err, uo, un = (rng.normal(size=(3, 17)) * s for s in (1e-6, 3.0, 3.0))
    want = jctl.hairer_norm(jnp.asarray(err), jnp.asarray(uo),
                            jnp.asarray(un), 1e-6, 1e-5, axes=dim)
    got = tctl.hairer_norm(_t(err), _t(uo), _t(un), 1e-6, 1e-5, dim=dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


def test_pi_propose_matches_including_nonfinite_and_reject():
    rng = np.random.default_rng(2)
    B = 64
    enorm = rng.uniform(0.0, 3.0, B)
    enorm[:4] = [np.nan, np.inf, 0.0, 1e-14]
    enorm_prev = rng.uniform(1e-3, 1.0, B)
    dt = rng.uniform(1e-12, 1e-1, B)
    dt[5] = 1e-13
    accept = (enorm <= 1.0) & rng.integers(0, 2, B).astype(bool)
    for order in (2, 4, 6):
        jc, tc = jctl.PIController.for_order(order), \
            tctl.PIController.for_order(order)
        assert tuple(jc) == tuple(tc)
        jd, je = jctl.pi_propose(jc, jnp.asarray(dt), jnp.asarray(enorm),
                                 jnp.asarray(enorm_prev), jnp.asarray(accept))
        td, te = tctl.pi_propose(tc, _t(dt), _t(enorm), _t(enorm_prev),
                                 torch.from_numpy(accept))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-15)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-15)


def test_initial_dt_matches_per_trajectory():
    u, p, _ = _lorenz_lanes(9, seed=3)
    for atol, rtol in ((1e-6, 1e-6), (1e-10, 1e-8)):
        got = tctl.initial_dt(t_lorenz, _t(u), _t(p), 0.0, 1.0, 5, atol, rtol)
        for b in range(u.shape[1]):
            want = jctl.initial_dt(j_lorenz, jnp.asarray(u[:, b]),
                                   jnp.asarray(p[:, b]), 0.0, 1.0, 5, atol,
                                   rtol)
            np.testing.assert_allclose(float(got[b]), float(want), rtol=1e-13)


# ---------------------------------------------------------------------------
# one step and dense output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tsit5", "dopri5", "rkck54", "vern7"])
def test_rk_step_matches_lanes(name):
    u, p, dt = _lorenz_lanes(11, seed=4)
    jt, tt = jtab.get_tableau(name), ttab.get_tableau(name)
    t = np.zeros(11)
    ju, je, jk = jsol.rk_step(j_lorenz, jt, jnp.asarray(u), jnp.asarray(p),
                              jnp.asarray(t), jnp.asarray(dt),
                              j_lorenz(jnp.asarray(u), jnp.asarray(p), 0.0))
    tu, te, tk = tsol.rk_step(t_lorenz, tt, _t(u), _t(p), _t(t), _t(dt),
                              t_lorenz(_t(u), _t(p), 0.0))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-13,
                               atol=1e-13)
    for a, b in zip(tk, jk):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-13)


@pytest.mark.parametrize("name", ["tsit5", "dopri5", "rkck54"])
@pytest.mark.parametrize("lanes", [True, False])
def test_interp_step_matches(name, lanes):
    """Free interpolant (tsit5) and Hermite, FSAL (dopri5) and not (rkck54),
    in lanes mode (theta (S, B)) and array mode (theta (S,))."""
    u, p, dt = _lorenz_lanes(7, seed=5)
    jt, tt = jtab.get_tableau(name), ttab.get_tableau(name)
    theta = np.linspace(0.0, 1.0, 6)
    if lanes:
        theta = np.repeat(theta[:, None], 7, axis=1) * \
            np.linspace(0.5, 1.0, 7)[None]
    else:
        dt = dt[0]
    t = np.zeros(7) if lanes else 0.0
    jk1 = j_lorenz(jnp.asarray(u), jnp.asarray(p), 0.0)
    ju, _, jks = jsol.rk_step(j_lorenz, jt, jnp.asarray(u), jnp.asarray(p),
                              jnp.asarray(t), jnp.asarray(dt), jk1)
    want = jsol.interp_step(j_lorenz, jt, jnp.asarray(u), ju, jks,
                            jnp.asarray(p), jnp.asarray(t), jnp.asarray(dt),
                            jnp.asarray(theta), lanes=lanes)
    tk1 = t_lorenz(_t(u), _t(p), 0.0)
    tu, _, tks = tsol.rk_step(t_lorenz, tt, _t(u), _t(p), _t(t), _t(dt), tk1)
    got = tsol.interp_step(t_lorenz, tt, _t(u), tu, tks, _t(p), _t(t),
                           _t(dt), _t(theta), lanes=lanes)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)


# ---------------------------------------------------------------------------
# registry and front-door guards
# ---------------------------------------------------------------------------

def test_method_registry_erk_and_later_slices():
    from repro.core.methods import get_method as jget
    from repro_torch.core.methods import (get_method, list_methods,
                                          valid_dispatch)
    for name in ("tsit5", "gputsit5", "dopri5", "vern7", "gpuvern7", "rk4"):
        spec, ref = get_method(name), jget(name)
        assert (spec.name, spec.family, spec.order, spec.adaptive) == \
            (ref.name, ref.family, ref.order, ref.adaptive)
    for name in ("em", "gpuem", "euler_maruyama", "siea", "gpusiea",
                 "heun_strat", "milstein"):
        spec, ref = get_method(name), jget(name)
        assert (spec.name, spec.family, spec.order, spec.noise) == \
            (ref.name, ref.family, ref.order, ref.noise)
    for name in ("rosenbrock23", "rb23", "ode23s", "gpurosenbrock23",
                 "rodas4", "gpurodas4", "rodas5p", "gpurodas5p", "rodas5"):
        spec, ref = get_method(name), jget(name)
        assert (spec.name, spec.family, spec.order, spec.adaptive,
                spec.stiff) == (ref.name, ref.family, ref.order,
                                ref.adaptive, ref.stiff)
    assert {s.name for s in list_methods()} == set(jtab.TABLEAUS) | {
        "em", "platen_w2", "heun_strat", "milstein"} | set(
            jtab.ROSENBROCK_TABLEAUS)
    tsit5 = get_method("tsit5")
    assert valid_dispatch(tsit5, "kernel", "cuda")[0]
    assert not valid_dispatch(tsit5, "vmap", "cuda")[0]
    assert not valid_dispatch(get_method("rk4"), "kernel", adaptive=True)[0]


def test_front_door_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs.de_problems import lorenz_ensemble
    from repro_torch.core.ensemble import resolve_device, solve_ensemble_local
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_ensemble_local(lorenz_ensemble(4), tf=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_ensemble_local(lorenz_ensemble(4), tf=0.1, device="cuda")


def _half_event():
    from repro_torch.configs.de_problems import half_event
    return half_event()


# events, sensitivities and ensemble="auto" run on every family now; "auto"
# dispatches its tuned winner bitwise (tests/test_torch_autotune.py holds
# the rest of core/autotune.py).  The sensitivity cases are held to the
# reference: the same refusal where it refuses (an adaptive adjoint without
# adjoint_steps), and with a bound, the same gradients (f64, rel 1e-10).
@pytest.mark.parametrize("kw", [dict(event=_half_event(),
                                     sensitivity="adjoint"),
                                dict(sensitivity="adjoint"),
                                dict(ensemble="auto"),
                                dict(alg="rodas4", event=_half_event(),
                                     sensitivity="adjoint"),
                                dict(alg="rosenbrock23",
                                     sensitivity="adjoint")])
def test_front_door_later_slices_raise(kw, monkeypatch, tmp_path):
    import jax
    from repro.configs.de_problems import lorenz_problem as jlorenz
    from repro.core.ensemble import solve_ensemble_local as jsolve
    from repro.core.events import Event as JEvent
    from repro.core.problem import EnsembleProblem as JEP
    from repro_torch.configs.de_problems import lorenz_ensemble
    from repro_torch.core.ensemble import solve_ensemble_local as tsolve
    from repro_torch.core.problem import EnsembleProblem as TEP
    if kw.get("ensemble") == "auto":
        from repro_torch.core import autotune
        from repro_torch.core.methods import get_method
        monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
        ep = lorenz_ensemble(4)
        got = tsolve(ep, tf=0.1, device="cpu", **kw)
        dec = autotune.resolve_auto(ep, get_method("tsit5"), tf=0.1,
                                    device="cpu")
        assert dec.source == "cache"
        want = tsolve(ep, tf=0.1, device="cpu", ensemble=dec.strategy,
                      backend=dec.backend, lane_tile=dec.lane_tile)
        assert torch.equal(got.u_final, want.u_final)
        return
    ep = lorenz_ensemble(4, dtype=torch.float64)
    u0s, ps = (x.numpy().copy() for x in ep.materialize())
    jkw = dict(kw)
    if "event" in jkw:
        jkw["event"] = JEvent(condition=lambda u, p, t: u[0] - 0.5,
                              terminal=True, direction=-1)
    jep = JEP(jlorenz(jnp.float64), 4, u0s=jnp.asarray(u0s),
              ps=jnp.asarray(ps))
    with pytest.raises(ValueError) as want:
        jsolve(jep, tf=0.1, **jkw)
    with pytest.raises(ValueError) as got:
        tsolve(ep, tf=0.1, device="cpu", **kw)
    assert str(got.value) == str(want.value)

    def jloss(u, p):
        r = jsolve(JEP(jlorenz(jnp.float64), 4, u0s=u, ps=p), tf=0.1,
                   adjoint_steps=64, **jkw)
        return jnp.sum(r.u_final ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0s), jnp.asarray(ps))
    u = torch.tensor(u0s, requires_grad=True)
    p = torch.tensor(ps, requires_grad=True)
    res = tsolve(TEP(ep.prob, 4, u0s=u, ps=p), tf=0.1, adjoint_steps=64,
                 device="cpu", **kw)
    assert int(res.status) == 0
    tg = torch.autograd.grad((res.u_final ** 2).sum(), (u, p))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_user_tableau_from_reference_arrays_through_front_door():
    """A tableau carried over as the reference's coefficient arrays runs
    through both front doors as a bare `Tableau` (here bs3, 3(2), FSAL,
    Hermite dense output)."""
    from repro.core.ensemble import solve_ensemble_local as jsolve
    from repro.core.problem import EnsembleProblem as JEnsembleProblem
    from repro.configs.de_problems import lorenz_problem as j_problem
    from repro_torch.configs.de_problems import lorenz_problem
    from repro_torch.convert import ensemble_problem, tableau_from_arrays
    from repro_torch.core.ensemble import solve_ensemble_local as tsolve
    ref = jtab.get_tableau("bs3")
    tab = tableau_from_arrays("user_bs3", ref.a, ref.b, ref.btilde, ref.c,
                              order=ref.order,
                              embedded_order=ref.embedded_order,
                              fsal=ref.fsal)
    u, p, _ = _lorenz_lanes(5, seed=6)
    u0s, ps = u.T / 5.0, p.T
    kw = dict(ensemble="kernel", t0=0.0, tf=0.5, dt0=1e-3, rtol=1e-7,
              atol=1e-7, saveat=np.linspace(0.0, 0.5, 6))
    want = jsolve(JEnsembleProblem(j_problem(jnp.float64), 5,
                                   u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
                  alg=ref, backend="xla", lane_tile=5, **kw)
    got = tsolve(ensemble_problem(lorenz_problem(torch.float64), u0s, ps),
                 alg=tab, backend="torch", device="cpu", **kw)
    np.testing.assert_array_equal(got.naccept.numpy(), np.asarray(want.naccept))
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us),
                               rtol=1e-10, atol=1e-10)
