"""K5, the adaptive SDE kernel, through the automated translation on the
CPU (`repro_torch.translate.units.sde_adaptive_unit`,
`kernels/em/adaptive.py`): the derived gdg = (∂g/∂u)·g and ddb =
∂((∂g)·g)·g against the nested JVP of the milstein pair (the port's
`torch.func.jvp`, bit for bit; the reference's `jax.jvp`, within 1e-13 of
the largest value: XLA's pow differs from PyTorch's by an ulp, and CRN's
second derivative of its Hill term carries that through two more pows,
5e-15 relative measured) on GBM,
CRN's drift taken as a diagonal diffusion, and a user pair; the route of
every stepper and pair; the generated C entries against the wrapper's
`argtypes()`; and the milstein pair on GBM, its drift and diffusion
translated, through the port's front door against the reference's
(Pallas kernel, interpret mode) on the reference's bridge normals: per-lane
counts identical, states within 1e-12 (tests/test_torch_adaptive_sde.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.events import Event
from repro_torch.core.problem import SDEProblem
from repro_torch.kernels.em import adaptive as k5
from repro_torch.kernels.em import kernel as k4
from repro_torch.translate import derive, units
from repro_torch.translate.ir import as_function, evaluate
from repro_torch.translate.trace import trace_pair

from test_torch_adaptive_sde import assert_same_run, problems, ref_normals
from test_torch_translate_emit import _types, c_entries

F64 = torch.float64


def user_drift(u, p, t):
    return torch.stack([-p[0] * u[0] + u[1], torch.sin(u[0]) * p[1]])


def user_diffusion(u, p, t):
    return torch.stack([p[1] * torch.sqrt(u[0] * u[0] + 1.0),
                        u[1] * u[0] * 0.5 + torch.exp(-u[1])])


def j_user_diffusion(u, p, t):
    return jnp.stack([p[1] * jnp.sqrt(u[0] * u[0] + 1.0),
                      u[1] * u[0] * 0.5 + jnp.exp(-u[1])])


def crn_as_diffusion(u, p, t):
    return tdp.crn_drift(u, p, t)


# (port diffusion, reference diffusion, n, k)
PAIRS = {"gbm": (tdp.gbm_diffusion, jdp.gbm_diffusion, 3, 2),
         "crn": (crn_as_diffusion, jdp.crn_drift, 4, 6),
         "user": (user_diffusion, j_user_diffusion, 2, 2)}


def _inputs(name):
    """(u (n, 16), p (k, 16)) from a seed."""
    rng = np.random.default_rng(3)
    if name == "gbm":
        return (rng.uniform(0.05, 2.0, (3, 16)),
                np.array([[1.5], [0.2]]) + rng.uniform(0.0, 0.1, (2, 16)))
    if name == "crn":
        u0s, ps = tdp.crn_sweep_arrays(16, 1)
        return np.abs(u0s.T) * rng.uniform(0.5, 1.5, (4, 16)) + 0.01, \
            ps.T.copy()
    return rng.uniform(0.1, 2.0, (2, 16)), rng.uniform(0.5, 2.0, (2, 16))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_derived_gdg_and_ddb_are_the_nested_jvp(name):
    g, jg, n, k = PAIRS[name]
    u_np, p_np = _inputs(name)
    u, p = torch.from_numpy(u_np.copy()), torch.from_numpy(p_np.copy())
    t = torch.zeros(u.shape[1], dtype=F64)
    drift = lambda uu, pp, tt: uu * 0.0  # noqa: E731
    tf, tg = trace_pair(drift, g, n, k, f_outputs=(n,), g_outputs=(n,))
    gdg = derive.jvp(tg, tg)
    ddb = derive.jvp(gdg, tg)
    got_gdg = evaluate(gdg, u, p, t)
    got_ddb = evaluate(ddb, u, p, t)

    # the port's plain version (core/sde.py milstein_embedded_step)
    def db_of(uu):
        return torch.func.jvp(lambda w: g(w, p, t), (uu,), (g(uu, p, t),))[1]

    want_gdg, want_ddb = torch.func.jvp(db_of, (u,), (g(u, p, t),))
    assert torch.equal(got_gdg, want_gdg)
    assert torch.equal(got_ddb, want_ddb)

    # the reference's nested jax.jvp, per lane
    uj, pj = jnp.asarray(u_np), jnp.asarray(p_np)

    def jdb_of(uu):
        return jax.jvp(lambda w: jg(w, pj, 0.0), (uu,), (jg(uu, pj, 0.0),))[1]

    jgdg, jddb = jax.jvp(jdb_of, (uj,), (jg(uj, pj, 0.0),))
    for got, want in ((got_gdg, jgdg), (got_ddb, jddb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-13 * float(np.abs(want).max()))


def _unregistered(fn):
    def wrapper(*args):
        return fn(*args)
    wrapper.__name__ = wrapper.__qualname__ = f"{fn.__name__}_plain"
    return wrapper


GBM = (tdp.gbm_drift, tdp.gbm_diffusion)
TRACED = (_unregistered(tdp.gbm_drift), _unregistered(tdp.gbm_diffusion))
METHODS = [("em", "doubling"), ("heun_strat", "doubling"),
           ("platen_w2", "doubling"), ("milstein", "doubling"),
           ("em", "embedded"), ("milstein", "embedded")]


@pytest.mark.parametrize("alg,est", METHODS)
def test_route_of_every_stepper_and_pair(alg, est):
    """A registered pair goes to the source; its translation to a unit that
    instantiates the stepper or pair it was asked for, with the derived
    gdg (and, for the milstein pair, ddb) where the stepper reads them."""
    kw = dict(n=3, k=2)
    name, fun, unit = k5._device_functor(*GBM, alg, "diagonal", 3, est, **kw)
    assert (name, unit) == ("gbm", None)
    name, fun, unit = k5._device_functor(*TRACED, alg, "diagonal", 3, est,
                                         **kw)
    assert name is None and fun.id == -1
    st = (units.SDE_PAIRS if est == "embedded" else units.SDE_STEPPERS)[alg]
    assert f"using St = repro_sde_adaptive::{st};" in unit.text
    assert (f"launch<Real, Prob, St, {'true' if est == 'embedded' else 'false'}"
            in unit.text)
    milstein_pair = (alg, est) == ("milstein", "embedded")
    assert ("has_ddb = true" in unit.text) == milstein_pair
    assert (" ddb(" in unit.text) == milstein_pair
    # general noise (CRN) runs step doubling through a unit
    crn = (_unregistered(tdp.crn_drift), _unregistered(tdp.crn_diffusion))
    if est == "doubling" and alg in ("em", "heun_strat"):
        unit = k5._device_functor(*crn, alg, "general", 8, est, n=4,
                                  k=6)[2]
        assert " noise(" in unit.text and "diagonal = false" in unit.text


def test_generated_c_entries_take_what_the_wrapper_passes():
    rate = tdp.gbm_rate_problem()
    ev = Event(condition=_unregistered(lambda u, p, t: u[0] - 1.1),
               terminal=True, direction=1)
    for event, data, f, g, n, k in (
            (None, None, *TRACED, 3, 2), (ev, None, *TRACED, 3, 2),
            (None, rate.data, _unregistered(rate.f), rate.g, 1, 1),
            (ev, rate.data, rate.f, rate.g, 1, 1)):
        unit = k5._device_functor(f, g, "em", "diagonal", n if n == 1 else 3,
                                  "embedded", n=n, k=k, event=event,
                                  data=data)[2]
        name = ("sde_adaptive" + ("_data" if data is not None else "")
                + ("_event" if event is not None else "") + "_launch")
        entries = c_entries(unit.text)
        assert list(entries) == [name]
        args = [a.replace("const void* const*", "const void*")
                for a in entries[name]]
        assert _types(args) == k5.argtypes(event is not None,
                                           data is not None)
    # the no-event entry's argument list is the hand-written one's
    from pathlib import Path
    hand = c_entries((Path(k5.__file__).resolve().parents[2] / "csrc"
                      / k5.SOURCE).read_text())
    unit = k5._device_functor(*TRACED, "em", "diagonal", 3, "doubling", n=3,
                              k=2)[2]
    assert c_entries(unit.text)["sde_adaptive_launch"] \
        == hand["sde_adaptive_launch"]


def test_a_registered_pair_in_a_form_the_source_lacks_runs_its_struct():
    """GBM with the ramp's sawtooth (unpaired in EVENT_PAIRS): the unit
    instantiates the hand-written repro_sde::Gbm and RampSawtooth."""
    unit = k5._device_functor(*GBM, "em", "diagonal", 3, "embedded", n=3,
                              k=2, event=tdp.ramp_sawtooth_event())[2]
    assert ("launch<Real, repro_sde::Gbm, St, true, repro_ev::RampSawtooth>"
            in unit.text)
    assert "struct Prob" not in unit.text
    assert ("gbm", "ramp_sawtooth") not in k4.EVENT_PAIRS


def test_translated_milstein_pair_matches_reference_kernel(monkeypatch):
    """The milstein pair on GBM, drift and diffusion translated (ddb the
    derivative of the derived gdg along g), on the reference's normals."""
    from repro_torch.kernels import rng as trng
    monkeypatch.setattr(trng, "bridge_normals", ref_normals)
    jp, tp, u0s, ps, kw = problems("gbm")
    u0s, ps = u0s[:8], ps[:8]
    common = dict(alg="milstein", adaptive=True, error_est="embedded",
                  seed=7, lane_offset=3, **kw)
    want = jsolve(JEnsembleProblem(jp, 8, u0s=jnp.asarray(u0s),
                                   ps=jnp.asarray(ps)),
                  ensemble="kernel", backend="pallas", lane_tile=8,
                  **dict(common, saveat=jnp.asarray(kw["saveat"])))
    tf, tg = trace_pair(TRACED[0], TRACED[1], 3, 2, f_outputs=(3,),
                        g_outputs=(3,))
    prob = SDEProblem(as_function(tf), as_function(tg), tp.u0, tp.p,
                      tp.tspan, noise="diagonal")
    got = tsolve(ensemble_problem(prob, u0s, ps), ensemble="kernel",
                 backend="cuda", device="cpu", **common)
    assert_same_run(got, want)
