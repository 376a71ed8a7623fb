"""The scalar (per-trajectory) Rosenbrock mode, ``solve_rosenbrock(
lanes=False)``: u (n,), p (m,), t and dt 0-d, against the reference's
scalar mode (`repro.core.rosenbrock.solve_rosenbrock(lanes=False)`) one
trajectory at a time, on ROBER (rodas4 and rodas5p, eager and lazy W, the
analytic Jacobian; rosenbrock23 with the half-conversion event) and Van der
Pol (the Jacobian by jacfwd): counts identical, states within 1e-10 of
the lane's largest value at rtol 1e-6 (worst measured 9.8e-11, rodas5p
eager).  Each trajectory also equals its
column of the lanes engine bit for bit, and one step (`rosenbrock_step`)
equals the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import rosenbrock as jrb
from repro.core import tableaus as jtab
from repro.core.events import Event as JEvent
from repro_torch.configs import de_problems as dp
from repro_torch.core import rosenbrock as rb
from repro_torch.core import tableaus as tab
from repro_torch.core.events import Event

F64 = torch.float64
# the trajectories of tests/test_torch_stiff_rober.py: k1 log-uniform over
# (0.01, 0.1), k2 and k3 fixed
ROBER_P = dp.rober_ensemble(4).materialize()[1].numpy()
VDP_P = np.array([[5.0], [20.0]])
ROBER_SAVE = np.array([1e-2, 1.0, 1e2, 1e4])
VDP_SAVE = np.array([0.25, 0.5, 1.0])

CASES = {
    "rober-rodas4-eager": ("rober", "rodas4", False, False),
    "rober-rodas4-lazyW": ("rober", "rodas4", True, False),
    "rober-rodas5p-eager": ("rober", "rodas5p", False, False),
    "rober-rodas5p-lazyW": ("rober", "rodas5p", True, False),
    "rober-rosenbrock23-event": ("rober", "rosenbrock23", False, True),
    "vdp-rodas5p-jacfwd": ("vdp", "rodas5p", False, False),
}


def _setup(problem):
    if problem == "rober":
        return dict(f=(dp.rober_rhs, jdp.rober_rhs),
                    jac=(dp.rober_jac, jdp.rober_jac),
                    u0=np.array([1.0, 0.0, 0.0]), ps=ROBER_P,
                    span=(0.0, 1e4), dt0=1e-6, atol=1e-8, save=ROBER_SAVE)
    return dict(f=(dp.vdp_rhs, jdp.vdp_rhs), jac=(None, None),
                u0=np.array([2.0, 0.0]), ps=VDP_P, span=(0.0, 1.0),
                dt0=1e-4, atol=1e-8, save=VDP_SAVE)


def _events(with_event):
    if not with_event:
        return None, None
    return (Event(condition=dp.rober_half_condition, terminal=True,
                  direction=1),
            JEvent(condition=lambda u, p, t: u[2] - 0.5, terminal=True,
                   direction=1))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= 1e-10 * scale, what


@pytest.mark.parametrize("case", sorted(CASES))
def test_scalar_mode_matches_reference_and_lanes(case):
    problem, alg, w_reuse, with_event = CASES[case]
    s = _setup(problem)
    ev, jev = _events(with_event)
    kw = dict(rtol=1e-6, atol=s["atol"], w_reuse=w_reuse or None)
    rtab, jrtab = (tab.ROSENBROCK_TABLEAUS[alg],
                   jtab.ROSENBROCK_TABLEAUS[alg])
    t0, tf = s["span"]
    lanes = rb.solve_rosenbrock(
        s["f"][0], rtab, torch.tensor(np.tile(s["u0"], (len(s["ps"]), 1)).T),
        torch.tensor(s["ps"].T), t0, tf, s["dt0"],
        saveat=torch.tensor(s["save"]), jac=s["jac"][0], event=ev, **kw)
    if ev is not None:
        lanes, lanes_log = lanes
    for i, p in enumerate(s["ps"]):
        got = rb.solve_rosenbrock(
            s["f"][0], rtab, torch.tensor(s["u0"]), torch.tensor(p), t0, tf,
            s["dt0"], saveat=torch.tensor(s["save"]), jac=s["jac"][0],
            event=ev, lanes=False, **kw)
        want = jrb.solve_rosenbrock(
            s["f"][1], jrtab, jnp.asarray(s["u0"]), jnp.asarray(p), t0, tf,
            s["dt0"], saveat=jnp.asarray(s["save"]), jac=s["jac"][1],
            event=jev, lanes=False, **kw)
        if ev is not None:
            (got, log), (want, jlog) = got, want
            assert int(log["event_count"]) == int(jlog["event_count"]) == 1
            _close(log["event_t"], jlog["event_t"], "event_t")
            assert torch.equal(log["event_t"], lanes_log["event_t"][i])
        assert got.us.shape == (len(s["save"]), len(s["u0"]))
        assert got.u_final.shape == (len(s["u0"]),) and got.t_final.dim() == 0
        for k in ("naccept", "nreject", "status", "nf", "njac", "nfact"):
            assert int(getattr(got, k)) == int(getattr(want, k)), (case, k)
        assert int(got.status) == 0
        for k in ("us", "u_final", "t_final"):
            _close(getattr(got, k), getattr(want, k), (case, i, k))
        # the lanes engine's column, bit for bit
        for k in ("us", "u_final", "t_final", "naccept", "nreject", "njac",
                  "nfact", "nf"):
            assert torch.equal(getattr(got, k), getattr(lanes, k)[..., i]), k


def test_scalar_step_matches_reference():
    u = np.array([0.9, 2e-5, 0.1])
    p = ROBER_P[0]
    for name in ("rosenbrock23", "rodas4", "rodas5p"):
        got = rb.rosenbrock_step(dp.rober_rhs, tab.ROSENBROCK_TABLEAUS[name],
                                 torch.tensor(u), torch.tensor(p),
                                 torch.tensor(1.0, dtype=F64),
                                 torch.tensor(1e-3, dtype=F64), lanes=False,
                                 jac=dp.rober_jac)
        want = jrb.rosenbrock_step(jdp.rober_rhs,
                                   jtab.ROSENBROCK_TABLEAUS[name],
                                   jnp.asarray(u), jnp.asarray(p), 1.0, 1e-3,
                                   lanes=False, jac=jdp.rober_jac)
        for a, b in zip(got[:4], want[:4]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.shape == (3,)
                _close(a, b, name)
        assert len(got[4]) == len(want[4])
        for a, b in zip(got[4], want[4]):
            _close(a, b, name)
