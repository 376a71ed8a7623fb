"""The paper's benchmark differential-equation models (Appendix A) that the
port carries so far, in PyTorch.

RHS functions are component style (index u[0], ..., combine with
torch.stack), so the same definition runs per trajectory, array-ensembled
and lane-vectorized.  The fused CUDA kernels run the hand-written device
functor each one is registered with (`device_rhs` for an explicit-RK
RHS, `device_stiff` for a stiff RHS and its Jacobian, `device_sde` for an
SDE's drift and diffusion, `device_event` for an event's condition and
affect).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.events import Event
from repro_torch.core.interp import UniformTable1D, interp1d
from repro_torch.core.problem import EnsembleProblem, ODEProblem, SDEProblem
from repro_torch.kernels.em.kernel import device_sde
from repro_torch.kernels.events import device_event
from repro_torch.kernels.rosenbrock.kernel import device_stiff
from repro_torch.kernels.tsit5.kernel import device_rhs


# ---------------------------------------------------------------------------
# Forced oscillator — the data-driven demo problem (paper §6.7): the drive
# term is a UniformTable1D riding `prob.data` into every dispatch path; the
# kernels read it through the data functors `forced_osc` (gather, K1 and
# K3), `forced_osc_onehot` and `forced_osc_cubic` (K1)
# ---------------------------------------------------------------------------

@device_rhs("forced_osc")
@device_stiff("forced_osc")
def forced_oscillator_rhs(u, p, t, data):
    # u'' + p[1] u' + p[0] u = F(t), F interpolated from the dataset
    return torch.stack([u[1], -p[0] * u[0] - p[1] * u[1]
                        + interp1d(data["force"], t)])


@device_rhs("forced_osc_onehot")
def forced_oscillator_onehot_rhs(u, p, t, data):
    return torch.stack([u[1], -p[0] * u[0] - p[1] * u[1]
                        + interp1d(data["force"], t, "onehot")])


@device_rhs("forced_osc_cubic")
def forced_oscillator_cubic_rhs(u, p, t, data):
    return torch.stack([u[1], -p[0] * u[0] - p[1] * u[1]
                        + interp1d(data["force"], t, "cubic")])


FORCED_OSC_RHS = {"gather": forced_oscillator_rhs,
                  "onehot": forced_oscillator_onehot_rhs,
                  "cubic": forced_oscillator_cubic_rhs}


def forced_oscillator_problem(K=65, t_max=10.0, tspan=(0.0, 5.0),
                              dtype=torch.float64) -> ODEProblem:
    """Damped oscillator driven by a K-knot force table over [0, t_max]."""
    xs = np.linspace(0.0, t_max, K)
    F = np.sin(1.3 * xs) + 0.5 * np.cos(0.4 * xs)
    tab = UniformTable1D(torch.tensor(F, dtype=dtype), 0.0,
                         float(xs[1] - xs[0]))
    return ODEProblem(forced_oscillator_rhs,
                      torch.tensor([1.0, 0.0], dtype=dtype),
                      torch.tensor([2.0, 0.1], dtype=dtype), tspan,
                      data={"force": tab}, name="forced_oscillator")


def texture_oscillator_problem(mode="gather", K=64,
                               dtype=torch.float32) -> ODEProblem:
    """`benchmarks/bench_texture_interp.py`'s configuration: K knots of
    sin(6x) + 0.5 cos(17x) on [0, 1], p = (4, 0.2), t in [0, 1], the
    lookup in `mode`."""
    xs = np.linspace(0.0, 1.0, K)
    F = np.sin(6.0 * xs) + 0.5 * np.cos(17.0 * xs)
    tab = UniformTable1D(torch.tensor(F, dtype=dtype), 0.0,
                         float(xs[1] - xs[0]))
    return ODEProblem(FORCED_OSC_RHS[mode],
                      torch.tensor([1.0, 0.0], dtype=dtype),
                      torch.tensor([4.0, 0.2], dtype=dtype), (0.0, 1.0),
                      data={"force": tab}, name=f"forced_osc_{mode}")


@device_event("osc_level")
def osc_level_condition(u, p, t):
    return u[0] - 1.5


def osc_level_event() -> Event:
    """The oscillator's position crosses 1.5 upwards, terminal (the
    reference's events-with-data case)."""
    return Event(condition=osc_level_condition, direction=1, terminal=True)


# A.1.1 Lorenz attractor — the headline ODE benchmark (Figs. 4-7)
@device_rhs("lorenz")
def lorenz_rhs(u, p, t):
    sigma, rho, beta = p[0], p[1], p[2]
    x, y, z = u[0], u[1], u[2]
    return torch.stack([
        sigma * (y - x),
        rho * x - y - x * z,
        x * y - beta * z,
    ])


def lorenz_problem(dtype=torch.float32) -> ODEProblem:
    u0 = torch.tensor([1.0, 0.0, 0.0], dtype=dtype)
    p = torch.tensor([10.0, 21.0, 8.0 / 3.0], dtype=dtype)
    return ODEProblem(lorenz_rhs, u0, p, (0.0, 1.0), name="lorenz")


def lorenz_ensemble(n_trajectories: int, dtype=torch.float32,
                    rho_range=(0.0, 21.0)) -> EnsembleProblem:
    """The paper's sweep: rho uniform over (0, 21), sigma=10, beta=8/3 fixed."""
    prob = lorenz_problem(dtype)
    rho = torch.linspace(rho_range[0], rho_range[1], n_trajectories,
                         dtype=dtype)
    ps = torch.stack([torch.full_like(rho, 10.0), rho,
                      torch.full_like(rho, 8.0 / 3.0)], dim=1)
    return EnsembleProblem(prob, n_trajectories, ps=ps)


# A.1.2 Bouncing ball — the event-handling demo (Fig. 8)
@device_rhs("ball")
@device_stiff("ball")
def bouncing_ball_rhs(u, p, t):
    # u = [x, v]; p = [g, e]
    return torch.stack([u[1], -p[0] * torch.ones_like(u[1])])


@device_event("ball_bounce")
def bouncing_ball_condition(u, p, t):
    return u[0]


@device_event("ball_bounce")
def bouncing_ball_affect(u, p, t):
    # flip the velocity by the coefficient of restitution e = p[1]
    return torch.stack([torch.zeros_like(u[0]), -p[1] * u[1]])


def bouncing_ball_event() -> Event:
    """Bounce when the height crosses zero downwards (non-terminal)."""
    return Event(condition=bouncing_ball_condition,
                 affect=bouncing_ball_affect, terminal=False, direction=-1)


def bouncing_ball_problem(e=0.9, x0=10.0, dtype=torch.float64) -> ODEProblem:
    u0 = torch.tensor([x0, 0.0], dtype=dtype)
    p = torch.tensor([9.8, e], dtype=dtype)
    return ODEProblem(bouncing_ball_rhs, u0, p, (0.0, 15.0),
                      name="bouncing_ball")


# Van der Pol — the standard stiff benchmark (paper §7's missing frontier)
@device_stiff("vdp")
def vdp_rhs(u, p, t):
    mu = p[0]
    return torch.stack([u[1], mu * ((1.0 - u[0] ** 2) * u[1]) - u[0]])


def vdp_problem(mu=10.0, tspan=(0.0, 1.0), dtype=torch.float64) -> ODEProblem:
    return ODEProblem(vdp_rhs, torch.tensor([2.0, 0.0], dtype=dtype),
                      torch.tensor([mu], dtype=dtype), tspan, name="vdp")


def vdp_ensemble(n_trajectories: int, mu_range=(5.0, 20.0),
                 tspan=(0.0, 1.0), dtype=torch.float64) -> EnsembleProblem:
    """Stiffness sweep: mu uniform over mu_range (larger mu = stiffer)."""
    prob = vdp_problem(tspan=tspan, dtype=dtype)
    mus = torch.linspace(mu_range[0], mu_range[1], n_trajectories,
                         dtype=dtype)
    return EnsembleProblem(prob, n_trajectories, ps=mus[:, None])


# ROBER — Robertson's chemical kinetics, the classic stiff benchmark (paper
# §5.1.3's GPURodas4/GPURodas5P target).  Its rate constants span nine
# orders of magnitude, so it is meaningless in float32.  It ships an
# analytic Jacobian for the ODEProblem.jac hook; without it the solvers take
# jacfwd, with the same results.
@device_stiff("rober")
def rober_rhs(u, p, t):
    k1, k2, k3 = p[0], p[1], p[2]
    y1, y2, y3 = u[0], u[1], u[2]
    return torch.stack([
        -k1 * y1 + k3 * y2 * y3,
        k1 * y1 - k2 * y2 * y2 - k3 * y2 * y3,
        k2 * y2 * y2,
    ])


@device_stiff("rober")
def rober_jac(u, p, t):
    """Analytic ∂f/∂u in component style: (3, 3) per trajectory, (3, 3, B)
    on a lane tile."""
    k1, k2, k3 = p[0], p[1], p[2]
    y1, y2, y3 = u[0], u[1], u[2]
    z = torch.zeros_like(y1)
    return torch.stack([
        torch.stack([-k1 + z, k3 * y3, k3 * y2]),
        torch.stack([k1 + z, -2.0 * k2 * y2 - k3 * y3, -k3 * y2]),
        torch.stack([z, 2.0 * k2 * y2, z]),
    ])


@device_event("rober_half")
def rober_half_condition(u, p, t):
    return u[2] - 0.5


def rober_half_event() -> Event:
    """Half conversion: y3 crosses 0.5 upwards, terminal (the reference's
    stiff event test, tests/test_stiff.py)."""
    return Event(condition=rober_half_condition, terminal=True, direction=1)


def rober_problem(k1=0.04, k2=3e7, k3=1e4, tspan=(0.0, 1e5),
                  dtype=torch.float64, analytic_jac=True) -> ODEProblem:
    u0 = torch.tensor([1.0, 0.0, 0.0], dtype=dtype)
    p = torch.tensor([k1, k2, k3], dtype=dtype)
    return ODEProblem(rober_rhs, u0, p, tspan, name="rober",
                      jac=rober_jac if analytic_jac else None)


def rober_ensemble(n_trajectories: int, k1_range=(0.01, 0.1),
                   tspan=(0.0, 1e5), dtype=torch.float64,
                   analytic_jac=True) -> EnsembleProblem:
    """Rate-constant sweep: k1 log-uniform over k1_range (k2, k3 fixed)."""
    prob = rober_problem(tspan=tspan, dtype=dtype, analytic_jac=analytic_jac)
    k1s = torch.linspace(math.log(k1_range[0]), math.log(k1_range[1]),
                         n_trajectories, dtype=torch.float64).exp().to(dtype)
    ps = torch.stack([k1s, torch.full_like(k1s, 3e7),
                      torch.full_like(k1s, 1e4)], dim=1)
    return EnsembleProblem(prob, n_trajectories, ps=ps)


# OREGO — the Oregonator (Belousov-Zhabotinsky reaction), a stiff
# limit-cycle oscillator (Hairer-Wanner's second standard stiff benchmark).
@device_stiff("orego")
def orego_rhs(u, p, t):
    s, q, w = p[0], p[1], p[2]
    y1, y2, y3 = u[0], u[1], u[2]
    return torch.stack([
        s * (y2 + y1 * (1.0 - q * y1 - y2)),
        (y3 - (1.0 + y1) * y2) / s,
        w * (y1 - y3),
    ])


def orego_problem(s=77.27, q=8.375e-6, w=0.161, tspan=(0.0, 360.0),
                  dtype=torch.float64) -> ODEProblem:
    u0 = torch.tensor([1.0, 2.0, 3.0], dtype=dtype)
    p = torch.tensor([s, q, w], dtype=dtype)
    return ODEProblem(orego_rhs, u0, p, tspan, name="orego")


# A.2.1 Linear SDE (geometric Brownian motion) — asset-price model (Fig. 9)
@device_sde("gbm")
def gbm_drift(u, p, t):
    return p[0] * u


@device_sde("gbm")
def gbm_diffusion(u, p, t):
    return p[1] * u


def gbm_problem(r=1.5, v=0.01, dtype=torch.float32) -> SDEProblem:
    u0 = torch.tensor([0.1, 0.1, 0.1], dtype=dtype)
    p = torch.tensor([r, v], dtype=dtype)
    return SDEProblem(gbm_drift, gbm_diffusion, u0, p, (0.0, 1.0),
                      noise="diagonal", name="gbm")


# GBM with a time-dependent rate read from a table (paper §6.7 on the SDE
# family): f = r(t) u, g = s u, diagonal noise
@device_sde("gbm_rate")
def gbm_rate_drift(u, p, t, data):
    return interp1d(data["rate"], t) * u


@device_sde("gbm_rate")
def gbm_rate_diffusion(u, p, t, data):
    return p[0] * u


def gbm_rate_problem(sigma=0.2, dtype=torch.float64) -> SDEProblem:
    """The reference's SDE-with-data case: a 33-knot rate table
    0.02 + 0.01 sin(t) over [0, 2], u0 = 1, t in [0, 1]."""
    ts = np.linspace(0.0, 2.0, 33)
    rate = UniformTable1D(torch.tensor(0.02 + 0.01 * np.sin(ts),
                                       dtype=dtype), 0.0,
                          float(ts[1] - ts[0]))
    return SDEProblem(gbm_rate_drift, gbm_rate_diffusion,
                      torch.ones(1, dtype=dtype),
                      torch.tensor([sigma], dtype=dtype), (0.0, 1.0),
                      noise="diagonal", data={"rate": rate}, name="gbm_rate")


@device_event("gbm_barrier")
def gbm_barrier_condition(u, p, t):
    return u[0] - 0.18


def gbm_barrier_event() -> Event:
    """A knock-out barrier: the first state crosses 0.18 upwards, terminal
    (the reference's SDE event parity case)."""
    return Event(condition=gbm_barrier_condition, terminal=True, direction=1)


# A constant-drift ramp with negligible noise and a sawtooth event: EM is
# drift-exact for any dt, so the only error left is the event-resume
# bookkeeping (the reference's re-anchoring probe).
@device_sde("ramp")
def ramp_drift(u, p, t):
    return torch.ones_like(u) * p[0]


@device_sde("ramp")
def ramp_diffusion(u, p, t):
    return p[1] * u


def ramp_problem(c=1.0, sigma=1e-10, dtype=torch.float64) -> SDEProblem:
    return SDEProblem(ramp_drift, ramp_diffusion,
                      torch.tensor([0.0], dtype=dtype),
                      torch.tensor([c, sigma], dtype=dtype), (0.0, 1.0),
                      noise="diagonal", name="ramp")


@device_event("ramp_sawtooth")
def ramp_sawtooth_condition(u, p, t):
    return u[0] - 0.15


@device_event("ramp_sawtooth")
def ramp_sawtooth_affect(u, p, t):
    return u - 0.1


def ramp_sawtooth_event() -> Event:
    """Cross 0.15 upwards, drop by 0.1 (non-terminal): with drift 1 the
    crossings come every 0.1 time units, 9 in [0, 1], so u(1) = 0.1."""
    return Event(condition=ramp_sawtooth_condition,
                 affect=ramp_sawtooth_affect, direction=1)


# A.2.2 Chemical-reaction-network sigma-factor stress-response model
# (Figs. 10/11): 4 states, 8 Wiener processes (general noise), 6 parameters.
@device_sde("crn")
def crn_drift(u, p, t):
    S, D, tau, v0, n, eta = p[0], p[1], p[2], p[3], p[4], p[5]
    sig, A1, A2, A3 = u[0], u[1], u[2], u[3]
    hill = (S * sig) ** n / ((S * sig) ** n + (D * A3) ** n + 1.0)
    return torch.stack([
        v0 + hill - sig,
        (sig - A1) / tau,
        (A1 - A2) / tau,
        (A2 - A3) / tau,
    ])


@device_sde("crn")
def crn_diffusion(u, p, t):
    """(4, 8) noise matrix (or (4, 8, B) lane-batched): CLE birth/death terms."""
    S, D, tau, v0, n, eta = p[0], p[1], p[2], p[3], p[4], p[5]
    sig, A1, A2, A3 = u[0], u[1], u[2], u[3]
    pos = lambda x: torch.sqrt(torch.clamp_min(x, 0.0))
    hill = (S * sig) ** n / ((S * sig) ** n + (D * A3) ** n + 1.0)
    z = torch.zeros_like(sig)
    rows = [
        [eta * pos(v0 + hill), -eta * pos(sig), z, z, z, z, z, z],
        [z, z, eta * pos(sig / tau), -eta * pos(A1 / tau), z, z, z, z],
        [z, z, z, z, eta * pos(A1 / tau), -eta * pos(A2 / tau), z, z],
        [z, z, z, z, z, z, eta * pos(A2 / tau), -eta * pos(A3 / tau)],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def crn_problem(S=10.0, D=10.0, tau=10.0, v0=0.1, n=3.0, eta=0.01,
                tspan=(0.0, 1000.0), dtype=torch.float32) -> SDEProblem:
    p = torch.tensor([S, D, tau, v0, n, eta], dtype=dtype)
    u0 = torch.full((4,), v0, dtype=dtype)
    return SDEProblem(crn_drift, crn_diffusion, u0, p, tspan,
                      noise="general", n_noise=8, name="crn")


# the paper's Table-4 ranges of (S, D, tau, v0, n, eta)
CRN_SWEEP_LO = (0.1, 0.1, 0.1, 0.01, 2.0, 0.001)
CRN_SWEEP_HI = (100.0, 100.0, 100.0, 0.2, 4.0, 0.1)


def crn_sweep_arrays(n_trajectories: int, seed: int = 0):
    """The Table-4 parameter sweep as numpy float64 arrays, from a seed:
    ps (N, 6) uniform over the ranges and u0s (N, 4) = v0, as
    `benchmarks/bench_fig11_crn.py` draws it (there from jax.random)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(CRN_SWEEP_LO), np.asarray(CRN_SWEEP_HI)
    ps = lo + rng.random((n_trajectories, 6)) * (hi - lo)
    u0s = np.repeat(ps[:, 3:4], 4, axis=1)
    return u0s, ps


# Simple analytic test problems (convergence, dtype and event tests)
@device_rhs("decay")
@device_stiff("decay")
def linear_decay_rhs(u, p, t):
    return -p[0] * u


def linear_decay_problem(lam=1.0, dtype=torch.float64) -> ODEProblem:
    return ODEProblem(linear_decay_rhs, torch.tensor([1.0], dtype=dtype),
                      torch.tensor([lam], dtype=dtype), (0.0, 2.0),
                      name="linear_decay")


@device_event("decay_half")
def half_condition(u, p, t):
    return u[0] - 0.5


def half_event() -> Event:
    """u crosses 1/2 downwards, terminal: on u' = -lam u, u0 = 1 it hits at
    t* = ln 2 / lam (the reference's event parity case)."""
    return Event(condition=half_condition, terminal=True, direction=-1)


@device_rhs("sho")
def sho_rhs(u, p, t):
    # harmonic oscillator, omega = p[0]
    return torch.stack([u[1], -(p[0] ** 2) * u[0]])


def sho_problem(omega=2.0, dtype=torch.float64) -> ODEProblem:
    return ODEProblem(sho_rhs, torch.tensor([1.0, 0.0], dtype=dtype),
                      torch.tensor([omega], dtype=dtype), (0.0, 3.0),
                      name="sho")
