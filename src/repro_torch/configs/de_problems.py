"""The paper's benchmark differential-equation models (Appendix A) that the
port carries so far, in PyTorch.

RHS functions are component style (index u[0], ..., combine with
torch.stack), so the same definition runs per trajectory, array-ensembled
and lane-vectorized.  The fused CUDA kernels run the hand-written device
functor each one is registered with (`device_rhs` for an explicit-RK
RHS, `device_stiff` for a stiff RHS and its Jacobian, `device_sde` for an
SDE's drift and diffusion).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.problem import EnsembleProblem, ODEProblem, SDEProblem
from repro_torch.kernels.em.kernel import device_sde
from repro_torch.kernels.rosenbrock.kernel import device_stiff
from repro_torch.kernels.tsit5.kernel import device_rhs


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


# Simple analytic test problems (convergence and dtype tests)
def linear_decay_rhs(u, p, t):
    return -p[0] * u


def linear_decay_problem(lam=1.0, dtype=torch.float64) -> ODEProblem:
    return ODEProblem(linear_decay_rhs, torch.tensor([1.0], dtype=dtype),
                      torch.tensor([lam], dtype=dtype), (0.0, 2.0),
                      name="linear_decay")


@device_rhs("sho")
def sho_rhs(u, p, t):
    # harmonic oscillator, omega = p[0]
    return torch.stack([u[1], -(p[0] ** 2) * u[0]])


def sho_problem(omega=2.0, dtype=torch.float64) -> ODEProblem:
    return ODEProblem(sho_rhs, torch.tensor([1.0, 0.0], dtype=dtype),
                      torch.tensor([omega], dtype=dtype), (0.0, 3.0),
                      name="sho")
