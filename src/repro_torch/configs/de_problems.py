"""The paper's benchmark differential-equation models (Appendix A) that the
port carries so far, in PyTorch.

RHS functions are component style (index u[0], ..., combine with
torch.stack), so the same definition runs per trajectory, array-ensembled
and lane-vectorized.  The fused CUDA kernels run the hand-written device
functor each one is registered with (`device_rhs` for an ODE RHS,
`device_sde` for an SDE's drift and diffusion).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.problem import EnsembleProblem, ODEProblem, SDEProblem
from repro_torch.kernels.em.kernel import device_sde
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
