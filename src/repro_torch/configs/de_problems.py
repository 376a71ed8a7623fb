"""The paper's benchmark differential-equation models (Appendix A) that this
slice of the port needs, in PyTorch.

RHS functions are component style (index u[0], ..., combine with
torch.stack), so the same definition runs per trajectory, array-ensembled
and lane-vectorized.  The fused CUDA kernel runs the hand-written device
functor each one is registered with (`device_rhs`).
"""
from __future__ import annotations

import torch

from repro_torch.core.problem import EnsembleProblem, ODEProblem
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
