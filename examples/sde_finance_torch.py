"""SDE ensembles (paper §6.8) on the PyTorch port — the twin of
examples/sde_finance.py: Black-Scholes asset paths (GBM) through the fused
weak-order-2 Platen and Euler-Maruyama kernels, Monte-Carlo option pricing
against the closed form, then the same workflow driven by market data: a
time-varying short rate r(t) served from a `UniformTable1D` through the
``prob.data`` slot (§6.7), read on the card by the kernel's data functor.
Last, the pathwise delta dC/dX0 of the call by the adjoint through the
kernel (§6.6), against Black-Scholes' N(d1).

The CUDA kernels run a drift/diffusion pair through the device functor it
is registered with, so the term structure uses the registered rate-table
GBM (`gbm_rate_problem`: f = r(t) u, g = sigma u) with a flat volatility,
where the reference's example also tables the volatility.

    PYTHONPATH=src python examples/sde_finance_torch.py [--device cpu] \\
        [--n 50000]
"""
import argparse
import dataclasses
from math import erf, exp, log, sqrt

import numpy as np
import torch

from repro_torch.configs.de_problems import gbm_problem, gbm_rate_problem
from repro_torch.core import EnsembleProblem, solve_ensemble_local
from repro_torch.core.interp import UniformTable1D
from repro_torch.core.sde import solve_sde_ensemble
from repro_torch.core.sensitivity import ensemble_value_and_grad

R, V, X0, T = 0.05, 0.4, 1.0, 1.0
n_steps = 250


def Phi(x):
    return 0.5 * (1 + erf(x / sqrt(2)))


def black_scholes(K, r, v):
    d1 = (log(X0 / K) + (r + v * v / 2) * T) / (v * sqrt(T))
    d2 = d1 - v * sqrt(T)
    return X0 * Phi(d1) - K * exp(-r * T) * Phi(d2), Phi(d1)


def flat_gbm(dtype):
    prob = gbm_problem(r=R, v=V, dtype=dtype)
    return dataclasses.replace(prob, u0=torch.full((3,), X0, dtype=dtype),
                               p=torch.tensor([R, V], dtype=dtype),
                               tspan=(0.0, T))


def constant_coefficient_pricing(N, device):
    """Flat-parameter GBM: Monte-Carlo against the Black-Scholes closed
    form."""
    res = solve_sde_ensemble(EnsembleProblem(flat_gbm(torch.float32), N),
                             None, T / n_steps, n_steps, method="platen_w2",
                             ensemble="kernel", backend="cuda",
                             save_every=n_steps, seed=0, device=device)
    X = res.u_final[:, 0].double().cpu().numpy()
    mean_exact = X0 * np.exp(R * T)
    print(f"E[X_T]   MC = {X.mean():.5f}   analytic = {mean_exact:.5f}   "
          f"rel err = {abs(X.mean() - mean_exact) / mean_exact:.2e}")
    K = 1.1
    bs, _ = black_scholes(K, R, V)
    pay = np.maximum(X - K, 0.0)
    mc, se = float(pay.mean() * exp(-R * T)), float(pay.std() / sqrt(N))
    print(f"call(K={K}) MC = {mc:.5f} ± {se:.5f}   Black-Scholes = {bs:.5f}")
    assert abs(mc - bs) < 4 * se + 2e-3
    return mc


def market_data_pricing(N, device):
    """GBM under a term structure: r(t) is a 33-knot lookup table (think of
    a bootstrapped yield curve).  The table rides `SDEProblem.data` into the
    fused kernel and the drift interpolates it every step.  With a
    deterministic r(t), X_T stays lognormal: E[X_T] = X0 exp(∫ r dt), and a
    European call prices by Black-Scholes at r̄ = mean(r)."""
    tk = np.linspace(0.0, T, 33)
    r_curve = 0.03 + 0.04 * tk / T                 # upward-sloping rates
    base = gbm_rate_problem(sigma=V, dtype=torch.float32)
    prob = dataclasses.replace(
        base, u0=torch.full((1,), X0, dtype=torch.float32),
        data={"rate": UniformTable1D(torch.tensor(r_curve,
                                                  dtype=torch.float32),
                                     0.0, float(tk[1] - tk[0]))},
        tspan=(0.0, T))
    res = solve_ensemble_local(EnsembleProblem(prob, N), alg="em",
                               ensemble="kernel", backend="cuda",
                               dt0=T / n_steps, n_steps=n_steps,
                               save_every=n_steps, seed=0, device=device)
    X = res.u_final[:, 0].double().cpu().numpy()
    r_bar = float(np.trapezoid(r_curve, tk) / T)   # exact: piecewise linear
    mean_exact = X0 * exp(r_bar * T)
    print(f"E[X_T]   MC = {X.mean():.5f}   term-structure analytic = "
          f"{mean_exact:.5f}   rel err = "
          f"{abs(X.mean() - mean_exact) / mean_exact:.2e}")
    K = 1.05
    bs, _ = black_scholes(K, r_bar, V)
    pay = np.maximum(X - K, 0.0)
    mc = float(pay.mean() * exp(-r_bar * T))
    se = float(pay.std() / sqrt(N))
    print(f"call(K={K}) MC = {mc:.5f} ± {se:.5f}   "
          f"Black-Scholes(r̄) = {bs:.5f}")
    # EM at dt = T/250 on a drifting-coefficient GBM: allow its bias
    assert abs(mc - bs) < 4 * se + 4e-3
    return mc


def pathwise_delta(N, device):
    """dC/dX0 = E[e^{-rT} 1{X_T > K} dX_T/dX0]: the adjoint through the
    fixed-dt kernel (forward on the card, the plain version replayed
    backward on the same counter stream) gives every path's dX_T/dX0."""
    K = 1.1
    prob = flat_gbm(torch.float64)
    ep = EnsembleProblem(prob, N, u0s=torch.full((N, 3), X0,
                                                 dtype=torch.float64))

    def price(res):
        return (torch.clamp(res.u_final[:, 0] - K, min=0.0).mean()
                * exp(-R * T))

    c, (g_u0, _) = ensemble_value_and_grad(
        price, ep, alg="em", ensemble="kernel", backend="cuda",
        dt0=T / n_steps, n_steps=n_steps, save_every=n_steps, seed=1,
        device=device)
    delta = float(g_u0[:, 0].sum())
    _, want = black_scholes(K, R, V)
    print(f"delta(K={K}) adjoint = {delta:.4f}   Black-Scholes N(d1) = "
          f"{want:.4f}   (price {float(c):.5f})")
    assert abs(delta - want) < 0.05
    return delta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=50_000)
    args = ap.parse_args(argv)
    constant_coefficient_pricing(args.n, args.device)
    market_data_pricing(args.n, args.device)
    delta = pathwise_delta(min(args.n, 20_000), args.device)
    print(f"{args.n:,} paths × {n_steps} steps through the fused kernels; "
          "the table and the adjoint ride the same front door (§6.6–§6.8).")
    return delta


if __name__ == "__main__":
    main()
