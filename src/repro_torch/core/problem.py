"""Problem definitions: the user-facing, solver-agnostic description of a DE.

The PyTorch counterpart of `repro.core.problem`.  The user writes
``f(u, p, t)`` once, in *component style* (index ``u[0], u[1], ...`` and
combine with ``torch.stack``), so the same definition broadcasts over
``u: (n,)``, ``u: (n, N)`` and ``u: (n, B)`` lane tiles.  The fused CUDA
kernels cannot call a Python ``f``: a registered RHS reaches them through
the hand-written device functor it is registered with
(`repro_torch.kernels.tsit5.kernel.device_rhs` and kin), any other through
the automated translation (`repro_torch.translate`), which traces ``f``
once into a device functor and compiles the kernel for it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ODEProblem:
    """du/dt = f(u, p, t) on t ∈ tspan, u(t0) = u0.

    f: component-style RHS, shape-polymorphic over trailing lane dims.
    u0: (n,) initial condition template.
    p:  (m,) parameter template.
    jac: optional analytic Jacobian ∂f/∂u, component style like f: returns
        (n, n) for u (n,) and (n, n, B) for a lane tile u (n, B).  None
        means the stiff solvers take it by forward-mode AD
        (`torch.func.jacfwd`).  The CUDA kernel takes the Jacobian of the
        device functor the RHS is registered with; for a translated RHS, the
        hook traced, or, without one, the Jacobian derived from the traced
        ``f`` by forward mode (`repro_torch.translate.derive`).
    data: dataset tables (a dict pytree of `core.interp.UniformTable1D` /
        `UniformTable2D`) the callbacks take as a fourth argument,
        ``f(u, p, t, data)`` (and ``jac(u, p, t, data)``); None for a plain
        3-argument problem.  The CUDA kernels read the tables on the card
        through the data functor the RHS is registered with.
    """

    f: Callable[[Tensor, Tensor, Tensor], Tensor]
    u0: Tensor
    p: Tensor
    tspan: Tuple[float, float]
    name: str = "ode"
    jac: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None
    data: Optional[Any] = None

    @property
    def n_states(self) -> int:
        return int(self.u0.shape[0])

    @property
    def n_params(self) -> int:
        return int(self.p.shape[0])


@dataclasses.dataclass(frozen=True)
class SDEProblem:
    """dX = f(X,p,t) dt + g(X,p,t) dW.

    noise:
      "diagonal":     g returns (n,)   — one Wiener process per state.
      "general":      g returns (n, m) — m Wiener processes, dense coupling.
    data: as on ODEProblem: f and g take it as a fourth argument.

    The CUDA kernel runs the pair (f, g) through the device functor both are
    registered with (`repro_torch.kernels.em.kernel.device_sde`), or through
    the functor the automated translation makes of them
    (`repro_torch.translate`; Milstein's (∂g/∂u)·g derived).
    """

    f: Callable[[Tensor, Tensor, Tensor], Tensor]
    g: Callable[[Tensor, Tensor, Tensor], Tensor]
    u0: Tensor
    p: Tensor
    tspan: Tuple[float, float]
    noise: str = "diagonal"
    n_noise: Optional[int] = None  # m; defaults to n for diagonal
    name: str = "sde"
    data: Optional[Any] = None

    @property
    def n_states(self) -> int:
        return int(self.u0.shape[0])

    @property
    def n_params(self) -> int:
        return int(self.p.shape[0])

    def noise_dim(self) -> int:
        if self.n_noise is not None:
            return self.n_noise
        return self.n_states


@dataclasses.dataclass(frozen=True)
class EnsembleProblem:
    """N independent copies of `prob`, varying (u0, p) per trajectory.

    u0s: (N, n) or None (broadcast prob.u0)
    ps:  (N, m) or None (broadcast prob.p)
    """

    prob: Any
    n_trajectories: int
    u0s: Optional[Tensor] = None
    ps: Optional[Tensor] = None

    def materialize(self):
        N = self.n_trajectories
        u0s, ps = self.u0s, self.ps
        if u0s is None:
            u0s = self.prob.u0.expand((N,) + tuple(self.prob.u0.shape))
        if ps is None:
            ps = self.prob.p.expand((N,) + tuple(self.prob.p.shape))
        return u0s, ps


def bind_data(fn, data):
    """A 4-argument callback ``fn(u, p, t, data)`` closed over `data`, or
    `fn` itself without data."""
    if data is None:
        return fn
    return lambda u, p, t: fn(u, p, t, data)


def bind_problem_data(prob, data=None):
    """Close the problem's callbacks over its dataset.

    Returns a problem whose f / g / jac are plain 3-argument ``(u, p, t)``
    callables again (``data=None``), with the dataset captured by closure:
    the engines (`solvers`, `rosenbrock`, `sde`) never learn about data.
    `data` overrides `prob.data` when given (the kernels' plain versions
    re-bind with tables rebuilt from their leaves); a problem without data
    is returned unchanged."""
    d = prob.data if data is None else data
    if d is None:
        return prob
    rep = {"data": None, "f": bind_data(prob.f, d)}
    for name in ("jac", "g"):
        if getattr(prob, name, None) is not None:
            rep[name] = bind_data(getattr(prob, name), d)
    return dataclasses.replace(prob, **rep)
