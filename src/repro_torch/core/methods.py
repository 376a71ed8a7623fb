"""Method registry — the erk and sde families of `repro.core.methods`.

A `MethodSpec` describes an algorithm: its family, the tableau or stepper
that drives the shared engine, and its capabilities.  The port carries the
explicit-RK family and the fixed-dt SDE steppers; a Rosenbrock name raises
`NotImplementedError` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from .tableaus import ROSENBROCK_TABLEAUS, TABLEAUS, RosenbrockTableau, Tableau

FAMILIES = ("erk", "sde")
STRATEGIES = ("vmap", "array", "array_eager", "kernel")
# "torch" is the plain lanes twin (the reference's "xla"); "cuda" the
# hand-written kernel (the reference's "pallas")
BACKENDS = ("torch", "cuda")

_NOT_PORTED = {
    "rosenbrock": "ROADMAP queue 1 item 5 (core/rosenbrock.py with the "
                  "kernels/lu twins)",
}
_ROSENBROCK_ALIASES = ("rb23", "ode23s", "gpurosenbrock23", "gpurodas4",
                       "gpurodas5p", "rodas5")


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Declarative description of one solver algorithm.

    name:      canonical registry key.
    family:    one of FAMILIES.
    tableau:   Butcher tableau (erk).
    stepper:   one-step function (sde).
    order:     order of the propagated solution (strong order for sde).
    adaptive:  the method can run with error control.  False for every sde
               stepper until the adaptive SDE engine is ported (ROADMAP
               queue 1 item 6); the reference marks them adaptive.
    noise:     noise structures the stepper supports (sde).
    aliases:   alternative lookup names (paper-facing spellings).
    """

    name: str
    family: str
    order: float
    tableau: Optional[Tableau] = None
    stepper: Optional[Callable] = None
    adaptive: bool = True
    noise: Tuple[str, ...] = ()
    aliases: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} not one of {FAMILIES}")
        if self.family == "erk" and self.tableau is None:
            raise ValueError(f"erk method {self.name!r} needs a tableau")
        if self.family == "sde" and self.stepper is None:
            raise ValueError(f"sde method {self.name!r} needs a stepper")


_REGISTRY: Dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec) -> MethodSpec:
    """Register `spec` under its name and every alias."""
    for key in (spec.name,) + spec.aliases:
        if key in _REGISTRY:
            raise ValueError(f"method {key!r} already registered")
        _REGISTRY[key] = spec
    return spec


def _erk_spec(tab: Tableau, aliases=()) -> MethodSpec:
    return MethodSpec(name=tab.name, family="erk", order=tab.order,
                      tableau=tab, adaptive=bool((tab.btilde != 0).any()),
                      aliases=aliases)


def get_method(alg: Any) -> MethodSpec:
    """Resolve `alg` (name, Tableau, or MethodSpec) to a MethodSpec.  A bare
    Tableau is wrapped as an ad-hoc erk spec."""
    if isinstance(alg, MethodSpec):
        return alg
    if isinstance(alg, Tableau):
        return _erk_spec(alg)
    if isinstance(alg, RosenbrockTableau) or alg in ROSENBROCK_TABLEAUS \
            or alg in _ROSENBROCK_ALIASES:
        raise NotImplementedError(
            f"stiff method {getattr(alg, 'name', alg)!r} is not ported yet: "
            + _NOT_PORTED["rosenbrock"])
    try:
        return _REGISTRY[alg]
    except (KeyError, TypeError):
        raise KeyError(
            f"unknown method {alg!r}; registered: {sorted(set(_REGISTRY))}")


def valid_dispatch(spec: MethodSpec, ensemble: str, backend: str = "torch", *,
                   adaptive: Optional[bool] = None) -> Tuple[bool, str]:
    """Is (strategy, backend) a combination the front door would accept?
    Returns ``(ok, reason)`` — the rules `solve_ensemble_local` enforces
    with exceptions, as a predicate."""
    if ensemble not in STRATEGIES:
        return False, f"unknown ensemble strategy {ensemble!r}"
    if backend not in BACKENDS:
        return False, f"unknown backend {backend!r}"
    if backend == "cuda" and ensemble != "kernel":
        return False, "backend='cuda' is kernel-strategy only"
    if spec.family == "sde" and ensemble == "array_eager":
        return False, "sde methods run on 'vmap', 'array' and 'kernel'"
    if adaptive and not spec.adaptive:
        return False, f"method {spec.name!r} has no adaptive step control"
    return True, "ok"


def list_methods():
    """Canonical (deduplicated) specs."""
    seen = {spec.name: spec for spec in _REGISTRY.values()}
    return [seen[k] for k in sorted(seen)]


def _register_builtins():
    paper_alias = {"tsit5": ("gputsit5",), "vern7": ("gpuvern7",)}
    for tab in TABLEAUS.values():
        register_method(_erk_spec(tab, paper_alias.get(tab.name, ())))

    # SDE steppers, fixed-dt (the paper's GPU kernel set)
    from .sde import em_step, heun_strat_step, milstein_step, platen_w2_step
    sde = dict(family="sde", adaptive=False)
    register_method(MethodSpec(
        name="em", order=0.5, stepper=em_step, noise=("diagonal", "general"),
        aliases=("gpuem", "euler_maruyama"), **sde))
    register_method(MethodSpec(
        name="platen_w2", order=2.0, stepper=platen_w2_step,
        noise=("diagonal",), aliases=("siea", "gpusiea"), **sde))
    register_method(MethodSpec(
        name="heun_strat", order=0.5, stepper=heun_strat_step,
        noise=("diagonal", "general"), **sde))
    register_method(MethodSpec(
        name="milstein", order=1.0, stepper=milstein_step,
        noise=("diagonal",), **sde))


_register_builtins()
