"""Method registry — `repro.core.methods` in PyTorch.

A `MethodSpec` describes an algorithm: its family (explicit RK,
Rosenbrock-stiff, or fixed-dt SDE stepper), the tableau or stepper that
drives the shared engine, and its capabilities.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from .tableaus import ROSENBROCK_TABLEAUS, TABLEAUS, RosenbrockTableau, Tableau

FAMILIES = ("erk", "rosenbrock", "sde")
STRATEGIES = ("vmap", "array", "array_eager", "kernel")
# "torch" is the plain lanes twin (the reference's "xla"); "cuda" the
# hand-written kernel (the reference's "pallas")
BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Declarative description of one solver algorithm.

    name:      canonical registry key.
    family:    one of FAMILIES.
    tableau:   Butcher tableau (erk).
    rtableau:  Rosenbrock W-method tableau (rosenbrock).
    stepper:   one-step function (sde).
    order:     order of the propagated solution (strong order for sde).
    adaptive:  the method can run with error control.  False for every sde
               stepper until the adaptive SDE engine is ported (ROADMAP
               queue 1 item 6); the reference marks them adaptive.
    stiff:     the method is linearly implicit (rosenbrock).
    w_reuse:   rosenbrock only — the method's default for the lazy-W path
               (Jacobian and LU(W) reuse across steps under a
               `repro_torch.core.controller.WReusePolicy`); False steps
               eagerly.  A solve overrides it with ``w_reuse=``.
    noise:     noise structures the stepper supports (sde).
    aliases:   alternative lookup names (paper-facing spellings).
    """

    name: str
    family: str
    order: float
    tableau: Optional[Tableau] = None
    rtableau: Optional[RosenbrockTableau] = None
    stepper: Optional[Callable] = None
    adaptive: bool = True
    stiff: bool = False
    w_reuse: bool = False
    noise: Tuple[str, ...] = ()
    aliases: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} not one of {FAMILIES}")
        if self.family == "erk" and self.tableau is None:
            raise ValueError(f"erk method {self.name!r} needs a tableau")
        if self.family == "rosenbrock" and self.rtableau is None:
            raise ValueError(
                f"rosenbrock method {self.name!r} needs an rtableau")
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


def _rosenbrock_spec(rtab: RosenbrockTableau, aliases=()) -> MethodSpec:
    return MethodSpec(name=rtab.name, family="rosenbrock", order=rtab.order,
                      rtableau=rtab, adaptive=bool((rtab.btilde != 0).any()),
                      stiff=True, aliases=aliases)


def get_method(alg: Any) -> MethodSpec:
    """Resolve `alg` (name, Tableau, RosenbrockTableau or MethodSpec) to a
    MethodSpec.  A bare tableau is wrapped as an ad-hoc spec of its
    family."""
    if isinstance(alg, MethodSpec):
        return alg
    if isinstance(alg, Tableau):
        return _erk_spec(alg)
    if isinstance(alg, RosenbrockTableau):
        return _rosenbrock_spec(alg)
    try:
        return _REGISTRY[alg]
    except (KeyError, TypeError):
        raise KeyError(
            f"unknown method {alg!r}; registered: {sorted(set(_REGISTRY))}")


def valid_dispatch(spec: MethodSpec, ensemble: str, backend: str = "torch", *,
                   adaptive: Optional[bool] = None,
                   w_reuse: bool = False) -> Tuple[bool, str]:
    """Is (strategy, backend) a combination the front door would accept?
    Returns ``(ok, reason)`` — the rules `solve_ensemble_local` enforces
    with exceptions, as a predicate."""
    if ensemble not in STRATEGIES:
        return False, f"unknown ensemble strategy {ensemble!r}"
    if backend not in BACKENDS:
        return False, f"unknown backend {backend!r}"
    if backend == "cuda" and ensemble != "kernel":
        return False, "backend='cuda' is kernel-strategy only"
    if spec.family != "erk" and ensemble == "array_eager":
        return False, f"array_eager is erk-only ({spec.family} family)"
    if w_reuse and spec.family != "rosenbrock":
        return False, "w_reuse is rosenbrock-only (no W to reuse)"
    if spec.family == "rosenbrock" and not spec.adaptive:
        return False, "rosenbrock engine requires an embedded pair"
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

    # Rosenbrock stiff family (paper §5.1.3 — GPURosenbrock23 / GPURodas4 /
    # GPURodas5P)
    rb_alias = {"rosenbrock23": ("rb23", "ode23s", "gpurosenbrock23"),
                "rodas4": ("gpurodas4",),
                "rodas5p": ("gpurodas5p", "rodas5")}
    for rtab in ROSENBROCK_TABLEAUS.values():
        register_method(_rosenbrock_spec(rtab, rb_alias.get(rtab.name, ())))

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
