"""Method registry — `repro.core.methods` in PyTorch.

A `MethodSpec` describes an algorithm: its family (explicit RK,
Rosenbrock-stiff, or SDE stepper), the tableau or stepper that
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
    adaptive:  the method can run with error control (an sde stepper
               opts in per solve with ``adaptive=True``: an embedded pair
               or step doubling, `core.sde.sde_solve_adaptive`).
    stiff:     the method is linearly implicit (rosenbrock).
    resumable: the method's engine exposes the per-lane segment carry
               (`core.ensemble.make_resumable_engine`) that the
               continuous-batching service (`repro_torch.serve`) moves lanes
               in and out of: every per-lane quantity (state, t, dt,
               controller memory, RNG counters, p, tf or n_steps) lives in
               the carry, and the loop body is an exact no-op on a retired
               lane, so a slot is refilled mid-stream bitwise as a fresh
               solve.  True for erk (fixed and adaptive) and for fixed-dt
               sde stepping; False for rosenbrock, whose lazy-W refresh
               gates are batch predicates that couple lanes (the service
               runs it as coalesced one-shot batches).
    events:    the method's engines support zero-crossing event handling
               with per-lane termination (`core.events`); True for every
               built-in method.
    w_reuse:   rosenbrock only — the method's default for the lazy-W path
               (Jacobian and LU(W) reuse across steps under a
               `repro_torch.core.controller.WReusePolicy`); False steps
               eagerly.  A solve overrides it with ``w_reuse=``.
    noise:     noise structures the stepper supports (sde).
    embedded:  sde only — the stepper's embedded error pair
               (`core.sde.EmbeddedPair`), or None.
    error_est: sde only — the adaptive error estimators it supports,
               derived when left empty: ("embedded", "doubling") with a
               pair, else ("doubling",).
    data_rhs:  the method's engines accept data-driven problems
               (``prob.data``, tables the callbacks take as a fourth
               argument); True for every built-in method.  A method whose
               engine cannot consume them declares False and the front door
               refuses data-driven problems up front.
    differentiable: the method's engines satisfy the AD contract (finished
               lanes are exact no-ops, the bounded loop equals the while
               loop, rejected attempts stay out of the differentiated
               graph); True for every built-in method.  The supported
               ``sensitivity`` modes derive from it.
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
    resumable: bool = False
    events: bool = True
    w_reuse: bool = False
    noise: Tuple[str, ...] = ()
    embedded: Optional[Any] = None
    error_est: Tuple[str, ...] = ()
    data_rhs: bool = True
    differentiable: bool = True
    aliases: Tuple[str, ...] = ()

    @property
    def sensitivity(self) -> Tuple[str, ...]:
        """Supported sensitivity modes, derived from `differentiable`."""
        return ("forward", "adjoint") if self.differentiable else ()

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
        if self.embedded is not None and self.family != "sde":
            raise ValueError(
                f"method {self.name!r}: `embedded` pairs are an sde-family "
                "capability (erk/rosenbrock embed via their tableaus)")
        if self.family == "sde" and self.adaptive and not self.error_est:
            # the capability tuple, derived from what shipped
            object.__setattr__(
                self, "error_est",
                ("embedded", "doubling") if self.embedded is not None
                else ("doubling",))
        if "embedded" in self.error_est and self.embedded is None:
            raise ValueError(
                f"method {self.name!r} declares error_est='embedded' but "
                "ships no embedded pair (see repro_torch.core.sde."
                "SDE_EMBEDDED)")


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
                      resumable=True, aliases=aliases)


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
                   adaptive: Optional[bool] = None, events: bool = False,
                   w_reuse: bool = False, error_est: Optional[str] = None,
                   data: bool = False,
                   sensitivity: Optional[str] = None) -> Tuple[bool, str]:
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
    if events and not spec.events:
        return False, f"method {spec.name!r} declares events=False"
    if events and ensemble == "array_eager":
        return False, "events are not supported on array_eager"
    if events and spec.family == "erk" and ensemble == "array":
        return False, ("events need per-trajectory control; the erk array "
                       "strategy steps every trajectory with one dt")
    if w_reuse and spec.family != "rosenbrock":
        return False, "w_reuse is rosenbrock-only (no W to reuse)"
    if data and not spec.data_rhs:
        return False, (f"method {spec.name!r} declares data_rhs=False "
                       "(no data-driven RHS support)")
    if spec.family == "rosenbrock" and not spec.adaptive:
        return False, "rosenbrock engine requires an embedded pair"
    if adaptive and not spec.adaptive:
        return False, f"method {spec.name!r} has no adaptive step control"
    if error_est is not None:
        if spec.family != "sde":
            return False, "error_est is an adaptive-SDE knob"
        if error_est not in spec.error_est:
            return False, (f"method {spec.name!r} supports error_est "
                           f"{spec.error_est}, not {error_est!r}")
    if sensitivity is not None:
        if sensitivity not in ("forward", "adjoint"):
            return False, (f"unknown sensitivity {sensitivity!r} "
                           "(use 'forward' or 'adjoint')")
        if sensitivity not in spec.sensitivity:
            return False, (f"method {spec.name!r} declares "
                           "differentiable=False")
        if ensemble == "array_eager":
            return False, ("array_eager is a host-driven python loop with "
                           "host step control, so not differentiable")
        if sensitivity == "forward" and backend == "cuda":
            return False, ("forward sensitivities ride jvp through the "
                           "while-loop engines; the CUDA kernels support "
                           "sensitivity='adjoint' (autograd.Function "
                           "boundary) only")
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

    # SDE steppers: fixed dt by default (the paper's GPU kernel set);
    # adaptive=True records that every stepper gains error control when a
    # solve opts in: its embedded pair where one ships (em, milstein), step
    # doubling everywhere (also the general-noise path)
    from .sde import (SDE_EMBEDDED, em_step, heun_strat_step, milstein_step,
                      platen_w2_step)
    sde = dict(family="sde", adaptive=True, resumable=True)
    register_method(MethodSpec(
        name="em", order=0.5, stepper=em_step, noise=("diagonal", "general"),
        embedded=SDE_EMBEDDED["em"], aliases=("gpuem", "euler_maruyama"),
        **sde))
    register_method(MethodSpec(
        name="platen_w2", order=2.0, stepper=platen_w2_step,
        noise=("diagonal",), aliases=("siea", "gpusiea"), **sde))
    register_method(MethodSpec(
        name="heun_strat", order=0.5, stepper=heun_strat_step,
        noise=("diagonal", "general"), **sde))
    register_method(MethodSpec(
        name="milstein", order=1.0, stepper=milstein_step,
        noise=("diagonal",), embedded=SDE_EMBEDDED["milstein"], **sde))


_register_builtins()
