"""Butcher order conditions via rooted trees — the tableau verifier,
`repro.core.order_conditions` in numpy.

A Runge-Kutta pair (A, b, c) has order p iff for every rooted tree t with
order r(t) <= p the elementary weight matches the tree density:

    Phi(t) = b . u(t) = 1 / gamma(t),   u([t1..tk])_i = prod_j (A u(tj))_i,
    u(tau) = 1,   gamma(tau) = 1,   gamma(t) = r(t) * prod_j gamma(tj).

(Butcher 1963; Hairer-Norsett-Wanner I.II.2.)  This module enumerates the
trees (1, 1, 2, 4, 9, 20, 48, 115, 286 trees for orders 1..9) and evaluates
every condition numerically, which is how the shipped high-order tableaus
(the 10-stage Vern7 and the 26-stage extrapolation pair GBS10) are
verified rather than trusted: a single wrong coefficient breaks dozens of
the nonlinear conditions at once.  A user tableau (a `Tableau` or
`RosenbrockTableau` of `repro_torch.core.tableaus`, e.g. from
`repro_torch.convert.tableau_from_arrays`) is checked the same way.

The tableaus keep their coefficients as float64 numpy arrays, and every
residual is the same numpy arithmetic as the reference's, so the two agree
bit for bit.

>>> from repro_torch.core.tableaus import TSIT5
>>> max_order_condition_residual(TSIT5, 5) < 1e-12
True
>>> count_trees(7)      # number of order conditions for a 7th-order method
85
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, Tuple

import numpy as np

# A rooted tree is a canonical (sorted) tuple of its root's subtrees; the
# single-node tree is the empty tuple ().
Tree = Tuple[Any, ...]


@lru_cache(maxsize=None)
def _forests(total: int) -> Tuple[Tree, ...]:
    """All multisets of rooted trees whose orders sum to `total` (each multiset
    sorted canonically so duplicates collapse)."""
    if total == 0:
        return ((),)
    out = set()
    for k in range(1, total + 1):
        for t in rooted_trees(k):
            for rest in _forests(total - k):
                out.add(tuple(sorted((t,) + rest)))
    return tuple(sorted(out))


@lru_cache(maxsize=None)
def rooted_trees(order: int) -> Tuple[Tree, ...]:
    """All rooted trees with exactly `order` nodes (canonical form)."""
    if order < 1:
        return ()
    return tuple(_forests(order - 1))


def count_trees(max_order: int) -> int:
    """Total number of order conditions for a method of order `max_order`."""
    return sum(len(rooted_trees(r)) for r in range(1, max_order + 1))


def tree_order(t: Tree) -> int:
    return 1 + sum(tree_order(s) for s in t)


def tree_density(t: Tree) -> int:
    g = tree_order(t)
    for s in t:
        g *= tree_density(s)
    return g


def _stage_vector(t: Tree, A: np.ndarray,
                  cache: Dict[Tree, np.ndarray]) -> np.ndarray:
    """u(t): the per-stage elementary-weight vector (Phi(t) = b . u(t)).
    Only A enters — the nodes c appear implicitly as A's row sums."""
    if t in cache:
        return cache[t]
    u = np.ones(A.shape[0])
    for s in t:
        u = u * (A @ _stage_vector(s, A, cache))
    cache[t] = u
    return u


def order_condition_residuals(A, b, c, order: int):
    """[(tree, b.u(t) - 1/gamma(t))] for every tree of order <= `order`."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    cache: Dict[Tree, np.ndarray] = {}
    out = []
    for r in range(1, order + 1):
        for t in rooted_trees(r):
            phi = float(b @ _stage_vector(t, A, cache))
            out.append((t, phi - 1.0 / tree_density(t)))
    return out


def max_order_condition_residual(tab, order: int, embedded: bool = False):
    """Largest |Phi(t) - 1/gamma(t)| over all trees of order <= `order`.

    embedded=True checks the lower-order weights bhat = b - btilde instead
    (the error-estimator solution of the pair).
    """
    b = tab.b - tab.btilde if embedded else tab.b
    res = order_condition_residuals(tab.a, b, tab.c, order)
    return max(abs(r) for _, r in res)


def stage_consistency_residual(tab) -> float:
    """max_i |c_i - sum_j a_ij|: the row-sum (internal consistency) condition
    every shipped tableau satisfies by construction."""
    return float(np.max(np.abs(np.asarray(tab.c)
                               - np.asarray(tab.a).sum(axis=1))))


# ---------------------------------------------------------------------------
# Rosenbrock (W-method) order conditions — the stiff-family verifier.
#
# A Rosenbrock method in k-form,
#
#     k_i = h f(y0 + Σ_j α_ij k_j) + h J Σ_j Γ_ij k_j + h² γ_i f_t,
#     y1  = y0 + Σ_i b_i k_i,          J = f'(y0),   Γ_ii = γ,
#
# has order p iff  b · φ(t) = 1/γ(t)  for every rooted tree of order ≤ p,
# where the stage vectors φ follow the RK recursion EXCEPT that singly-
# branched nodes also pick up the Jacobian term (Hairer-Wanner IV.7):
#
#     φ(τ) = 1
#     φ([t1])        = (α + Γ) φ(t1)        (f'-chains see β = α + Γ)
#     φ([t1..tk]), k≥2 = Π_l (α φ(t_l))     (higher derivatives: α only)
#
# Shipped tableaus are stored in the IMPLEMENTATION form (a, C, b, d) that
# the engine executes (one factorization of W = I − γh·J per step); the
# checker inverts that transform —  Γ = (I/γ − C)⁻¹, α = a Γ, b_k = b Γ —
# so what is verified is exactly what runs.  Non-autonomous correctness
# reduces to the autonomous conditions iff c = rowsum(α) and d = rowsum(Γ)
# (autonomization invariance), checked by `rosenbrock_consistency_residual`.
# ---------------------------------------------------------------------------


def rosenbrock_kform(rtab) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Invert the implementation transform: returns (alpha, Gamma, b_k,
    btilde_k) of the textbook k-form."""
    a = np.asarray(rtab.a, np.float64)
    C = np.asarray(rtab.C, np.float64)
    s = a.shape[0]
    Gamma = np.linalg.inv(np.eye(s) / rtab.gamma - C)
    return (a @ Gamma, Gamma, np.asarray(rtab.b, np.float64) @ Gamma,
            np.asarray(rtab.btilde, np.float64) @ Gamma)


def _rb_stage_vector(t: Tree, alpha: np.ndarray, beta: np.ndarray,
                     cache: Dict[Tree, np.ndarray]) -> np.ndarray:
    if t in cache:
        return cache[t]
    if len(t) == 1:
        u = beta @ _rb_stage_vector(t[0], alpha, beta, cache)
    else:
        u = np.ones(alpha.shape[0])
        for s in t:
            u = u * (alpha @ _rb_stage_vector(s, alpha, beta, cache))
    cache[t] = u
    return u


def rosenbrock_order_condition_residuals(rtab, order: int,
                                         embedded: bool = False):
    """[(tree, b·φ(t) − 1/γ(t))] over every rooted tree of order ≤ `order`."""
    alpha, Gamma, b_k, btilde_k = rosenbrock_kform(rtab)
    b = b_k - btilde_k if embedded else b_k
    beta = alpha + Gamma
    cache: Dict[Tree, np.ndarray] = {}
    out = []
    for r in range(1, order + 1):
        for t in rooted_trees(r):
            phi = float(b @ _rb_stage_vector(t, alpha, beta, cache))
            out.append((t, phi - 1.0 / tree_density(t)))
    return out


def max_rosenbrock_condition_residual(rtab, order: int,
                                      embedded: bool = False) -> float:
    """Largest Rosenbrock order-condition residual over trees of order ≤
    `order` (embedded=True checks the error-estimator weights b − btilde).

    >>> from repro_torch.core.tableaus import RODAS4, RODAS5P
    >>> max_rosenbrock_condition_residual(RODAS4, 4) < 1e-12
    True
    >>> max_rosenbrock_condition_residual(RODAS5P, 5) < 1e-12
    True
    >>> max_rosenbrock_condition_residual(RODAS4, 3, embedded=True) < 1e-12
    True
    """
    res = rosenbrock_order_condition_residuals(rtab, order, embedded)
    return max(abs(r) for _, r in res)


def rosenbrock_consistency_residual(rtab) -> float:
    """max of |c − rowsum(α)| and |d − rowsum(Γ)| — the autonomization
    conditions that make the f_t/abscissae data consistent with the
    autonomous order conditions."""
    alpha, Gamma, _, _ = rosenbrock_kform(rtab)
    return float(max(
        np.max(np.abs(np.asarray(rtab.c) - alpha.sum(axis=1))),
        np.max(np.abs(np.asarray(rtab.d) - Gamma.sum(axis=1)))))


def elementary_weight_matrix(A, c, order: int) -> Tuple[np.ndarray, np.ndarray,
                                                        List[Tree]]:
    """(U, rhs, trees) with U[k] = u(t_k) and rhs[k] = 1/gamma(t_k) for every
    tree of order <= `order` — the order conditions as a LINEAR system in the
    quadrature weights b.  Used to cross-validate shipped b/btilde data: with
    A and c fixed, `U b = rhs` pins b down completely (least squares residual
    ~0 iff (A, c) genuinely admit a method of that order)."""
    A = np.asarray(A, np.float64)
    cache: Dict[Tree, np.ndarray] = {}
    rows, rhs, ts = [], [], []
    for r in range(1, order + 1):
        for t in rooted_trees(r):
            rows.append(_stage_vector(t, A, cache))
            rhs.append(1.0 / tree_density(t))
            ts.append(t)
    return np.asarray(rows), np.asarray(rhs), ts
