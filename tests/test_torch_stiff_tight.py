"""ROBER through the port's front door at tests/test_stiff.py:118-157's
settings (N = 3, t ∈ [0, 1e4], dt0 1e-6, rtol 1e-8, atol 1e-10), held to
that test's acceptance bar: every strategy, eager and lazy-W, within rtol
1e-6 and atol 1e-14 of the reference's ``vmap`` solve, y1 + y2 + y3
within 1e-7 of 1, status 0.

Per-lane step counts are not held here: at this tolerance the step-size
sequence follows rounding.  rodas4 lazy-W's counts differ even between the
reference's own LAPACK and lanes-LU routes (472/535/609 against 462/544/610
accepted steps).  On rodas5p eager, the port's lanes LU (``linsolve="lanes"``
and ``"cuda"``, the kernel's twin) takes lane 3 in 233 accepted steps and
no rejection, where every route of the reference takes 234 and one.  The
tests at the end of this file find the cause:

- XLA's CPU backend fuses each ``a - m * r`` of the reference's lanes LU
  into one fused multiply-add; the port rounds the product and the
  difference on their own, as its CUDA kernel does.
- Fusing only the back substitution's ``acc - rows[i][j] * x[j]`` in the
  port gives every lane the reference's counts, as fusing all three
  updates does.
- The LU's rounding does not bias a step: at the port's own inputs, its
  error estimate is within 5e-7 relative of the one in exact rational
  arithmetic on lane 3's attempts 118-121 (held to 1e-5).  The
  trajectories part by rounding, and step-size control amplifies that
  until attempt 120 proposes a different dt.  There the port's estimate
  is 0.651 (accept); the port with the fused back substitution, at its
  own inputs, estimates 1.44 (reject).

Worst state difference measured here: that lane's Hermite dense output at
t = 100, at 97% of the bar (9.8e-8 of the lane's largest value); every
other case stays under 3.4% of it, and the reference's own routes under
1.4%.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.de_problems import rober_ensemble as j_rober_ensemble
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro_torch.configs.de_problems import rober_problem
from repro_torch.convert import ensemble_problem
from repro_torch.core.controller import hairer_norm
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.tableaus import RODAS5P

SAVEAT = np.array([1e-2, 1.0, 1e2, 1e4])
STRATEGIES = [("vmap", "torch", "torch"), ("array", "torch", "torch"),
              ("array", "torch", "cuda"), ("kernel", "torch", "torch"),
              ("kernel", "cuda", "torch")]
ID = lambda s: "/".join(s) if isinstance(s, tuple) else s


def _kw(alg, w_reuse):
    return dict(alg=alg, dt0=1e-6, rtol=1e-8, atol=1e-10, saveat=SAVEAT,
                w_reuse=w_reuse)


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(alg, w_reuse):
        if (alg, w_reuse) not in cache:
            ens = j_rober_ensemble(3, tspan=(0.0, 1e4))
            res = jsolve(ens, ensemble="vmap", backend="xla",
                         **dict(_kw(alg, w_reuse), saveat=jnp.asarray(SAVEAT)))
            u0s, ps = (np.asarray(x) for x in ens.materialize())
            cache[alg, w_reuse] = (u0s, ps, res)
        return cache[alg, w_reuse]

    return get


@pytest.mark.parametrize("strategy", STRATEGIES, ids=ID)
@pytest.mark.parametrize("w_reuse", [False, True], ids=["eager", "lazy-W"])
@pytest.mark.parametrize("alg", ["rodas4", "rodas5p"])
def test_rober_tight_tolerance_meets_the_reference_bar(reference, alg,
                                                        w_reuse, strategy):
    ensemble, backend, linsolve = strategy
    u0s, ps, want = reference(alg, w_reuse)
    ep = ensemble_problem(rober_problem(tspan=(0.0, 1e4)), u0s, ps)
    got = tsolve(ep, ensemble=ensemble, backend=backend, linsolve=linsolve,
                 device="cpu", **_kw(alg, w_reuse))
    assert int(got.status) == 0
    for g, w in ((got.us, want.us), (got.u_final, want.u_final)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-14)
    np.testing.assert_allclose(got.u_final.numpy().sum(axis=1), 1.0,
                               rtol=1e-7)
    attempts = int((got.naccept + got.nreject).sum())
    if not w_reuse:
        assert int(got.njac) == int(got.nfact) == attempts


# ---------------------------------------------------------------------------
# Why one rodas5p lane takes one step fewer than the reference
# ---------------------------------------------------------------------------

def _fused_sub(a, m, r):
    """a - m * r rounded once, as one fused multiply-add rounds it."""
    out = [float(Fraction(x) - Fraction(y) * Fraction(z))
           for x, y, z in zip(a.tolist(), m.tolist(), r.tolist())]
    return torch.tensor(out, dtype=a.dtype)


def _lu_lanes(elim, fwd, back):
    """The port's plain lanes LU with the chosen `a - m * r` updates fused:
    the elimination's, the forward substitution's, the back
    substitution's."""
    sub = lambda fused, a, m, r: _fused_sub(a, m, r) if fused else a - m * r

    def factor(W, pivot=True):
        n = W.shape[0]
        rows, swaps, mults = [W[i] for i in range(n)], [], []
        for k in range(n):
            if k < n - 1:
                piv = torch.stack([rows[i][k].abs()
                                   for i in range(k, n)]).argmax(0) + k
                for i in range(k + 1, n):
                    sel = (piv == i)[None]
                    rows[k], rows[i] = (torch.where(sel, rows[i], rows[k]),
                                        torch.where(sel, rows[k], rows[i]))
                swaps.append(piv)
            inv = 1.0 / rows[k][k]
            mults.append([rows[i][k] * inv for i in range(k + 1, n)])
            for i in range(k + 1, n):
                rows[i] = torch.stack([
                    sub(elim, rows[i][c], mults[k][i - k - 1], rows[k][c])
                    for c in range(n)])
        return rows, swaps, mults, None

    def resolve(fac, b):
        rows, swaps, mults, _ = fac
        n = len(rows)
        rhs = [b[i] for i in range(n)]
        for k in range(n):
            if k < n - 1:
                for i in range(k + 1, n):
                    sel = swaps[k] == i
                    rhs[k], rhs[i] = (torch.where(sel, rhs[i], rhs[k]),
                                      torch.where(sel, rhs[k], rhs[i]))
            for i in range(k + 1, n):
                rhs[i] = sub(fwd, rhs[i], mults[k][i - k - 1], rhs[k])
        xs = [None] * n
        for i in reversed(range(n)):
            acc = rhs[i]
            for j in range(i + 1, n):
                acc = sub(back, acc, rows[i][j], xs[j])
            xs[i] = acc / rows[i][i]
        return torch.stack(xs)

    return factor, resolve


def test_reference_lanes_lu_fuses_every_multiply_subtract():
    """The reference's lanes LU under jit on the CPU equals, bit for bit,
    the port's with every `a - m * r` rounded once; the port's plain
    version rounds the product on its own and differs on most systems."""
    from repro.kernels.lu.kernel import lu_solve_lanes as j_lu_solve_lanes
    from repro_torch.kernels.lu.kernel import lu_solve_lanes
    rng = np.random.default_rng(1)
    W, b = rng.standard_normal((3, 3, 256)), rng.standard_normal((3, 256))
    want = np.asarray(jax.jit(j_lu_solve_lanes)(jnp.asarray(W),
                                                jnp.asarray(b)))
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)
    factor, resolve = _lu_lanes(True, True, True)
    np.testing.assert_array_equal(resolve(factor(Wt), bt).numpy(), want)
    plain = lu_solve_lanes(Wt, bt).numpy()
    assert (plain != want).any(axis=0).mean() > 0.5
    np.testing.assert_allclose(plain, want, rtol=1e-12)


def _lanes_run(u0s, ps, monkeypatch):
    """rodas5p eager on the lanes LU, recording at each attempt lane 3's
    inputs (u, p, dt) and its error estimate."""
    import repro_torch.core.rosenbrock as rb
    seen, step = [], rb.rosenbrock_step

    def record(f, rtab, u, p, t, dt, **kw):
        out = step(f, rtab, u, p, t, dt, **kw)
        seen.append((u[:, 2], p[:, 2], dt[2],
                     float(hairer_norm(out[1], u, out[0], 1e-10, 1e-8,
                                       dim=0)[2])))
        return out

    monkeypatch.setattr(rb, "rosenbrock_step", record)
    ep = ensemble_problem(rober_problem(tspan=(0.0, 1e4)), u0s, ps)
    got = tsolve(ep, ensemble="array", linsolve="lanes", device="cpu",
                 **_kw("rodas5p", False))
    return got, seen


@pytest.mark.parametrize("fused", [(False, False, True), (True, True, True)],
                         ids=["back", "all"])
def test_rodas5p_counts_equal_the_reference_with_the_fused_back_substitution(
        reference, monkeypatch, fused):
    import repro_torch.kernels.lu.kernel as lu_kernel
    u0s, ps, want = reference("rodas5p", False)
    factor, resolve = _lu_lanes(*fused)
    monkeypatch.setattr(lu_kernel, "lu_factor_lanes", factor)
    monkeypatch.setattr(lu_kernel, "lu_resolve_lanes", resolve)
    got, seen = _lanes_run(u0s, ps, monkeypatch)
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    # the attempt that lane 3 rejects, where the plain lanes LU accepts
    assert seen[120][3] > 1.0


def _exact_rodas5p_err(u, p, dt, rtol, atol):
    """The rodas5p error estimate of one ROBER step from u (3,) at step dt,
    in exact rational arithmetic on the same float inputs and tableau."""
    F = lambda v: [Fraction(float(x)) for x in v]
    u, (k1, k2, k3), dt = F(u), F(p), Fraction(float(dt))
    tab = RODAS5P
    gam = Fraction(float(tab.gamma))
    f = lambda y: [-k1 * y[0] + k3 * y[1] * y[2],
                   k1 * y[0] - k2 * y[1] ** 2 - k3 * y[1] * y[2],
                   k2 * y[1] ** 2]
    J = [[-k1, k3 * u[2], k3 * u[1]],
         [k1, -2 * k2 * u[1] - k3 * u[2], -k3 * u[1]],
         [0, 2 * k2 * u[1], 0]]
    W = [[(i == j) - gam * dt * J[i][j] for j in range(3)] for i in range(3)]

    def solve(rhs):
        A = [row[:] + [r] for row, r in zip(W, rhs)]
        for k in range(3):
            piv = next(i for i in range(k, 3) if A[i][k] != 0)
            A[k], A[piv] = A[piv], A[k]
            for i in range(k + 1, 3):
                m = A[i][k] / A[k][k]
                A[i] = [a - m * c for a, c in zip(A[i], A[k])]
        x = [0] * 3
        for i in reversed(range(3)):
            x[i] = (A[i][3] - sum(A[i][j] * x[j]
                                  for j in range(i + 1, 3))) / A[i][i]
        return x

    Us = []
    for i in range(tab.stages):
        g = [u[c] + sum(Fraction(float(tab.a[i, j])) * Us[j][c]
                        for j in range(i)) for c in range(3)]
        Fi = f(g)
        Us.append(solve([gam * dt * Fi[c]
                         + sum(gam * Fraction(float(tab.C[i, j])) * Us[j][c]
                               for j in range(i)) for c in range(3)]))
    comb = lambda w: [sum(Fraction(float(w[i])) * Us[i][c]
                          for i in range(tab.stages)) for c in range(3)]
    u1 = [a + b for a, b in zip(u, comb(tab.b))]
    err = comb(tab.btilde)
    scale = [Fraction(atol) + max(abs(a), abs(b)) * Fraction(rtol)
             for a, b in zip(u, u1)]
    return float(sum((e / s) ** 2 for e, s in zip(err, scale)) / 3) ** 0.5


def test_rodas5p_error_estimate_is_exact_at_the_ports_own_inputs(
        reference, monkeypatch):
    """On lane 3's attempts around the one the reference rejects, the
    port's lanes-LU error estimate is within 1e-5 relative of the exact one
    at the same inputs: the count difference is step-size control amplifying a rounding-level
    parting of the trajectories, not a biased step."""
    u0s, ps, _ = reference("rodas5p", False)
    got, seen = _lanes_run(u0s, ps, monkeypatch)
    assert int(got.nreject[2]) == 0
    for k in (118, 119, 120, 121):
        u, p, dt, err = seen[k]
        exact = _exact_rodas5p_err(u, p, dt, 1e-8, 1e-10)
        assert abs(err - exact) <= 1e-5 * exact, (k, err, exact)
    assert 0.6 < seen[120][3] < 1.0
