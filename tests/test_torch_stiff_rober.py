"""ROBER through the port's front door against the reference's, eager and
lazy-W, on every strategy: per-lane step counts.

Each (method, lazy-W) pair solves the reference once, on its ``vmap``
strategy, and the port on ``vmap``, ``array``, ``array`` with
``linsolve="cuda"`` (the batched LU kernel's plain version on the CPU),
``kernel``/``torch`` and ``kernel``/``cuda`` (the fused kernel's plain
version).  Per-lane naccept/nreject and the njac/nfact/nf totals must equal
the reference's, states must be within its ROBER bar (rtol 1e-6, atol
1e-14) and y1 + y2 + y3 within 1e-7 of 1.  The settings are those of the
reference's lazy-W test (tests/test_stiff.py:160-166: N = 4, t ∈ [0, 1e4],
dt0 1e-6, rtol 1e-6, atol 1e-8), where the reference's own strategies agree
on every count.  At tests/test_stiff.py:118-157's rtol 1e-8 they do not
(rodas4 lazy-W counts differ between its LAPACK and lanes-LU routes), so
tests/test_torch_stiff_tight.py holds the port to that test's bar, which
is the states.  Worst state difference measured here, every strategy:
5.6e-11 of the lane's largest value; the worst element sits at 0.63% of
the bar.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.de_problems import rober_ensemble as j_rober_ensemble
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro_torch.configs.de_problems import rober_problem
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve

SAVEAT = np.array([1e-2, 1.0, 1e2, 1e4])
N, RTOL, ATOL = 4, 1e-6, 1e-8
STRATEGIES = [("vmap", "torch", "torch"), ("array", "torch", "torch"),
              ("array", "torch", "cuda"), ("kernel", "torch", "torch"),
              ("kernel", "cuda", "torch")]
ID = lambda s: "/".join(s) if isinstance(s, tuple) else s


def _kw(alg, w_reuse):
    return dict(alg=alg, dt0=1e-6, rtol=RTOL, atol=ATOL, saveat=SAVEAT,
                w_reuse=w_reuse)


@pytest.fixture(scope="module")
def reference():
    """One reference solve per (method, lazy-W), shared by the strategies."""
    cache = {}

    def get(alg, w_reuse):
        if (alg, w_reuse) not in cache:
            ens = j_rober_ensemble(N, tspan=(0.0, 1e4))
            res = jsolve(ens, ensemble="vmap", backend="xla",
                         **dict(_kw(alg, w_reuse), saveat=jnp.asarray(SAVEAT)))
            u0s, ps = (np.asarray(x) for x in ens.materialize())
            cache[alg, w_reuse] = (u0s, ps, res)
        return cache[alg, w_reuse]

    return get


@pytest.mark.parametrize("strategy", STRATEGIES, ids=ID)
@pytest.mark.parametrize("w_reuse", [False, True], ids=["eager", "lazy-W"])
@pytest.mark.parametrize("alg", ["rosenbrock23", "rodas4", "rodas5p"])
def test_rober_front_door_matches_reference(reference, alg, w_reuse,
                                            strategy):
    ensemble, backend, linsolve = strategy
    u0s, ps, want = reference(alg, w_reuse)
    ep = ensemble_problem(rober_problem(tspan=(0.0, 1e4)), u0s, ps)
    got = tsolve(ep, ensemble=ensemble, backend=backend, linsolve=linsolve,
                 device="cpu", **_kw(alg, w_reuse))
    assert int(got.status) == 0 and int(want.status) == 0
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    assert (int(got.njac), int(got.nfact), int(got.nf)) == \
        (int(want.njac), int(want.nfact), int(want.nf))
    attempts = int((got.naccept + got.nreject).sum())
    if w_reuse:
        assert int(got.njac) < attempts
    else:
        assert int(got.njac) == int(got.nfact) == attempts
    for g, w in ((got.us, want.us), (got.u_final, want.u_final)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-14)
    np.testing.assert_allclose(got.u_final.numpy().sum(axis=1), 1.0,
                               rtol=1e-7)


def test_lazy_w_cuts_jacobians_at_least_twofold(reference):
    """The reference's own bar (tests/test_stiff.py:168-193): with lazy W
    the kernel's plain version evaluates at least 2x fewer Jacobians than
    eager stepping, on ROBER with rosenbrock23 at rtol 1e-6."""
    counts = {}
    for w_reuse in (False, True):
        u0s, ps, _ = reference("rosenbrock23", w_reuse)
        ep = ensemble_problem(rober_problem(tspan=(0.0, 1e4)), u0s, ps)
        res = tsolve(ep, ensemble="kernel", backend="cuda", device="cpu",
                     **_kw("rosenbrock23", w_reuse))
        counts[w_reuse] = int(res.njac)
    assert counts[False] >= 2 * counts[True], counts
