"""The kernel path of the port (`ensemble="kernel", backend="cuda"`):
status semantics, dtypes, save staging, the wrapper's checks — on the CPU,
where the wrapper runs the kernel's plain twin, held against `repro`'s
Pallas kernel in interpret mode.  The kernel itself needs the card:
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.de_problems import lorenz_problem as j_lorenz_problem
from repro.core import get_tableau as j_get_tableau
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro.kernels.tsit5.ops import solve_ensemble_pallas
from repro_torch.configs.de_problems import (lorenz_ensemble, lorenz_problem,
                                             sho_problem)
from repro_torch.convert import ensemble_problem
from repro_torch.core import STATUS_DTMIN_EXHAUSTED, STATUS_MAX_ITERS
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import EnsembleProblem
from repro_torch.core.tableaus import get_tableau
from repro_torch.kernels.tsit5 import kernel as erk_kernel
from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda


def lorenz_arrays(N, seed=1):
    rng = np.random.default_rng(seed)
    u0s = np.stack([1.0 + 0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N)], axis=1)
    ps = np.stack([np.full(N, 10.0), rng.uniform(0.0, 21.0, N),
                   np.full(N, 8.0 / 3.0)], axis=1)
    return u0s, ps


def both(u0s, ps, **kw):
    jep = JEnsembleProblem(j_lorenz_problem(jnp.float64), len(u0s),
                           u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    want = jsolve(jep, ensemble="kernel", backend="pallas", lane_tile=4, **kw)
    got = tsolve(ensemble_problem(lorenz_problem(torch.float64), u0s, ps),
                 ensemble="kernel", backend="cuda", device="cpu", **kw)
    return got, want


def test_dtmin_exhausted_status_parity():
    """A lane whose state is NaN rejects every step until dt is pinned at
    the controller floor; it ends with status 2, the others with 0."""
    u0s, ps = lorenz_arrays(6)
    u0s[2] = np.nan
    got, want = both(u0s, ps, t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6)
    assert int(got.status) == int(want.status) == STATUS_DTMIN_EXHAUSTED
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    assert int(got.naccept[2]) == 0 and 0 < int(got.nreject[2]) < 200
    ok = np.arange(6) != 2
    np.testing.assert_allclose(got.u_final.numpy()[ok],
                               np.asarray(want.u_final)[ok], rtol=1e-10,
                               atol=1e-10)


def test_max_iters_status_parity():
    u0s, ps = lorenz_arrays(5)
    got, want = both(u0s, ps, t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-8,
                     atol=1e-8, max_iters=20)
    assert int(got.status) == int(want.status) == STATUS_MAX_ITERS
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    # the first steps' error estimates sit at roundoff level (dt0 = 1e-3 at
    # rtol 1e-8), so the two packages' summation orders move the early PI
    # proposals by ~1e-7; the time reached after 20 attempts agrees to that
    assert bool((got.t_final < 1.0).all())
    np.testing.assert_allclose(got.t_final.numpy(), np.asarray(want.t_final),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sho_dtype_sweep_against_closed_form(dtype):
    prob = sho_problem(dtype=dtype)
    N = 6
    om = torch.linspace(1.0, 3.0, N, dtype=dtype)
    ep = EnsembleProblem(prob, N, u0s=prob.u0.expand(N, 2), ps=om[:, None])
    r = tsolve(ep, ensemble="kernel", backend="cuda", device="cpu", t0=0.0,
               tf=3.0, dt0=0.01, saveat=torch.tensor([3.0]), rtol=1e-6,
               atol=1e-6)
    assert r.us.dtype == dtype and int(r.status) == 0
    np.testing.assert_allclose(r.u_final[:, 0].double().numpy(),
                               np.cos(om.double().numpy() * 3.0),
                               atol=5e-4 if dtype == torch.float32 else 1e-6)


def test_staged_fixed_dt_is_bitwise():
    """Fixed-dt staging with dyadic dt and a chunk-aligned save grid: each
    segment restarts at exactly the accumulated t, so every segment
    reproduces the single launch bit for bit."""
    ep = lorenz_ensemble(8, dtype=torch.float32)
    u0s, ps = ep.materialize()
    tab = get_tableau("tsit5")
    saveat = torch.tensor([0.25, 0.5, 0.75, 1.0])
    kw = dict(t0=0.0, tf=1.0, dt0=2.0 ** -6, saveat=saveat, rtol=1e-5,
              atol=1e-5, adaptive=False)
    one = solve_ensemble_cuda(ep.prob, u0s, ps, tab, save_chunks=1, **kw)
    four = solve_ensemble_cuda(ep.prob, u0s, ps, tab, save_chunks=4, **kw)
    for field in ("us", "u_final", "naccept", "t_final"):
        assert torch.equal(getattr(one, field), getattr(four, field)), field
    extra_nf = int(four.nf) - int(one.nf)
    assert 0 <= extra_nf <= 3 * (tab.stages + 2)


@pytest.mark.parametrize("adaptive", [False, True])
def test_staged_matches_reference_staged(adaptive):
    """Both packages split the grid alike and thread u_final and the
    counters between segments the same way."""
    u0s, ps = lorenz_arrays(6)
    saveat = np.array([0.25, 0.5, 0.75, 1.0])
    kw = dict(t0=0.0, tf=1.0, dt0=2.0 ** -6, rtol=1e-8, atol=1e-8,
              adaptive=adaptive, save_chunks=3)
    want = solve_ensemble_pallas(j_lorenz_problem(jnp.float64),
                                 jnp.asarray(u0s), jnp.asarray(ps),
                                 j_get_tableau("tsit5"),
                                 saveat=jnp.asarray(saveat), lane_tile=4,
                                 **kw)
    got = solve_ensemble_cuda(lorenz_problem(torch.float64),
                              torch.from_numpy(u0s), torch.from_numpy(ps),
                              get_tableau("tsit5"),
                              saveat=torch.from_numpy(saveat), **kw)
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    assert int(got.nf) == int(want.nf)
    tol = 1e-10 if adaptive else 1e-12
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us),
                               rtol=tol, atol=tol)


def test_save_chunk_count_matches_reference():
    from repro.kernels.ensemble_kernel import save_chunk_count as j_count
    from repro_torch.kernels.ensemble_kernel import (erk_work_words,
                                                     save_chunk_count)
    for n, m, S, item in [(3, 3, 5, 4), (64, 3, 4096, 8), (3, 3, 20000, 4),
                          (8, 2, 3000, 8)]:
        ww = erk_work_words(n, m, 7)
        assert save_chunk_count(n, m, S, itemsize=item, work_words=ww) == \
            j_count(n, m, S, itemsize=item, work_words=ww)


def test_cpu_wrapper_counts_no_launch():
    """On CPU tensors the wrapper runs the plain twin: no kernel launch."""
    before = erk_kernel.launches
    tsolve(lorenz_ensemble(4, dtype=torch.float64), ensemble="kernel",
           backend="cuda", device="cpu", t0=0.0, tf=0.1, dt0=1e-2)
    assert erk_kernel.launches == before
