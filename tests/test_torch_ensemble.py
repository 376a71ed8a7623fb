"""The port's front door held against `repro`'s on every erk strategy.

Lorenz, float64, t in [0, 1], inputs made once with numpy from a seed and
handed to both packages.  Each port strategy/backend faces its reference
counterpart: vmap~vmap, array~array, array_eager~array_eager,
kernel+torch~kernel+xla and kernel+cuda~kernel+pallas.  On the CPU the
port's "cuda" backend runs the kernel's plain twin and the reference's
Pallas kernel runs in interpret mode, with a lane tile that leaves a ragged
last tile (N = 13, tile 4).  Bars: identical per-lane naccept/nreject,
states within 1e-10 (adaptive) and 1e-12 (fixed dt).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.de_problems import lorenz_problem as j_lorenz_problem
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro_torch.configs.de_problems import lorenz_problem
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve

PAIRS = {  # port (ensemble, backend) -> reference (ensemble, backend)
    ("vmap", "torch"): ("vmap", "xla"),
    ("array", "torch"): ("array", "xla"),
    ("array_eager", "torch"): ("array_eager", "xla"),
    ("kernel", "torch"): ("kernel", "xla"),
    ("kernel", "cuda"): ("kernel", "pallas"),
}
MODES = {
    "adaptive": (dict(dt0=1e-3, rtol=1e-8, atol=1e-8), 1e-10),
    "fixed": (dict(dt0=1e-2, adaptive=False), 1e-12),
}
LANE_TILE = 4


def lorenz_arrays(N, seed=0):
    rng = np.random.default_rng(seed)
    u0s = np.stack([1.0 + 0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N)], axis=1)
    ps = np.stack([np.full(N, 10.0), rng.uniform(0.0, 21.0, N),
                   np.full(N, 8.0 / 3.0)], axis=1)
    return u0s, ps


@functools.lru_cache(maxsize=None)
def reference(N, ensemble, backend, mode, alg="tsit5"):
    u0s, ps = lorenz_arrays(N)
    ep = JEnsembleProblem(j_lorenz_problem(jnp.float64), N,
                          u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    kw, _ = MODES[mode]
    r = jsolve(ep, alg=alg, ensemble=ensemble, backend=backend, t0=0.0,
               tf=1.0, saveat=np.linspace(0.0, 1.0, 11),
               lane_tile=LANE_TILE, **kw)
    return {k: np.asarray(v) for k, v in r._asdict().items()}


def port(N, ensemble, backend, mode, alg="tsit5"):
    u0s, ps = lorenz_arrays(N)
    ep = ensemble_problem(lorenz_problem(torch.float64), u0s, ps)
    kw, _ = MODES[mode]
    r = tsolve(ep, alg=alg, ensemble=ensemble, backend=backend, t0=0.0,
               tf=1.0, saveat=np.linspace(0.0, 1.0, 11), lane_tile=LANE_TILE,
               device="cpu", **kw)
    return {k: np.asarray(v) for k, v in r._asdict().items()}


def assert_parity(got, want, tol):
    np.testing.assert_array_equal(got["naccept"], want["naccept"])
    np.testing.assert_array_equal(got["nreject"], want["nreject"])
    assert int(got["status"]) == int(want["status"])
    assert int(got["nf"]) == int(want["nf"])
    for field in ("us", "u_final", "t_final", "ts"):
        assert got[field].shape == want[field].shape, field
        np.testing.assert_allclose(got[field], want[field], rtol=tol,
                                   atol=tol, err_msg=field)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("N", [8, 13])
@pytest.mark.parametrize("strategy", sorted(PAIRS))
def test_strategy_parity_with_reference(strategy, N, mode):
    got = port(N, *strategy, mode)
    want = reference(N, *PAIRS[strategy], mode)
    assert_parity(got, want, MODES[mode][1])


def test_dopri5_hermite_kernel_parity():
    """dopri5 has no free interpolant: dense output takes the Hermite
    branch with f(u_new) from the FSAL stage."""
    got = port(13, "kernel", "cuda", "adaptive", alg="dopri5")
    want = reference(13, "kernel", "pallas", "adaptive", alg="dopri5")
    assert_parity(got, want, 1e-10)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fixed_dt_save_every_grid_parity(backend):
    """Fixed dt with no saveat: the kernel paths save on the save_every
    step grid (the scan path for torch/xla, dense output for cuda/pallas)."""
    u0s, ps = lorenz_arrays(8)
    kw = dict(ensemble="kernel", t0=0.0, tf=1.0, dt0=1e-2, adaptive=False,
              save_every=25)
    jep = JEnsembleProblem(j_lorenz_problem(jnp.float64), 8,
                           u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    want = jsolve(jep, backend={"torch": "xla", "cuda": "pallas"}[backend],
                  lane_tile=LANE_TILE, **kw)
    got = tsolve(ensemble_problem(lorenz_problem(torch.float64), u0s, ps),
                 backend=backend, device="cpu", **kw)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(want.ts),
                               rtol=1e-15)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))


def test_kernel_matches_independent_scalar_oracle():
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5.ref import ref_solve
    u0s, ps = lorenz_arrays(5)
    got = port(5, "kernel", "cuda", "adaptive")
    us, uf, tf, na, nr = ref_solve(
        lorenz_problem(torch.float64).f, get_tableau("tsit5"),
        torch.from_numpy(u0s), torch.from_numpy(ps), 0.0, 1.0, 1e-3,
        torch.linspace(0.0, 1.0, 11, dtype=torch.float64), 1e-8, 1e-8)
    np.testing.assert_array_equal(got["naccept"], na.numpy())
    np.testing.assert_array_equal(got["nreject"], nr.numpy())
    np.testing.assert_allclose(got["us"], us.numpy(), rtol=1e-12, atol=1e-12)
