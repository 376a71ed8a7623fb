"""The port's adaptive SDE path (`repro_torch.core.sde.sde_solve_adaptive`,
the front door's adaptive sde branch, the adaptive kernel's plain version
`repro_torch.kernels.em.adaptive` on the CPU) against the reference's
(`repro.core.sde`, `repro.core.ensemble`, the Pallas kernel in interpret
mode), with both packages stepping on the same normals, in float64.

The port's `bridge_normals` is replaced by the reference's (the float32
Box–Muller normals of XLA-CPU and PyTorch differ by a few ulps;
tests/test_torch_bridge.py holds the two streams).  Then both packages do
the same arithmetic, and the bar is the issue's: per-lane naccept, nreject,
status and nf identical, states within 1e-12 relative.  The counter-stream
runs, without the substitution: tests/test_torch_adaptive_sde_stream.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import sde as jsde
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.methods import get_method as jget
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro.kernels import rng as jrng
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.kernels import rng as trng
from repro_torch.kernels.em import adaptive as k5

TOL = 1e-12
R, V = 1.5, 0.2
_ref_normals = jax.jit(jrng.bridge_normals, static_argnums=(0,))


def ref_normals(seed, node, lane, row, dtype=torch.float32):
    shape = torch.broadcast_shapes(node.shape, lane.shape, row.shape)
    args = [jnp.asarray(x.expand(shape).numpy().astype(np.uint32))
            for x in (node, lane, row)]
    return torch.from_numpy(np.array(_ref_normals(seed, *args))).to(dtype)


@pytest.fixture
def same_normals(monkeypatch):
    monkeypatch.setattr(trng, "bridge_normals", ref_normals)


def problems(name):
    """(reference problem, port problem, u0s, ps, solve settings)."""
    if name == "gbm":
        rng = np.random.default_rng(0)
        N = 16
        return (jdp.gbm_problem(r=R, v=V, dtype=jnp.float64),
                tdp.gbm_problem(r=R, v=V, dtype=torch.float64),
                0.1 + 0.01 * rng.random((N, 3)),
                np.array([R, V]) + 0.01 * rng.random((N, 2)),
                dict(t0=0.0, tf=1.0, dt0=0.05, rtol=1e-3, atol=1e-5,
                     saveat=[0.25, 0.5, 0.75, 1.0]))
    # CRN on the Table-4 sweep, a short horizon; 24 lanes from
    # 2^32 - 20, so the global lane index wraps past 2^32
    u0s, ps = tdp.crn_sweep_arrays(24, 0)
    return (jdp.crn_problem(tspan=(0.0, 1.0), dtype=jnp.float64),
            tdp.crn_problem(tspan=(0.0, 1.0), dtype=torch.float64),
            u0s, ps, dict(t0=0.0, tf=1.0, dt0=0.1, rtol=1e-3, atol=1e-5,
                          saveat=[0.25, 0.5, 0.75, 1.0]))


CASES = [("gbm", "em", "embedded", 0), ("gbm", "em", "doubling", 0),
         ("gbm", "milstein", "embedded", 0),
         ("gbm", "milstein", "doubling", 0),
         ("gbm", "heun_strat", "doubling", 0),
         ("gbm", "platen_w2", "doubling", 0),
         ("crn", "em", "doubling", 2 ** 32 - 20)]
PORT_ROUTES = [("vmap", "torch"), ("array", "torch"), ("kernel", "torch"),
               ("kernel", "cuda")]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin] - b[fin])
                        / np.maximum(np.abs(b[fin]), 1e-300)))


def assert_same_run(got, want):
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    assert int(got.nf) == int(want.nf)
    assert int(got.status) == int(want.status)
    assert tuple(got.us.shape) == tuple(np.shape(want.us))
    assert rel(got.us.numpy(), want.us) <= TOL
    assert rel(got.u_final.numpy(), want.u_final) <= TOL
    assert rel(got.t_final.numpy(), want.t_final) <= TOL


@pytest.mark.parametrize("name,alg,est,offset", CASES)
def test_front_door_same_normals_matches_reference(same_normals, name, alg,
                                                   est, offset):
    """Every port strategy against the reference's kernel/xla solve."""
    jp, tp, u0s, ps, kw = problems(name)
    common = dict(alg=alg, adaptive=True, error_est=est, seed=7,
                  lane_offset=offset, **kw)
    N = u0s.shape[0]
    want = jsolve(JEnsembleProblem(jp, N, u0s=jnp.asarray(u0s),
                                   ps=jnp.asarray(ps)),
                  ensemble="kernel", backend="xla",
                  **dict(common, saveat=jnp.asarray(kw["saveat"])))
    assert int(np.asarray(want.naccept).min()) > 3
    for ensemble, backend in PORT_ROUTES:
        got = tsolve(ensemble_problem(tp, u0s, ps), ensemble=ensemble,
                     backend=backend, device="cpu", lane_tile=N // 2,
                     **common)
        assert_same_run(got, want)


@pytest.mark.parametrize("name,alg,est,offset", CASES)
def test_kernel_plain_version_per_lane_stats_match_reference(
        same_normals, name, alg, est, offset):
    """The plain version of the adaptive kernel (the wrapper on CPU
    tensors) against the reference's lanes engine: the 6 stats rows per
    lane (naccept, nreject, status, nf, 0, 0) identical."""
    jp, tp, u0s, ps, kw = problems(name)
    jspec = jget(alg)
    N = u0s.shape[0]
    pair = jspec.embedded if est == "embedded" else None
    est_order = pair.est_order if pair else max(1, int(round(jspec.order)))
    nf_att = (pair.nf_per_attempt if pair
              else 3 * jsde.sde_nf_per_step(alg))
    depth = jsde.default_bridge_depth(kw["t0"], kw["tf"], kw["dt0"])
    lanes = (np.arange(N, dtype=np.uint64) + offset) % 2 ** 32
    want = jsde.sde_solve_adaptive(
        jp.f, jp.g, jsde.SDE_STEPPERS[alg], jp.noise, jnp.asarray(u0s.T),
        jnp.asarray(ps.T), kw["t0"], kw["tf"], kw["dt0"], seed=7,
        lane_idx=jnp.asarray(lanes.astype(np.uint32)),
        m_noise=jp.noise_dim(), saveat=jnp.asarray(kw["saveat"]),
        rtol=kw["rtol"], atol=kw["atol"], lanes=True, depth=depth,
        order=jspec.order, error_est=est,
        embedded=pair.fn if pair else None, est_order=est_order,
        nf_per_attempt=nf_att)
    us, uf, t_final, stats = k5.sde_adaptive_ensemble(
        tp.f, tp.g, alg, torch.from_numpy(u0s.T.copy()),
        torch.from_numpy(ps.T.copy()),
        torch.tensor(kw["saveat"], dtype=torch.float64), noise=tp.noise,
        m_noise=tp.noise_dim(), t0=kw["t0"], tf=kw["tf"], dt0=kw["dt0"],
        rtol=kw["rtol"], atol=kw["atol"], max_iters=100_000, seed=7,
        depth=depth, order=jspec.order, error_est=est, est_order=est_order,
        nf_per_attempt=nf_att, lane_offset=offset)
    zero = np.zeros(N, np.int64)
    want_stats = np.stack([np.asarray(want.naccept), np.asarray(want.nreject),
                           np.asarray(want.status), np.asarray(want.nf),
                           zero, zero])
    np.testing.assert_array_equal(stats.numpy(), want_stats)
    assert stats.dtype == torch.int32 and tuple(us.shape) == (4, tp.n_states,
                                                              N)
    assert rel(us.numpy(), want.us) <= TOL
    assert rel(uf.numpy(), want.u_final) <= TOL
    assert rel(t_final.numpy(), want.t_final) <= TOL


def test_front_door_same_normals_matches_reference_pallas(same_normals):
    """One case against the reference's Pallas kernel (interpret mode)."""
    jp, tp, u0s, ps, kw = problems("gbm")
    u0s, ps = u0s[:8], ps[:8]
    common = dict(alg="em", adaptive=True, error_est="embedded", seed=7,
                  lane_offset=3, **kw)
    want = jsolve(JEnsembleProblem(jp, 8, u0s=jnp.asarray(u0s),
                                   ps=jnp.asarray(ps)),
                  ensemble="kernel", backend="pallas", lane_tile=8,
                  **dict(common, saveat=jnp.asarray(kw["saveat"])))
    got = tsolve(ensemble_problem(tp, u0s, ps), ensemble="kernel",
                 backend="cuda", device="cpu", **common)
    assert_same_run(got, want)
