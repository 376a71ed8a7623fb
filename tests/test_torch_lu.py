"""The port's batched LU (`repro_torch.kernels.lu`) against the reference's
(`repro.kernels.lu`): the lanes plain versions against `lu_factor_lanes`,
`lu_resolve_lanes`, `lu_solve_lanes` and the Pallas kernel in interpret mode
within 1e-12, `pivmin` including its 0 and NaN cases, and `batched_solve`'s
reroute of singular systems, which must return exactly the reference
solve's output.  The CUDA kernel itself needs the card:
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lu import kernel as jlu
from repro.kernels.lu import ops as jops
from repro.kernels.lu import ref as jref
from repro_torch.kernels.lu import kernel as tlu
from repro_torch.kernels.lu import ops as tops
from repro_torch.kernels.lu.ref import ref_solve

TOL = 1e-12


def _systems(n, B, seed, zero_diag=True):
    """(n, n, B) systems and (n, B) right-hand sides from a seed; with
    `zero_diag`, every fourth system has a zero diagonal, so it needs row
    swaps."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, n, n)) + 3.0 * np.eye(n)
    if zero_diag:
        W[::4, np.arange(n), np.arange(n)] = 0.0
    b = rng.standard_normal((B, n))
    return np.moveaxis(W, 0, -1).copy(), b.T.copy()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "nopivot"])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_lu_plain_versions_match_reference(n, pivot):
    W, b = _systems(n, 16, seed=n, zero_diag=pivot)
    Wj, bj = jnp.asarray(W), jnp.asarray(b)
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)
    rows_j, swaps_j, mults_j, pm_j = jlu.lu_factor_lanes(Wj, pivot=pivot)
    fac = tlu.lu_factor_lanes(Wt, pivot=pivot)
    rows_t, swaps_t, mults_t, pm_t = fac
    for i in range(n):   # the rows' upper triangle and diagonal are read
        _close(rows_t[i][i:].numpy(), np.asarray(rows_j[i])[i:])
    assert len(swaps_t) == len(swaps_j)
    for st, sj in zip(swaps_t, swaps_j):
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for mt, mj in zip(mults_t, mults_j):
        for a, c in zip(mt, mj):
            _close(a.numpy(), c)
    _close(pm_t.numpy(), pm_j)
    x_res = tlu.lu_resolve_lanes(fac, bt)
    _close(x_res.numpy(), jlu.lu_resolve_lanes((rows_j, swaps_j, mults_j,
                                                pm_j), bj))
    x_t, pm_t2 = tlu.lu_solve_lanes(Wt, bt, pivot=pivot, with_pivmin=True)
    x_j = jlu.lu_solve_lanes(Wj, bj, pivot=pivot)
    _close(x_t.numpy(), x_j)
    assert torch.equal(x_t, x_res) and torch.equal(pm_t2, pm_t)
    # the wrapper of the CUDA kernel runs the plain version on CPU tensors
    x_w, pm_w = tlu.lu_solve(Wt, bt, pivot=pivot)
    x_p, pm_p = jlu.lu_solve_pallas(Wj, bj, lane_tile=16, interpret=True,
                                    pivot=pivot)
    _close(x_w.numpy(), x_p)
    _close(pm_w.numpy(), pm_p)


def _singular_batch():
    """tests/test_stiff.py:339-369's batch: a rank-2 system, a healthy one,
    and the zero matrix."""
    rng = np.random.default_rng(1)
    W_sing = np.array([[1.0, 2.0, 3.0],
                       [2.0, 4.0, 6.0],
                       [1.0, 1.0, 1.0]])
    W_ok = rng.normal(size=(3, 3)) + 5.0 * np.eye(3)
    b = rng.normal(size=(2, 3))
    return W_sing, W_ok, b


@pytest.mark.parametrize("which", ["rank2", "zero"])
def test_pivmin_flags_singular_systems_as_the_reference(which):
    """pivmin is 0 on the rank-2 system and NaN on the zero matrix (a zero
    pivot poisons the later rows), on both packages; x's garbage on those
    lanes has the same NaN/inf pattern."""
    W_sing, W_ok, b = _singular_batch()
    W0 = W_sing if which == "rank2" else np.zeros((3, 3))
    W = np.moveaxis(np.stack([W0, W_ok]), 0, -1).copy()
    bl = b.T.copy()
    x_t, pm_t = tlu.lu_solve_lanes(torch.from_numpy(W), torch.from_numpy(bl),
                                   with_pivmin=True)
    x_j, pm_j = jlu.lu_solve_pallas(jnp.asarray(W), jnp.asarray(bl),
                                    lane_tile=2, interpret=True)
    np.testing.assert_array_equal(pm_t.numpy()[0], np.asarray(pm_j)[0])
    assert not pm_t[0] > 0 and pm_t[1] > 0
    assert bool(torch.isnan(pm_t[0])) == (which == "zero")
    np.testing.assert_array_equal(np.isfinite(x_t.numpy()[:, 0]),
                                  np.isfinite(np.asarray(x_j)[:, 0]))
    _close(x_t.numpy()[:, 1], np.asarray(x_j)[:, 1])


def test_batched_solve_pivots_nondominant_systems():
    """tests/test_stiff.py:307-336's batch: a zero pivot that a row swap
    fixes; pivot=False is rescued by the reroute."""
    rng = np.random.default_rng(0)
    W_bad = np.array([[0.0, 2.0, 1.0],
                      [1.0, 0.0, 3.0],
                      [2.0, 1.0, 0.0]])
    W_ok = rng.normal(size=(3, 3)) + 5.0 * np.eye(3)
    W, b = np.stack([W_bad, W_ok]), rng.normal(size=(2, 3))
    want = np.asarray(jref.ref_solve(jnp.asarray(W), jnp.asarray(b)))
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)
    x_nopiv = tlu.lu_solve_lanes(Wt.permute(1, 2, 0), bt.T, pivot=False)
    assert not bool(torch.isfinite(x_nopiv[:, 0]).all())
    before = tops.rerouted
    for pivot in (True, False):
        _close(tops.batched_solve(Wt, bt, pivot=pivot).numpy(), want)
        _close(np.asarray(jops.batched_solve(jnp.asarray(W), jnp.asarray(b),
                                             pivot=pivot)), want)
    assert tops.rerouted == before + 1    # the pivot=False zero pivot
    _close(tops.batched_solve(Wt, bt, backend="torch").numpy(), want)


@pytest.mark.parametrize("which", ["rank2", "zero"])
def test_batched_solve_reroutes_singular_lanes_to_the_reference_solve(which):
    """The singular lane comes back as the reference solve's output
    (`array_equal`, NaN and inf included) — the port's `ref_solve` returns
    the pattern of the reference's `jnp.linalg.solve` — and the healthy
    lane within 1e-12.  The reroute is counted."""
    W_sing, W_ok, b = _singular_batch()
    W0 = W_sing if which == "rank2" else np.zeros((3, 3))
    W = np.stack([W0, W_ok])
    Wt, bt = torch.from_numpy(W), torch.from_numpy(b)
    ref_t = ref_solve(Wt, bt).numpy()
    ref_j = np.asarray(jref.ref_solve(jnp.asarray(W), jnp.asarray(b)))
    np.testing.assert_array_equal(ref_t[0], ref_j[0])
    before = tops.rerouted
    x = tops.batched_solve(Wt, bt).numpy()
    assert tops.rerouted == before + 1
    np.testing.assert_array_equal(x[0], ref_t[0])
    np.testing.assert_allclose(x[1], ref_j[1], rtol=TOL)
    _, pm = tlu.lu_solve(Wt.permute(1, 2, 0).contiguous(), bt.T.contiguous())
    assert not pm[0] > 0 and pm[1] > 0


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edited header rebuilds every source (the file name carries a hash
    of the source, of every csrc/*.cuh and of the flags)."""
    from repro_torch.kernels import build
    for f in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {s: build.library_path(s) for s in ("lu_solve.cu",
                                                   "rosenbrock_ensemble.cu",
                                                   "erk_ensemble.cu")}
    header = tmp_path / "lu_lanes.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: build.library_path(s) for s in before}
    assert all(before[s] != after[s] for s in before)


def test_lu_solve_wrapper_raises_on_other_devices():
    W = torch.eye(3, dtype=torch.float64)[..., None]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tlu.lu_solve(W.to("meta"), torch.ones(3, 1, device="meta"))
    with pytest.raises(ValueError, match="backend"):
        tops.batched_solve(W.permute(2, 0, 1), torch.ones(1, 3,
                                                          dtype=torch.float64),
                           backend="pallas")
