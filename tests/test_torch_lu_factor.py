"""The batched LU split into a factorization that stays on the card and a
resolve per right-hand side (`repro_torch.kernels.lu.kernel.lu_factor` /
`lu_resolve`, `ops.factor` / `resolve` / `select`), on the CPU, where the
wrappers run their plain versions: bitwise equal to the one-shot
`lu_solve_lanes` stage by stage, singular systems included; the reroute
found at factor time equal to `batched_solve`'s per solve; the lazy-W
select equal to factoring the selected W; and the `array` Rosenbrock path
with ``linsolve="cuda"`` bitwise equal to ``linsolve="lanes"``.  The
reference's `repro.kernels.lu` solves the same systems (1e-12).  The CUDA
entries themselves need the card: tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lu import kernel as jlu
from repro.kernels.lu import ops as jops
from repro_torch.kernels.lu import kernel as tlu
from repro_torch.kernels.lu import ops as tops

TOL = 1e-12


def _batch(n, B, seed, dtype=np.float64):
    """(B, n, n) systems from a seed: every fifth with a zero diagonal (row
    swaps), one with a zero column (a zero pivot) and one zero matrix,
    and three right-hand sides (n, B)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((B, n, n))
    W[::5, np.arange(n), np.arange(n)] = 0.0
    W[3, :, n // 2] = 0.0
    W[B - 2] = 0.0
    bs = [rng.standard_normal((n, B)) for _ in range(3)]
    return (torch.from_numpy(W.astype(dtype)),
            [torch.from_numpy(b.astype(dtype)) for b in bs])


def _same(a, b):
    """Bitwise equal, NaN where NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(7.0), b.nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "nopivot"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_factor_then_resolve_is_the_one_shot_solve_stage_by_stage(n, pivot,
                                                                  dtype):
    """Each right-hand side against one factorization equals
    `lu_solve_lanes` on (W, b) bit for bit, x and pivmin, singular
    systems included; a lane-major W (a strided view) gives the same
    state as a batch-major one."""
    W, bs = _batch(n, 17, seed=n, dtype=dtype)
    lu, piv, pivmin = tlu.lu_factor(W, pivot=pivot)
    assert lu.shape == (n, n, 17) and pivmin.shape == (17,)
    assert piv.dtype == torch.uint8
    assert piv.shape == ((n - 1, 17) if pivot else (0, 17))
    Wl = W.permute(1, 2, 0).contiguous()
    for got, want in zip(tlu.lu_factor(Wl.permute(2, 0, 1), pivot=pivot),
                         (lu, piv, pivmin)):
        assert _same(got.double(), want.double())
    for b in bs:
        x = tlu.lu_resolve(lu, piv, b)
        xw, pw = tlu.lu_solve_lanes(Wl, b, pivot=pivot, with_pivmin=True)
        assert _same(x, xw) and _same(pivmin, pw)


def test_pack_keeps_what_the_resolve_reads():
    """The packed state holds the rows on and above the diagonal and the
    multipliers below it; unpacking gives back what `lu_resolve_lanes`
    reads."""
    W, _ = _batch(4, 9, seed=11)
    fac = tlu.lu_factor_lanes(W.permute(1, 2, 0))
    lu, piv, pivmin = tlu.pack_factors(fac, 4)
    rows, swaps, mults, pm = tlu.unpack_factors(lu, piv, pivmin)
    for i in range(4):
        assert _same(rows[i][i:], fac[0][i][i:])
    for k in range(3):
        assert torch.equal(swaps[k], fac[1][k])
    for k in range(4):
        for a, b in zip(mults[k], fac[2][k]):
            assert _same(a, b)
    assert pm is pivmin


@pytest.mark.parametrize("n", [3, 8])
def test_factor_time_reroute_equals_the_per_solve_reroute(n):
    """`factor` finds the singular systems once; every `resolve` returns
    `batched_solve`'s x on them (the reference solve's, NaN and inf
    included) and counts the same reroutes.  The healthy systems agree
    with the reference's `batched_solve` within 1e-12."""
    W, bs = _batch(n, 23, seed=20 + n)
    fac = tops.factor(W)
    assert fac.singular is not None and fac.W is W
    assert set(fac.singular.tolist()) == {3, 21}
    for b in bs:
        before = tops.rerouted
        want = tops.batched_solve(W, b.T).T
        per_solve = tops.rerouted - before
        before = tops.rerouted
        got = tops.resolve(fac, b)
        assert tops.rerouted - before == per_solve == 2
        assert _same(got, want)
        ok = ~torch.isin(torch.arange(23), fac.singular)
        ref = np.asarray(jops.batched_solve(jnp.asarray(W.numpy()),
                                            jnp.asarray(b.T.numpy()))).T
        np.testing.assert_allclose(got[:, ok].numpy(), ref[:, ok.numpy()],
                                   rtol=TOL, atol=TOL)


def test_a_healthy_factorization_keeps_no_reroute():
    W, bs = _batch(3, 12, seed=5)
    W[3] = torch.eye(3, dtype=W.dtype)
    W[10] = torch.eye(3, dtype=W.dtype)
    fac = tops.factor(W)
    assert fac.singular is None and fac.W is None
    before = tops.rerouted
    x = tops.resolve(fac, bs[0])
    assert tops.rerouted == before
    xj = np.asarray(jlu.lu_solve_lanes(jnp.asarray(W.permute(1, 2, 0)
                                                   .numpy()),
                                       jnp.asarray(bs[0].numpy())))
    np.testing.assert_allclose(x.numpy(), xj, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sides", ["both", "new", "old", "none"])
def test_select_equals_factoring_the_selected_systems(sides):
    """`select` over two factorizations equals the factorization of the
    per-lane selected W, lane by lane: the state, the resolve, and the
    reroute, whichever side holds the singular systems."""
    n, B = 3, 16
    W_old, bs = _batch(n, B, seed=30)
    W_new, _ = _batch(n, B, seed=31)
    healthy = torch.eye(n, dtype=W_old.dtype) * 2.0
    if sides in ("new", "none"):
        W_old[3] = W_old[B - 2] = healthy
    if sides in ("old", "none"):
        W_new[3] = W_new[B - 2] = healthy
    if sides != "none":
        W_new[7] = 0.0                               # singular, selected
        W_old[8] = 0.0                               # singular, kept
    mask = torch.zeros(B, dtype=torch.bool)
    mask[[1, 3, 7, 9, 12]] = True
    sel = tops.select(mask, tops.factor(W_new), tops.factor(W_old))
    W_sel = torch.where(mask[:, None, None], W_new, W_old)
    want = tops.factor(W_sel)
    for a, b in zip(sel[:3], want[:3]):
        assert _same(a.double(), b.double())
    if sides == "none":
        assert sel.singular is None and want.singular is None
        assert sel.W is None
    else:
        assert torch.equal(sel.singular, want.singular)
    k = 0 if want.singular is None else want.singular.numel()
    for b in bs:
        before = tops.rerouted
        got = tops.resolve(sel, b)
        assert _same(got, tops.resolve(want, b))
        assert tops.rerouted - before == 2 * k


def test_the_factorization_refuses_grad():
    W, bs = _batch(3, 4, seed=1)
    with pytest.raises(ValueError, match="linsolve='cuda'"):
        tops.factor(W.clone().requires_grad_())
    fac = tops.factor(W)
    with pytest.raises(ValueError, match="linsolve='cuda'"):
        tops.resolve(fac, bs[0].clone().requires_grad_())


def test_factor_and_resolve_wrappers_raise_on_other_devices():
    W = torch.eye(3, dtype=torch.float64)[None].to("meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tlu.lu_factor(W)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tlu.lu_resolve(torch.empty((3, 3, 1), device="meta"),
                       torch.empty((2, 1), dtype=torch.uint8, device="meta"),
                       torch.empty((3, 1), device="meta"))


@pytest.mark.parametrize("w_reuse", [False, True], ids=["eager", "lazyW"])
def test_array_rodas4_rober_cuda_route_equals_the_lanes_route(w_reuse):
    """On CPU tensors the ``"cuda"`` route runs the same lanes arithmetic
    as ``"lanes"`` (factor once, resolve per stage), so the `array` path's
    saves, final states and counts are equal bit for bit, and its counts
    agree with the reference's ``linsolve="pallas"`` run."""
    from repro.configs import de_problems as jdp
    from repro.core.ensemble import solve_ensemble_local as jsolve
    from repro_torch.configs import de_problems as tdp
    from repro_torch.core.ensemble import solve_ensemble_local
    N = 24
    ep = tdp.rober_ensemble(N, tspan=(0.0, 1e2))
    kw = dict(alg="rodas4", ensemble="array", t0=0.0, tf=1e2, dt0=1e-6,
              rtol=1e-6, atol=1e-8, saveat=[1e-2, 1.0, 1e2], device="cpu",
              w_reuse=w_reuse)
    before = tlu.factor_launches, tlu.resolve_launches
    rc = solve_ensemble_local(ep, linsolve="cuda", **kw)
    rl = solve_ensemble_local(ep, linsolve="lanes", **kw)
    # the plain versions ran: no kernel was launched on CPU tensors
    assert (tlu.factor_launches, tlu.resolve_launches) == before
    for a, b in ((rc.us, rl.us), (rc.u_final, rl.u_final),
                 (rc.t_final, rl.t_final)):
        assert torch.equal(a, b)
    for a, b in ((rc.naccept, rl.naccept), (rc.nreject, rl.nreject),
                 (rc.njac, rl.njac), (rc.nfact, rl.nfact)):
        assert torch.equal(a, b)
    jep = jdp.rober_ensemble(N, tspan=(0.0, 1e2))
    jkw = {k: v for k, v in kw.items() if k != "device"}
    rj = jsolve(jep, linsolve="pallas", **jkw)
    np.testing.assert_array_equal(rc.naccept.numpy(), np.asarray(rj.naccept))
    np.testing.assert_allclose(rc.u_final.numpy(), np.asarray(rj.u_final),
                               rtol=1e-6, atol=1e-14)
