"""The CUDA kernels themselves, on the card: marked `cuda`, skipped
without it.

This file imports only torch and the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import de_problems as tdp
from repro_torch.configs.de_problems import lorenz_problem
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import EnsembleProblem, SDEProblem
from repro_torch.core.tableaus import get_tableau
from repro_torch.kernels.em import kernel as sde_kernel
from repro_torch.kernels.tsit5 import kernel as erk_kernel


def lorenz_arrays(N, seed=1):
    rng = np.random.default_rng(seed)
    u0s = np.stack([1.0 + 0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N)], axis=1)
    ps = np.stack([np.full(N, 10.0), rng.uniform(0.0, 21.0, N),
                   np.full(N, 8.0 / 3.0)], axis=1)
    return u0s, ps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["tsit5", "dopri5"])
def test_cuda_kernel_matches_twin(cuda, alg):
    u0s, ps = lorenz_arrays(300)
    ep = ensemble_problem(lorenz_problem(torch.float64), u0s, ps,
                          device=cuda)
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=1.0, dt0=1e-3,
              rtol=1e-8, atol=1e-8, saveat=torch.linspace(0, 1, 11),
              device=cuda)
    before = erk_kernel.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw)
    assert erk_kernel.launches == before + 1
    assert torch.equal(rk.naccept, rt.naccept)
    assert torch.equal(rk.nreject, rt.nreject)
    torch.testing.assert_close(rk.us, rt.us, rtol=1e-10, atol=1e-10)


def _branchy(u, p, t):
    """Python control flow on the data: the translator refuses it."""
    return -u if u[0] > 0 else u


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    tab = get_tableau("tsit5")
    u0 = torch.ones(3, 8, dtype=torch.float64, device=cuda)
    p = torch.ones(3, 8, dtype=torch.float64, device=cuda)
    sv = torch.linspace(0, 1, 3, dtype=torch.float64, device=cuda)
    kw = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6, adaptive=True,
              max_iters=100)
    f = lorenz_problem().f
    from repro_torch.convert import tableau_from_arrays
    vern7 = get_tableau("vern7")
    user = tableau_from_arrays("user_vern7", vern7.a, vern7.b, vern7.btilde,
                               vern7.c, order=vern7.order,
                               embedded_order=vern7.embedded_order,
                               fsal=vern7.fsal)
    # an RHS, an event or a user tableau reaches the kernel through the
    # automated translation: what it cannot take raises, naming item 17
    before = erk_kernel.launches
    with pytest.raises(NotImplementedError, match="torch.where.*item 17"):
        erk_kernel.erk_ensemble(_branchy, tab, u0, p, sv, **kw)
    # the ball's affect gives two states, not Lorenz's three
    for t in (user, vern7):
        with pytest.raises(NotImplementedError, match="returned.*item 17"):
            erk_kernel.erk_ensemble(f, t, u0, p, sv,
                                    event=tdp.bouncing_ball_event(), **kw)
    # a free interpolant is traced: one that gives no stacked weights
    # refuses
    with pytest.raises(NotImplementedError, match="returned.*item 17"):
        erk_kernel.erk_ensemble(f, user._replace(
            interp_bpoly=lambda th: th), u0, p, sv, **kw)
    assert erk_kernel.launches == before
    with pytest.raises(ValueError, match="ascending"):
        erk_kernel.erk_ensemble(f, tab, u0, p, sv.flip(0).contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        erk_kernel.erk_ensemble(f, tab, u0.T.contiguous().T, p, sv, **kw)
    with pytest.raises(ValueError, match="float64"):
        erk_kernel.erk_ensemble(f, tab, u0, p.float(), sv, **kw)


# the tableaus of csrc/erk_tableaus.cu compiled `Rounded`: bitwise to the
# plain version; the others within K1's bars
ROUNDED = {"rkck54", "vern7", "gbs10"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("N", [1, 127, 4096 + 3])
@pytest.mark.parametrize("alg", ["rkck54", "bs3", "rkf45", "rk4", "vern7",
                                 "gbs10"])
def test_cuda_new_tableau_forms_match_plain_version(cuda, alg, N, dtype):
    """t in [0, 1/4].  Fixed dt 1/64 with a save in the middle of every
    step (Hermite at theta 1/2: f(u_new), evaluated once an accepted step
    where the pair has no FSAL), and adaptive (not rk4, which has no error estimate; in f32
    only the `Rounded` forms, whose accept decisions are the plain
    version's).  The kernel against its plain version on the card:
    `Rounded` forms bitwise; the others' counts identical and states
    within 1e-10 (fixed dt 1e-12) in f64, 1e-5 relative in f32."""
    tab = get_tableau(alg)
    u0s, ps = lorenz_arrays(N)
    u0 = torch.tensor(u0s.T, dtype=dtype, device=cuda).contiguous()
    p = torch.tensor(ps.T, dtype=dtype, device=cuda).contiguous()
    f = lorenz_problem().f
    tol = 1e-8 if dtype == torch.float64 else 1e-5
    cases = [(False, (torch.arange(16, dtype=dtype) + 0.5) / 64, 1 / 64)]
    if alg != "rk4" and (dtype == torch.float64 or alg in ROUNDED):
        cases.append((True, torch.linspace(0, 0.25, 6, dtype=dtype), 1e-3))
    for adaptive, sv, dt0 in cases:
        sv = sv.to(cuda)
        kw = dict(t0=0.0, tf=0.25, dt0=dt0, rtol=tol, atol=tol,
                  adaptive=adaptive, max_iters=100_000)
        before = erk_kernel.launches
        got = erk_kernel.erk_ensemble(f, tab, u0, p, sv, **kw)
        assert erk_kernel.launches == before + 1
        want = erk_kernel._plain(f, tab, u0, p, sv, **kw)
        if alg in ROUNDED:
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            continue
        assert torch.equal(got[3], want[3])
        bar = (1e-5 if dtype == torch.float32
               else 1e-10 if adaptive else 1e-12)
        for a, b in zip(got[:3], want[:3]):
            torch.testing.assert_close(a, b, rtol=bar, atol=bar)


@pytest.mark.cuda
def test_cuda_staged_front_door_reads_nothing_back(cuda):
    """A save grid given on the host, large enough that the front door
    stages it (two launches by the reference's count): the solve runs
    under `set_sync_debug_mode("error")`, so nothing of it waits for the
    card, and gives what it gave without the check."""
    u0s, ps = lorenz_arrays(64)
    ep = ensemble_problem(lorenz_problem(torch.float64), u0s, ps,
                          device=cuda)
    kw = dict(alg="tsit5", ensemble="kernel", backend="cuda", t0=0.0,
              tf=1.0, dt0=1e-3, rtol=1e-8, atol=1e-8,
              saveat=np.linspace(0.01, 1.0, 2000), device=cuda)
    want = tsolve(ep, **kw)
    torch.cuda.synchronize()
    before = erk_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tsolve(ep, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert erk_kernel.launches == before + 2
    for field in ("us", "u_final", "t_final", "naccept", "nreject", "nf"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


# ---------------------------------------------------------------------------
# the fixed-dt SDE kernel (csrc/sde_ensemble.cu)
# ---------------------------------------------------------------------------

def sde_inputs(name, N, seed=2):
    if name == "crn":
        u0s, ps = tdp.crn_sweep_arrays(N, seed)
        return tdp.crn_problem(tspan=(0.0, 10.0), dtype=torch.float64), \
            u0s, ps
    rng = np.random.default_rng(seed)
    return (tdp.gbm_problem(dtype=torch.float64),
            0.1 + 0.01 * rng.random((N, 3)),
            np.array([1.5, 0.2]) + 0.01 * rng.random((N, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("name,alg", [
    ("gbm", "em"), ("gbm", "heun_strat"), ("gbm", "platen_w2"),
    ("gbm", "milstein"), ("crn", "em"), ("crn", "heun_strat")])
def test_cuda_sde_kernel_matches_plain_version(cuda, name, alg, table):
    """f64, the kernel against its plain version (the lanes loop) on the
    same card and inputs.  With a table both do the same arithmetic up to
    fma contraction: 1e-12.  With the counter RNG both draw the normals
    with the card's float32 log and cos, so the bar is the same."""
    prob, u0s, ps = sde_inputs(name, 300)
    ep = ensemble_problem(prob, u0s, ps, device=cuda)
    m, n_steps = prob.noise_dim(), 40
    Z = (torch.randn(n_steps, m, 300, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0)).to(cuda)
         if table else None)
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, dt0=0.05,
              n_steps=n_steps, save_every=10, seed=5, noise_table=Z,
              device=cuda)
    before = sde_kernel.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw)
    assert sde_kernel.launches == before + 1
    fin = torch.isfinite(rt.us)
    assert torch.equal(torch.isfinite(rk.us), fin)
    torch.testing.assert_close(rk.us[fin], rt.us[fin], rtol=1e-12,
                               atol=1e-14)
    assert torch.equal(rk.naccept, rt.naccept)
    assert torch.equal(rk.t_final, rt.t_final) and int(rk.nf) == int(rt.nf)


@pytest.mark.cuda
def test_cuda_sde_normals_match_plain_version(cuda):
    """The kernel's Threefry words bitwise; its normals within a few
    float32 ulps of the plain stream on the same card."""
    args = (123, 2 ** 31 - 8, 8, 8, 4096)
    before = sde_kernel.normals_launches
    wk, zk = sde_kernel.sde_normals(*args, lane_offset=2 ** 32 - 100,
                                    device=cuda)
    wp, zp = sde_kernel.sde_normals(*args, lane_offset=2 ** 32 - 100,
                                    device="cpu")
    assert sde_kernel.normals_launches == before + 1
    assert torch.equal(wk.cpu(), wp)
    torch.testing.assert_close(zk.cpu(), zp, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_cuda_sde_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    """Raises, and never runs the plain version, on CUDA tensors."""
    before = sde_kernel.launches
    plain = SDEProblem(lambda u, p, t: p[0] * u, _branchy,
                       torch.full((3,), 0.1, dtype=torch.float64),
                       torch.tensor([1.5, 0.2], dtype=torch.float64),
                       (0.0, 1.0))
    with pytest.raises(NotImplementedError, match="torch.where.*item 17"):
        tsolve(EnsembleProblem(plain, 8), alg="em", backend="cuda",
               t0=0.0, dt0=0.1, n_steps=4, device=cuda)
    u0 = torch.ones(4, 8, dtype=torch.float64, device=cuda)
    p = torch.ones(6, 8, dtype=torch.float64, device=cuda)
    kw = dict(noise="general", m_noise=8, t0=0.0, dt=0.1, n_steps=4,
              save_every=1, seed=0)
    with pytest.raises(NotImplementedError, match="gdg"):
        sde_kernel.sde_ensemble(tdp.crn_drift, tdp.crn_diffusion,
                                "milstein", u0, p, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sde_kernel.sde_ensemble(tdp.crn_drift, tdp.crn_diffusion, "em",
                                u0.T.contiguous().T, p, **kw)
    with pytest.raises(ValueError, match="float64"):
        sde_kernel.sde_ensemble(tdp.crn_drift, tdp.crn_diffusion, "em", u0,
                                p.float(), **kw)
    assert sde_kernel.launches == before


# ---------------------------------------------------------------------------
# the stiff kernels: fused Rosenbrock (csrc/rosenbrock_ensemble.cu) and the
# batched LU (csrc/lu_solve.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("w_reuse", [False, True], ids=["eager", "lazy-W"])
@pytest.mark.parametrize("alg", ["rosenbrock23", "rodas4", "rodas5p"])
def test_cuda_rosenbrock_kernel_matches_twin(cuda, alg, w_reuse):
    """f64 ROBER, N = 256: the kernel against its twin (the lanes engine
    with the lanes LU) on the same card.  Lanes whose step counts equal the
    twin's agree within 1e-10 of the lane's largest value, every lane within
    the reference's ROBER bar (rtol 1e-6, atol 1e-14)."""
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    ep = tdp.rober_ensemble(256, tspan=(0.0, 1e4))
    ep = EnsembleProblem(ep.prob, 256, u0s=ep.materialize()[0].to(cuda),
                         ps=ep.ps.to(cuda))
    kw = dict(alg=alg, ensemble="kernel", dt0=1e-6, rtol=1e-6, atol=1e-8,
              saveat=torch.tensor([1e-2, 1.0, 1e2, 1e4], dtype=torch.float64),
              w_reuse=w_reuse, device=cuda)
    before = rb_kernel.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", linsolve="lanes", **kw)
    assert rb_kernel.launches == before + 1
    assert int(rk.status) == 0 and int(rt.status) == 0
    same = (rk.naccept == rt.naccept) & (rk.nreject == rt.nreject)
    for a, b in ((rk.us, rt.us), (rk.u_final, rt.u_final)):
        d = (a - b).abs().reshape(256, -1)
        scale = b.abs().reshape(256, -1).max(dim=1).values
        assert bool((d.max(dim=1).values[same] <= 1e-10 * scale[same]).all())
        assert bool((d <= 1e-14 + 1e-6 * b.abs().reshape(256, -1)).all())
    if not w_reuse:
        attempts = int((rk.naccept + rk.nreject).sum())
        assert int(rk.njac) == int(rk.nfact) == attempts


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 8])
def test_cuda_lu_kernel_matches_plain_version(cuda, n):
    """The LU kernel rounds as its plain version does: x and pivmin equal
    bit for bit on the card, a singular and a zero system included, and
    `batched_solve` returns the reference solve's output on those two."""
    from repro_torch.kernels.lu import kernel as lu_kernel
    from repro_torch.kernels.lu import ops as lu_ops
    from repro_torch.kernels.lu.ref import ref_solve
    rng = np.random.default_rng(n)
    W = rng.standard_normal((300, n, n))
    W[::7, np.arange(n), np.arange(n)] = 0.0
    W[5, :, 0] = 0.0      # a zero column: an exactly zero pivot
    W[6] = 0.0
    W = torch.from_numpy(W).to(cuda)
    b = torch.from_numpy(rng.standard_normal((300, n))).to(cuda)
    Wl, bl = W.permute(1, 2, 0).contiguous(), b.T.contiguous()
    for pivot in (True, False):
        before = lu_kernel.launches
        x, pm = lu_kernel.lu_solve(Wl, bl, pivot=pivot)
        xp, pmp = lu_kernel.lu_solve_lanes(Wl, bl, pivot=pivot,
                                           with_pivmin=True)
        assert lu_kernel.launches == before + 1
        assert torch.equal(x.nan_to_num(7.0, 8.0, 9.0),
                           xp.nan_to_num(7.0, 8.0, 9.0))
        assert torch.equal(pm.nan_to_num(7.0), pmp.nan_to_num(7.0))
    before = lu_ops.rerouted
    xb = lu_ops.batched_solve(W, b)
    assert lu_ops.rerouted == before + 2
    want = ref_solve(W[5:7], b[5:7])
    assert torch.equal(xb[5:7].nan_to_num(7.0, 8.0, 9.0),
                       want.nan_to_num(7.0, 8.0, 9.0))


@pytest.mark.cuda
def test_cuda_stiff_wrappers_reject_what_the_kernels_cannot_take(cuda):
    """Raises, and never runs the plain version, on CUDA tensors."""
    from repro_torch.core.problem import ODEProblem
    from repro_torch.core.tableaus import RODAS4
    from repro_torch.kernels.lu import kernel as lu_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    before = rb_kernel.launches, lu_kernel.launches
    prob = tdp.rober_problem()
    plain = ODEProblem(_branchy, prob.u0, prob.p, (0.0, 1.0))
    kw = dict(alg="rodas4", backend="cuda", dt0=1e-6, device=cuda)
    with pytest.raises(NotImplementedError, match="torch.where.*item 17"):
        tsolve(EnsembleProblem(plain, 8), **kw)
    # a Jacobian hook of another problem's shape is refused when traced
    other_jac = ODEProblem(prob.f, prob.u0, prob.p, (0.0, 1.0),
                           jac=lambda u, p, t: tdp.rober_rhs(u, p, t))
    with pytest.raises(NotImplementedError, match=r"shape \(3, 3\)"):
        tsolve(EnsembleProblem(other_jac, 8), **kw)
    renamed = RODAS4._replace(C=RODAS4.C * 1.0)
    with pytest.raises(NotImplementedError, match="not compiled"):
        tsolve(EnsembleProblem(prob, 8), **dict(kw, alg=renamed))
    u0 = torch.ones(3, 8, dtype=torch.float64, device=cuda)
    sv = torch.linspace(0, 1, 3, dtype=torch.float64, device=cuda)
    args = dict(jac=None, t0=0.0, tf=1.0, dt0=1e-6, rtol=1e-6, atol=1e-8,
                max_iters=10)
    with pytest.raises(ValueError, match="contiguous"):
        rb_kernel.rosenbrock_ensemble(prob.f, RODAS4, u0.T.contiguous().T,
                                      u0, sv, **args)
    with pytest.raises(ValueError, match="float64"):
        rb_kernel.rosenbrock_ensemble(prob.f, RODAS4, u0, u0.float(), sv,
                                      **args)
    W = torch.eye(9, dtype=torch.float64, device=cuda)[..., None]
    with pytest.raises(ValueError, match="n = 1..8"):
        lu_kernel.lu_solve(W.contiguous(), torch.ones(9, 1,
                                                      dtype=torch.float64,
                                                      device=cuda))
    assert (rb_kernel.launches, lu_kernel.launches) == before


# ---------------------------------------------------------------------------
# the adaptive SDE kernel (csrc/sde_adaptive_ensemble.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name,alg,est", [
    ("gbm", "em", "embedded"), ("gbm", "milstein", "embedded"),
    ("gbm", "em", "doubling"), ("gbm", "heun_strat", "doubling"),
    ("gbm", "platen_w2", "doubling"), ("gbm", "milstein", "doubling"),
    ("crn", "em", "doubling"), ("crn", "heun_strat", "doubling")])
def test_cuda_sde_adaptive_kernel_matches_plain_version(cuda, name, alg,
                                                        est, dtype):
    """N = 300, every instantiation: the kernel against its plain version
    (the lanes loop) on the same card.  Both round every operation on
    their own, so the per-lane counts are identical and the states bitwise
    or within 1e-12."""
    from repro_torch.kernels.em import adaptive as k5
    prob, u0s, ps = sde_inputs(name, 300)
    ep = ensemble_problem(prob, u0s, ps, device=cuda, dtype=dtype)
    tf = 1.0 if name == "gbm" else 2.0
    kw = dict(alg=alg, ensemble="kernel", adaptive=True, error_est=est,
              t0=0.0, tf=tf, dt0=0.05, rtol=1e-3, atol=1e-5, seed=5,
              saveat=torch.linspace(tf / 4, tf, 4, dtype=dtype),
              lane_offset=2 ** 32 - 100, device=cuda)
    before = k5.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw)
    assert k5.launches == before + 1
    assert torch.equal(rk.naccept, rt.naccept)
    assert torch.equal(rk.nreject, rt.nreject)
    assert int(rk.nf) == int(rt.nf) and int(rk.status) == int(rt.status)
    assert torch.equal(rk.t_final, rt.t_final)
    for a, b in ((rk.us, rt.us), (rk.u_final, rt.u_final)):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        torch.testing.assert_close(a[fin], b[fin], rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_cuda_sde_adaptive_kernel_f32_runs_and_counts(cuda):
    """f32: one launch, finite GBM states, the plain version's counts on
    nearly every lane (f32 rounding may move an accept decision)."""
    from repro_torch.kernels.em import adaptive as k5
    prob, u0s, ps = sde_inputs("gbm", 1024)
    ep = ensemble_problem(tdp.gbm_problem(dtype=torch.float32), u0s, ps,
                          device=cuda, dtype=torch.float32)
    kw = dict(alg="em", ensemble="kernel", adaptive=True, t0=0.0, tf=1.0,
              dt0=0.02, rtol=1e-3, atol=1e-5, seed=7, brownian_depth=14,
              saveat=[0.25, 0.5, 0.75, 1.0], device=cuda)
    before = k5.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw)
    assert k5.launches == before + 1 and int(rk.status) == 0
    assert bool(torch.isfinite(rk.us).all()) and rk.us.dtype == torch.float32
    same = (rk.naccept == rt.naccept) & (rk.nreject == rt.nreject)
    assert float(same.double().mean()) >= 0.99


@pytest.mark.cuda
def test_cuda_sde_adaptive_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    """Raises, and never runs the plain version, on CUDA tensors."""
    from repro_torch.kernels.em import adaptive as k5
    before = k5.launches
    plain = SDEProblem(lambda u, p, t: p[0] * u, lambda u, p, t: p[1] * u,
                       torch.full((3,), 0.1, dtype=torch.float64),
                       torch.tensor([1.5, 0.2], dtype=torch.float64),
                       (0.0, 1.0))
    # an unregistered pair runs through a generated unit; a pair the
    # translator cannot take raises, naming item 17
    tsolve(EnsembleProblem(plain, 8), alg="em", backend="cuda",
           adaptive=True, t0=0.0, tf=1.0, dt0=0.1, device=cuda)
    assert k5.launches == before + 1
    before = k5.launches
    bad = SDEProblem(lambda u, p, t: p[0] * u, _branchy, plain.u0, plain.p,
                     (0.0, 1.0))
    with pytest.raises(NotImplementedError, match="torch.where.*item 17"):
        tsolve(EnsembleProblem(bad, 8), alg="em", backend="cuda",
               adaptive=True, t0=0.0, tf=1.0, dt0=0.1, device=cuda)
    u0 = torch.full((3, 8), 0.1, dtype=torch.float64, device=cuda)
    p = torch.ones(2, 8, dtype=torch.float64, device=cuda)
    sv = torch.tensor([1.0, 0.5], dtype=torch.float64, device=cuda)
    kw = dict(noise="diagonal", m_noise=3, t0=0.0, tf=1.0, dt0=0.1,
              rtol=1e-3, atol=1e-5, max_iters=100, seed=0, depth=8,
              order=0.5, error_est="embedded", est_order=1,
              nf_per_attempt=1)
    f, g = tdp.gbm_drift, tdp.gbm_diffusion
    with pytest.raises(ValueError, match="ascending"):
        k5.sde_adaptive_ensemble(f, g, "em", u0, p, sv, **kw)
    with pytest.raises(ValueError, match="no embedded pair"):
        k5.sde_adaptive_ensemble(f, g, "platen_w2", u0, p, sv[:1], **kw)
    with pytest.raises(ValueError, match="float64"):
        k5.sde_adaptive_ensemble(f, g, "em", u0, p.float(), sv[:1], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        k5.sde_adaptive_ensemble(f, g, "em", u0.T.contiguous().T, p, sv[:1],
                                 **kw)
    assert k5.launches == before


# ---------------------------------------------------------------------------
# the event forms of the four ensemble kernels (csrc/events.cuh), each
# against its plain version at N = 64, f64: K1 counts identical and states
# within 1e-10; K3 and K5 bitwise; K4 within 1e-12
# ---------------------------------------------------------------------------

def ball_ensemble(N, device):
    from repro_torch.convert import ensemble_problem
    es = np.linspace(0.3, 0.9, N)
    u0s = np.stack([np.full(N, 10.0), np.zeros(N)], 1)
    ps = np.stack([np.full(N, 9.8), es], 1)
    return ensemble_problem(tdp.bouncing_ball_problem(), u0s, ps,
                            device=device)


def decay_ensemble(N, device):
    from repro_torch.convert import ensemble_problem
    lams = np.linspace(0.5, 2.0, N)
    return ensemble_problem(tdp.linear_decay_problem(), np.ones((N, 1)),
                            lams[:, None], device=device)


def assert_event_parity(rk, rt, tol):
    assert torch.equal(rk.naccept, rt.naccept)
    assert torch.equal(rk.nreject, rt.nreject)
    for a, b in ((rk.us, rt.us), (rk.u_final, rt.u_final),
                 (rk.t_final, rt.t_final)):
        if tol == 0:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["tsit5", "dopri5", "rosenbrock23"])
@pytest.mark.parametrize("case", ["decay", "ball"])
def test_cuda_ode_event_forms_match_plain_version(cuda, alg, case):
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    ep = (decay_ensemble if case == "decay" else ball_ensemble)(64, cuda)
    ev = tdp.half_event() if case == "decay" else tdp.bouncing_ball_event()
    tf = 3.0 if case == "decay" else 2.0
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=tf, dt0=1e-3,
              rtol=1e-9, atol=1e-9, saveat=[0.5, 1.0, 1.5, tf],
              event=ev, device=cuda)
    mod = rb_kernel if alg == "rosenbrock23" else erk_kernel
    # the stiff kernel's plain version solves W with the lanes LU
    lu = dict(linsolve="lanes") if alg == "rosenbrock23" else {}
    before = mod.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw, **lu)
    assert mod.launches == before + 1
    assert_event_parity(rk, rt, 0 if alg == "rosenbrock23" else 1e-10)
    if case == "ball":
        assert float(rk.us[:, :, 0].min()) > -1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("alg,w_reuse", [("rodas4", False), ("rodas4", True),
                                         ("rodas5p", False)])
def test_cuda_rober_event_form_bitwise(cuda, alg, w_reuse):
    ep = tdp.rober_ensemble(64, tspan=(0.0, 1e4))
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=1e4, dt0=1e-6,
              rtol=1e-6, atol=1e-8, saveat=[1e-2, 1.0, 1e2, 1e4],
              w_reuse=w_reuse, event=tdp.rober_half_event(), device=cuda)
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", linsolve="lanes", **kw)
    assert_event_parity(rk, rt, 0)
    done = rk.t_final < 1e4
    assert bool(done.any())
    assert float((rk.u_final[done, 2] - 0.5).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case,mode", [
    ("gbm", "fixed-em"), ("gbm", "fixed-platen_w2"), ("gbm", "embedded"),
    ("gbm", "doubling"), ("ramp", "fixed-em"), ("ramp", "embedded"),
    ("ramp", "doubling")])
def test_cuda_sde_event_forms_match_plain_version(cuda, case, mode):
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.convert import ensemble_problem
    N = 64
    if case == "gbm":
        prob = tdp.gbm_problem(r=1.5, v=0.2, dtype=torch.float64)
        ep = ensemble_problem(prob, np.full((N, 3), 0.1),
                              np.tile([1.5, 0.2], (N, 1)), device=cuda)
        ev = tdp.gbm_barrier_event()
    else:
        ep = ensemble_problem(tdp.ramp_problem(), np.zeros((N, 1)),
                              np.tile([1.0, 1e-10], (N, 1)), device=cuda)
        ev = tdp.ramp_sawtooth_event()
    if mode.startswith("fixed"):
        alg = mode.split("-")[1]
        kw = dict(alg=alg, t0=0.0, tf=1.0, dt0=1 / 200, n_steps=200,
                  save_every=50, seed=5)
        mod, tol = sde_kernel, 1e-12
    else:
        kw = dict(alg="em", adaptive=True, error_est=mode, t0=0.0, tf=1.0,
                  dt0=0.05, rtol=1e-3, atol=1e-5, seed=5,
                  saveat=[0.25, 0.5, 0.75, 1.0])
        mod, tol = k5, 0
    before = mod.launches
    rk = tsolve(ep, ensemble="kernel", backend="cuda", event=ev,
                device=cuda, **kw)
    rt = tsolve(ep, ensemble="kernel", backend="torch", event=ev,
                device=cuda, **kw)
    assert mod.launches == before + 1
    assert_event_parity(rk, rt, tol)


@pytest.mark.cuda
def test_cuda_event_without_device_form_raises(cuda):
    """An event without a hand-written form (an unregistered condition, an
    unpaired registered one, an affect that is not the functor's) runs on
    the card through a generated unit, one launch, bitwise its plain
    version; only what the translator cannot take raises (ROADMAP item
    17), before any launch: it never falls back to the plain version."""
    from repro_torch.core.events import Event
    ep = decay_ensemble(8, cuda)
    kw = dict(alg="tsit5", ensemble="kernel", t0=0.0, tf=1.0, dt0=1e-3,
              device=cuda)
    for ev in (Event(condition=lambda u, p, t: u[0] - 0.5),
               tdp.gbm_barrier_event(),
               tdp.half_event()._replace(affect=tdp.ramp_sawtooth_affect)):
        before = erk_kernel.launches
        rk = tsolve(ep, backend="cuda", event=ev, **kw)
        assert erk_kernel.launches == before + 1
        rt = tsolve(ep, backend="torch", event=ev, **kw)
        assert_event_parity(rk, rt, 1e-10)
    before = erk_kernel.launches
    with pytest.raises(NotImplementedError, match="item 17"):
        tsolve(ep, backend="cuda", event=Event(
            condition=lambda u, p, t: torch.erf(u[0])), **kw)
    assert erk_kernel.launches == before


# ---------------------------------------------------------------------------
# data-driven problems (prob.data): the data forms of K1, K3, K4 and K5 and
# the lookup entry, each against its plain version on the card
# ---------------------------------------------------------------------------

def osc_ensemble(N, dev, mode="gather", dtype=torch.float64, p=(4.0, 0.2)):
    prob = tdp.texture_oscillator_problem(mode, dtype=dtype)
    u0s = np.stack([[1.0, 0.0]] * N) * np.linspace(0.5, 1.5, N)[:, None]
    return ensemble_problem(prob, u0s, np.tile(p, (N, 1)), device=dev,
                            dtype=dtype)


def assert_same(rk, rt, tol):
    for name in ("us", "u_final", "t_final"):
        a, b = getattr(rk, name), getattr(rt, name)
        if tol == 0:
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=tol)
    assert torch.equal(rk.naccept.to(torch.int64), rt.naccept.to(torch.int64))
    assert torch.equal(rk.nreject.to(torch.int64), rt.nreject.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
@pytest.mark.parametrize("mode", ["gather", "onehot", "cubic"])
@pytest.mark.parametrize("alg", ["tsit5", "dopri5"])
def test_cuda_erk_data_forms_match_plain_version(cuda, alg, mode, adaptive):
    ep = osc_ensemble(256, cuda, mode)
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=1.0, dt0=1 / 200,
              rtol=1e-8, atol=1e-8, adaptive=adaptive,
              saveat=[0.25, 0.5, 1.0], device=cuda)
    before = erk_kernel.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw)
    assert erk_kernel.launches == before + 1
    # every operation of a data form is rounded on its own: bitwise.  The
    # plain onehot sums its contraction in cuBLAS, which moves the
    # adaptive step grid at the table's kinks; the kernel sums the
    # contraction's two terms that are not zero, the gather lookup, so the
    # onehot form equals the plain gather version
    if mode == "onehot" and adaptive:
        rt = tsolve(osc_ensemble(256, cuda, "gather"), backend="torch", **kw)
    assert_same(rk, rt, 1e-12 if mode == "onehot" and not adaptive else 0)


@pytest.mark.cuda
def test_cuda_erk_data_event_form_matches_plain_version(cuda):
    N = 128
    u0s = np.stack([[0.0, 2.0]] * N) * np.linspace(0.8, 1.2, N)[:, None]
    ep = ensemble_problem(tdp.forced_oscillator_problem(), u0s,
                          np.tile([1.0, 0.0], (N, 1)), device=cuda)
    kw = dict(alg="tsit5", ensemble="kernel", t0=0.0, tf=5.0, dt0=1e-2,
              rtol=1e-8, atol=1e-8, saveat=[1.0, 2.0, 5.0],
              event=tdp.osc_level_event(), device=cuda)
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw)
    assert_same(rk, rt, 0)
    assert bool((rk.t_final < 5.0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("w_reuse", [False, True], ids=["eager", "lazy-W"])
@pytest.mark.parametrize("alg", ["rosenbrock23", "rodas4", "rodas5p"])
def test_cuda_rosenbrock_data_form_matches_plain_version(cuda, alg, w_reuse):
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    import dataclasses
    N = 128
    prob = dataclasses.replace(tdp.forced_oscillator_problem(),
                               tspan=(0.0, 3.0))
    u0s = np.stack([[1.0, 0.0]] * N) * np.linspace(0.5, 1.5, N)[:, None]
    ep = ensemble_problem(prob, u0s, np.tile([50.0, 2.0], (N, 1)),
                          device=cuda)
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=3.0, dt0=1e-3,
              rtol=1e-8, atol=1e-8, saveat=np.linspace(0.0, 3.0, 7),
              w_reuse=w_reuse, device=cuda)
    before = rb_kernel.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", linsolve="lanes", **kw)
    assert rb_kernel.launches == before + 1
    assert_same(rk, rt, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fixed-em", "fixed-milstein",
                                  "fixed-table", "embedded", "doubling"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cuda_sde_data_forms_match_plain_version(cuda, mode, dtype):
    from repro_torch.kernels.em import adaptive as k5
    N = 256
    prob = tdp.gbm_rate_problem(dtype=dtype)
    ep = ensemble_problem(prob, np.ones((N, 1)), np.full((N, 1), 0.2),
                          device=cuda, dtype=dtype)
    if mode.startswith("fixed"):
        kw = dict(alg="em" if mode == "fixed-table" else mode[6:],
                  t0=0.0, tf=0.5, dt0=1e-3, n_steps=500, save_every=250,
                  seed=7)
        if mode == "fixed-table":
            z = np.random.default_rng(3).standard_normal((500, 1, N))
            kw["noise_table"] = torch.tensor(z, dtype=dtype, device=cuda)
        mod = sde_kernel
    else:
        kw = dict(alg="em", adaptive=True, error_est=mode, t0=0.0, tf=1.0,
                  dt0=1e-3, rtol=1e-4, atol=1e-6, seed=7,
                  saveat=[0.25, 0.5, 0.75, 1.0])
        mod = k5
    before = mod.launches
    rk = tsolve(ep, ensemble="kernel", backend="cuda", device=cuda, **kw)
    rt = tsolve(ep, ensemble="kernel", backend="torch", device=cuda, **kw)
    assert mod.launches == before + 1
    if dtype == torch.float64:
        assert_same(rk, rt, 0)
    else:
        # float32: the same arithmetic; an accept decision may follow a
        # last-ulp difference of the normals
        torch.testing.assert_close(rk.u_final, rt.u_final, rtol=1e-5,
                                   atol=1e-6)
        same = (rk.naccept == rt.naccept).double().mean()
        assert float(same) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["gather", "onehot", "cubic"])
def test_cuda_interp_lookup_matches_plain_version(cuda, mode, dtype):
    from repro_torch.core.interp import UniformTable1D, UniformTable2D
    from repro_torch.kernels import interp as kinterp
    rng = np.random.default_rng(0)
    t1 = UniformTable1D(torch.tensor(rng.standard_normal(33), dtype=dtype,
                                     device=cuda), -2.0, 0.25)
    t2 = UniformTable2D(torch.tensor(rng.standard_normal((9, 13)),
                                     dtype=dtype, device=cuda),
                        0.0, 0.5, -1.0, 0.25)
    # out of range, exact knots, both bounds
    x = np.concatenate([rng.uniform(-4.0, 8.0, 4000),
                        -2.0 + 0.25 * np.arange(33), [-2.0, 6.0]])
    y = rng.uniform(-2.0, 3.0, x.shape[0])
    y[:3] = [-1.0, 2.0, 0.5]
    qx = torch.tensor(x, dtype=dtype, device=cuda)
    qy = torch.tensor(y, dtype=dtype, device=cuda)
    tol = 0 if mode != "onehot" else (1e-12 if dtype == torch.float64
                                      else 1e-6)
    before = kinterp.launches
    for tab, args in ((t1, (qx,)), (t2, (qx, qy))):
        got = kinterp.interp_lookup(tab, *args, mode=mode)
        want = (kinterp.interp2d(tab, *args, mode) if len(args) == 2
                else kinterp.interp1d(tab, *args, mode))
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert kinterp.launches == before + 2


@pytest.mark.cuda
def test_cuda_data_without_device_form_raises(cuda):
    """A data-driven RHS without a hand-written data functor (an
    unregistered one, a registered functor that reads no dataset) runs on
    the card through a generated unit, one launch, bitwise its plain
    version; reading a table other than through the lookups raises (ROADMAP
    item 17) before any launch: it never falls back."""
    import dataclasses
    ep = osc_ensemble(8, cuda)
    plain = dataclasses.replace(
        ep.prob, f=lambda u, p, t, d: tdp.forced_oscillator_rhs(u, p, t, d))
    kw = dict(alg="tsit5", ensemble="kernel", t0=0.0, tf=1.0, dt0=1e-2,
              device=cuda)
    lor = tdp.lorenz_problem(torch.float64)
    bad = dataclasses.replace(lor, data=ep.prob.data,
                              f=lambda u, p, t, d: tdp.lorenz_rhs(u, p, t))
    bad.f.device_rhs = "lorenz"
    for e in (EnsembleProblem(plain, 8, u0s=ep.u0s, ps=ep.ps),
              EnsembleProblem(bad, 8)):
        before = erk_kernel.launches
        rk = tsolve(e, backend="cuda", **kw)
        assert erk_kernel.launches == before + 1
        assert_same(rk, tsolve(e, backend="torch", **kw), 0)
    reads = dataclasses.replace(
        ep.prob, f=lambda u, p, t, d: torch.stack(
            [u[1], -u[0] + d["force"].values[0]]))
    before = erk_kernel.launches
    with pytest.raises(NotImplementedError, match="item 17"):
        tsolve(EnsembleProblem(reads, 8, u0s=ep.u0s, ps=ep.ps),
               backend="cuda", **kw)
    assert erk_kernel.launches == before


# ---------------------------------------------------------------------------
# the trajectory work queue of K3 and K5 (csrc/trajectory_queue.cuh): sizes
# at its edges, each one launch, bitwise against the plain version
# ---------------------------------------------------------------------------

QUEUE_SIZES = {"below-a-warp": (17, 0), "ragged": (5000, 0),
               "offset-2^32-20": (300, 2 ** 32 - 20),
               "2^20+1": (2 ** 20 + 1, 0)}


def assert_bitwise(out_k, out_p):
    for a, b in zip(out_k, out_p):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("est", ["embedded", "doubling"])
@pytest.mark.parametrize("size", list(QUEUE_SIZES))
def test_cuda_sde_adaptive_queue_edges_bitwise(cuda, size, est):
    """K5 in f64 on GBM (rows of u0 spread 10%), N below one warp, N no
    multiple of the persistent grid, N = 2^20 + 1 and a lane offset that
    wraps the 32-bit lane key."""
    from repro_torch.core.ensemble import resolve_adaptive_sde
    from repro_torch.core.methods import get_method
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em.ref import solve_adaptive_lanes
    N, offset = QUEUE_SIZES[size]
    f64 = torch.float64
    prob = tdp.gbm_problem(r=1.5, v=0.2, dtype=f64)
    rng = np.random.default_rng(4)
    u0 = torch.tensor(0.1 * (1.0 + 0.1 * rng.random((3, N))), dtype=f64,
                      device=cuda)
    p = torch.tensor([[1.5], [0.2]], dtype=f64,
                     device=cuda).expand(2, N).contiguous()
    sv = torch.tensor([0.125, 0.25], dtype=f64, device=cuda)
    kw = dict(resolve_adaptive_sde(get_method("em"), "diagonal",
                                   error_est=est, brownian_depth=14,
                                   t0=0.0, tf=0.25, dt0=0.05),
              noise="diagonal", m_noise=3, t0=0.0, tf=0.25, dt0=0.05,
              rtol=1e-3, atol=1e-5, max_iters=100_000, seed=7,
              lane_offset=offset)
    before = k5.launches
    out_k = k5.sde_adaptive_ensemble(prob.f, prob.g, "em", u0, p, sv, **kw)
    assert k5.launches == before + 1
    out_p = solve_adaptive_lanes(prob.f, prob.g, "em", u0, p, sv, **kw)
    assert int(out_k[3][2].max()) == 0
    assert_bitwise(out_k, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("alg,w_reuse", [("rodas5p", False),
                                         ("rodas4", True)])
@pytest.mark.parametrize("N", [17, 5000, 2 ** 20 + 1])
def test_cuda_rosenbrock_grid_edges_bitwise(cuda, N, alg, w_reuse):
    """K3 in f64 on ROBER (k1 log-swept), one trajectory a thread (it takes
    no work queue and draws no random numbers): N below one warp, N no
    multiple of the block and N = 2^20 + 1, whose last block holds one
    trajectory."""
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels.rosenbrock import kernel as k3
    ep = tdp.rober_ensemble(N, tspan=(0.0, 10.0))
    u0s, ps = ep.materialize()
    u0 = u0s.T.contiguous().to(cuda)
    p = ps.T.contiguous().to(cuda)
    sv = torch.tensor([1e-2, 1.0, 10.0], dtype=torch.float64, device=cuda)
    rtab = get_rosenbrock_tableau(alg)
    kw = dict(jac=ep.prob.jac, t0=0.0, tf=10.0, dt0=1e-6, rtol=1e-6,
              atol=1e-8, max_iters=100_000, w_reuse=w_reuse)
    before = k3.launches
    out_k = k3.rosenbrock_ensemble(ep.prob.f, rtab, u0, p, sv, **kw)
    assert k3.launches == before + 1
    out_p = k3._plain(ep.prob.f, rtab, u0, p, sv, **kw)
    assert int(out_k[3][2].max()) == 0
    assert_bitwise(out_k, out_p)


# ---------------------------------------------------------------------------
# gradients across the kernel boundary (kernel_adjoint)
# ---------------------------------------------------------------------------

def _grad(ep, backend, wrt, **kw):
    """(result, gradients of sum(us^2) + sum(u_final^2)) with
    sensitivity="adjoint" on the kernel strategy."""
    u0s, ps = ep.materialize()
    u = u0s.detach().clone().requires_grad_("u0s" in wrt)
    p = ps.detach().clone().requires_grad_("ps" in wrt)
    res = tsolve(EnsembleProblem(ep.prob, u.shape[0], u0s=u, ps=p),
                 ensemble="kernel", backend=backend, sensitivity="adjoint",
                 device=u.device, **kw)
    L = (res.us ** 2).sum() + (res.u_final ** 2).sum()
    return res, torch.autograd.grad(L, [u if k == "u0s" else p
                                        for k in wrt])


def _grad_cases(cuda):
    u0s, ps = lorenz_arrays(64)
    gbm_u0, gbm_p = np.full((64, 3), 0.1), np.tile([1.5, 0.2], (64, 1))
    rober = ensemble_problem(tdp.rober_problem(), np.tile([1.0, 0, 0],
                                                          (64, 1)),
                             np.tile([0.04, 3e7, 1e4], (64, 1))
                             * np.linspace(0.5, 2.0, 64)[:, None],
                             device=cuda)
    gbm = ensemble_problem(tdp.gbm_problem(r=1.5, v=0.2,
                                           dtype=torch.float64), gbm_u0,
                           gbm_p, device=cuda)
    return {
        "erk": (ensemble_problem(lorenz_problem(torch.float64), u0s, ps,
                                 device=cuda),
                dict(alg="tsit5", t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-8,
                     atol=1e-8, saveat=[0.5, 1.0], adjoint_steps=200)),
        "rosenbrock": (rober, dict(alg="rodas5p", t0=0.0, tf=10.0,
                                   dt0=1e-6, rtol=1e-6, atol=1e-8,
                                   saveat=[1.0, 10.0], linsolve="lanes",
                                   adjoint_steps=200)),
        "sde": (gbm, dict(alg="em", t0=0.0, dt0=1.0 / 100, n_steps=100,
                          save_every=50, seed=5)),
        "sde_adaptive": (gbm, dict(alg="em", t0=0.0, tf=1.0, dt0=0.05,
                                   adaptive=True, rtol=1e-3, atol=1e-5,
                                   seed=5, saveat=[0.5, 1.0],
                                   adjoint_steps=200)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["erk", "rosenbrock", "sde",
                                    "sde_adaptive"])
def test_cuda_kernel_adjoint_primal_and_gradient(cuda, family):
    """The primal is the plain kernel solve bit for bit.  The gradient
    replays the torch route's bounded loop: bitwise equal to that route's
    where the kernel rounds every operation (K3, K5); on K1's and K4's
    no-event forms nvcc contracts, the cotangents' base moves by rounding,
    and the two agree within 1e-10 of the largest entry."""
    ep, kw = _grad_cases(cuda)[family]
    res, g_cuda = _grad(ep, "cuda", ("u0s", "ps"), **kw)
    plain = tsolve(ep, ensemble="kernel", backend="cuda", device=cuda,
                   **{k: v for k, v in kw.items() if k != "adjoint_steps"})
    assert torch.equal(res.us.detach(), plain.us)
    assert torch.equal(res.u_final.detach(), plain.u_final)
    assert int(res.status) == 0
    _, g_torch = _grad(ep, "torch", ("u0s", "ps"), **kw)
    for a, b in zip(g_cuda, g_torch):
        assert bool(torch.isfinite(a).all())
        if family in ("rosenbrock", "sde_adaptive"):
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 1e-10 * float(
                b.abs().max())


@pytest.mark.cuda
def test_cuda_launch_refuses_grad_outside_kernel_adjoint(cuda):
    ep, kw = _grad_cases(cuda)["sde"]
    u0s, ps = ep.materialize()
    with pytest.raises(ValueError, match='sensitivity="adjoint"'):
        tsolve(EnsembleProblem(ep.prob, 64, u0s=u0s.requires_grad_(True),
                               ps=ps), ensemble="kernel", backend="cuda",
               device=cuda, **kw)


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu, csrc/flash_attention_sm90.cu)
# and the dense LM served with it
# ---------------------------------------------------------------------------

FLASH_SHAPES = {"gqa-2": (2, 64, 4, 2, 32, True),
                "ragged-40": (1, 40, 2, 2, 16, True),
                "noncausal": (1, 32, 2, 2, 16, False),
                "ragged-1000-g8": (1, 1000, 8, 1, 128, True),
                "hd256": (1, 300, 4, 2, 256, True),
                "hd64-g1": (1, 200, 4, 4, 64, True)}
# the tensor-core form (bfloat16 at hd 64 and 128): FLASH_SHAPES at both of
# its head dims, and T = 1000 with g = 2 and 8 at B H = 64
SM90_SHAPES = {f"{name}-hd{hd}": (B, T, H, KV, hd, causal)
               for name, (B, T, H, KV, _, causal) in FLASH_SHAPES.items()
               for hd in (64, 128)}
SM90_SHAPES.update({"t1000-g2-bh64": (4, 1000, 16, 8, 128, True),
                    "t1000-g8-bh64": (8, 1000, 8, 1, 128, True)})
# |kernel - plain| <= 3 2^-8 max|v| elementwise and 2^-8 by relative norm:
# P rounded to bfloat16 (u = 2^-8) moves o by at most u max|v|, each of two
# output roundings by u |o| (tests/test_torch_flashattn.py)
SM90_ELEM, SM90_REL = 3 * 2.0 ** -8, 2.0 ** -8


def _flash_inputs(B, T, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd))]


def _sm90_errs(got, want, v):
    d = got.double() - want.double()
    return (float(d.abs().max() / v.double().abs().max()),
            float(d.norm() / want.double().norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_cuda_flash_attention_matches_plain_version(cuda, shape, dtype):
    """The kernel against its plain version (on the CPU, same inputs):
    float32 and float64 inputs within 2e-5 (the reference's bar against the
    dense oracle; both compute in float32), bfloat16 within 2 ulps on the
    CUDA-core form and at the tensor-core form's bar (SM90_ELEM, SM90_REL:
    it rounds P to bfloat16) where hd is 64 or 128."""
    from repro_torch.kernels.flashattn import kernel as flash_kernel
    from repro_torch.kernels.flashattn.ops import flash_attention
    from repro_torch.kernels.flashattn.ref import bf16_ulps
    B, T, H, KV, hd, causal = FLASH_SHAPES[shape]
    q, k, v = _flash_inputs(B, T, H, KV, hd, getattr(torch, dtype))
    sm90 = flash_kernel.form_of(q.dtype, hd) == "sm90"
    before = (flash_kernel.launches, flash_kernel.launches_sm90)
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal)
    torch.cuda.synchronize()
    assert (flash_kernel.launches, flash_kernel.launches_sm90) == (
        before[0] + 1, before[1] + sm90)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention(q, k, v, causal=causal)
    if sm90:
        elem, rel = _sm90_errs(got.cpu(), want, v)
        assert elem <= SM90_ELEM and rel <= SM90_REL, (elem, rel)
    elif dtype == "bfloat16":
        assert bf16_ulps(got.cpu(), want) <= 2.0
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SM90_SHAPES))
def test_cuda_flash_sm90_form_matches_plain_version(cuda, shape):
    """The tensor-core form (bfloat16, hd 64 and 128) against the plain
    version on the CPU at SM90_ELEM and SM90_REL; one launch of it, and
    none of the CUDA-core form."""
    from repro_torch.kernels.flashattn import kernel as flash_kernel
    from repro_torch.kernels.flashattn.ops import flash_attention
    B, T, H, KV, hd, causal = SM90_SHAPES[shape]
    q, k, v = _flash_inputs(B, T, H, KV, hd, torch.bfloat16, seed=1)
    before = (flash_kernel.launches, flash_kernel.launches_sm90)
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal)
    torch.cuda.synchronize()
    assert (flash_kernel.launches, flash_kernel.launches_sm90) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == q.dtype and got.shape == q.shape
    elem, rel = _sm90_errs(got.cpu(), flash_attention(q, k, v, causal=causal),
                           v)
    assert elem <= SM90_ELEM and rel <= SM90_REL, (elem, rel)


@pytest.mark.cuda
def test_cuda_flash_sm90_form_never_falls_back(cuda, monkeypatch):
    """A bfloat16 CUDA tensor at hd 64 or 128 goes to the tensor-core form
    only: when its launch fails the wrapper raises, counts nothing and
    never calls the CUDA-core form; float32 at the same hd takes the
    CUDA-core form."""
    from repro_torch.kernels.flashattn import kernel as flash_kernel
    called = []

    def bind(form):
        def launch(*args):
            called.append(form)
            return 1 if form == "sm90" else 0
        return launch

    monkeypatch.setattr(flash_kernel, "_bind", bind)
    before = (flash_kernel.launches, flash_kernel.launches_sm90)
    for hd in (64, 128):
        q, k, v = (x.to(cuda) for x in _flash_inputs(1, 128, 2, 2, hd,
                                                     torch.bfloat16))
        with pytest.raises(RuntimeError, match="sm90 form"):
            flash_kernel.flash_attention_kernel(q, k, v)
        flash_kernel.flash_attention_kernel(q.float(), k.float(), v.float())
    assert called == ["sm90", "cuda_core"] * 2
    assert (flash_kernel.launches, flash_kernel.launches_sm90) == (
        before[0] + 2, before[1])


@pytest.mark.cuda
def test_cuda_flash_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    from repro_torch.kernels.flashattn.kernel import flash_attention_kernel
    q = torch.zeros(1, 64, 4, 32, device=cuda)
    kv = torch.zeros(1, 64, 2, 32, device=cuda)
    kv48 = torch.zeros(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_kernel(torch.zeros(1, 64, 4, 48, device=cuda), kv48,
                               kv48, block_q=64, block_k=64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_kernel(q.half(), kv.half(), kv.half(), block_q=64,
                               block_k=64)
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention_kernel(q[:, :, :3].contiguous(), kv, kv,
                               block_q=64, block_k=64)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(q, torch.zeros(1, 64, 2, 64, device=cuda)
                               [..., :32], kv, block_q=64, block_k=64)
    # the tensor-core form reads by TMA: 16-byte aligned storage only
    qb = torch.zeros(1 * 64 * 4 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    kvb = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_kernel(qb[1:].view(1, 64, 4, 64), kvb, kvb,
                               block_q=64, block_k=64)


@pytest.mark.cuda
def test_cuda_dense_lm_serves_with_the_flash_core(cuda):
    """internlm2 reduced, float32, the same weights on the CPU and the card:
    the card's prefill with K7 as its attention core against the CPU's
    dense core (2e-4 of the largest logit, tests/test_torch_lm.py's float32
    bar), one K7 launch a layer, and 4 greedy decode steps equal."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.kernels.flashattn import kernel as flash_kernel
    from repro_torch.kernels.flashattn.ops import flash_attention
    from repro_torch.models.model import build_model
    from repro_torch.train.serve import make_serve_plan
    cfg = get_arch("internlm2-1.8b-smoke")
    cpu = build_model(cfg, torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = build_model(cfg, torch.float32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gpu.attn_core = flash_attention
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    plans = [make_serve_plan(m, None, 2, 48) for m in (cpu, gpu)]
    before = flash_kernel.launches
    (lc, cc), (lg, cg) = (p.prefill_fn({"tokens": toks.to(m.device)})
                          for p, m in zip(plans, (cpu, gpu)))
    assert flash_kernel.launches == before + cfg.n_layers
    V = cfg.vocab_size
    scale = float(lc[..., :V].abs().max())
    assert float((lg.cpu() - lc)[..., :V].abs().max()) <= 2e-4 * scale
    tc = lc[..., :V].argmax(-1)
    tg = lg[..., :V].argmax(-1)
    for _ in range(4):
        assert torch.equal(tg.cpu(), tc)
        (lc, cc), (lg, cg) = plans[0].decode_fn(cc, tc), plans[1].decode_fn(
            cg, tg)
        tc, tg = lc[..., :V].argmax(-1), lg[..., :V].argmax(-1)
    assert torch.equal(tg.cpu(), tc)


@pytest.mark.cuda
def test_cuda_bf16_lm_serves_with_the_sm90_flash_core(cuda):
    """internlm2 reduced (4 layers, head dim 128 as the full model's), the
    same weights served in bfloat16 with K7 as the attention core (its
    tensor-core form, once a layer) and in float32 on the dense core: the
    prefill's logits within 5e-2 by relative norm over the true vocab
    (chip_smoke.py's LM_BF16_REL, the bfloat16 bar)."""
    import dataclasses

    from repro_torch.configs.archs import get_arch
    from repro_torch.kernels.flashattn import kernel as flash_kernel
    from repro_torch.kernels.flashattn.ops import flash_attention
    from repro_torch.models.model import build_model
    from repro_torch.train.serve import make_serve_plan
    cfg = dataclasses.replace(get_arch("internlm2-1.8b-smoke"), head_dim=128)
    f32 = build_model(cfg, torch.float32, device=cuda).init_params(
        torch.Generator(device=cuda).manual_seed(0))
    bf16 = build_model(cfg, torch.bfloat16, device=cuda)
    bf16.load_state_dict(f32.state_dict())
    bf16.attn_core = flash_attention
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300))).to(cuda)
    before = (flash_kernel.launches, flash_kernel.launches_sm90)
    lb, _ = make_serve_plan(bf16, None, 2, 320).prefill_fn({"tokens": toks})
    torch.cuda.synchronize()
    assert (flash_kernel.launches, flash_kernel.launches_sm90) == (
        before[0] + cfg.n_layers, before[1] + cfg.n_layers)
    lf, _ = make_serve_plan(f32, None, 2, 320).prefill_fn({"tokens": toks})
    V = cfg.vocab_size
    got, want = lb[..., :V].double(), lf[..., :V].double()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) <= 5e-2


# ---------------------------------------------------------------------------
# K6 split in two (csrc/lu_solve.cu `lu_factor_launch`, `lu_resolve_launch`)
# and K4's shared Hill term and normals drawn a step ahead
# ---------------------------------------------------------------------------

def lu_systems(n, N, dtype, seed=3):
    """(N, n, n) systems as chip_smoke.lu_batch makes them (a zero diagonal
    one in 64, then a zero column and a zero matrix where N allows), and
    b (N, n)."""
    rng = np.random.default_rng(seed + n)
    W = rng.standard_normal((N, n, n))
    W[::64, np.arange(n), np.arange(n)] = 0.0
    if N > 3:
        W[N // 3, :, n // 2] = 0.0
        W[N - 2] = 0.0
    return (torch.from_numpy(W).to(dtype),
            torch.from_numpy(rng.standard_normal((N, n))).to(dtype))


def same_bits(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(7.0), b.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch-major", "lane-major"])
@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "nopivot"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("N", [1, 127, 2 ** 16 + 3])
def test_cuda_lu_factor_resolve_bitwise_to_one_shot(cuda, N, n, dtype, pivot,
                                                    layout):
    """The factor entry on W at either layout (no copy), then the resolve
    entry, give the one-shot kernel's x and pivmin bit for bit, singular
    systems included; the state's lane-major layout is what the plain
    version packs."""
    from repro_torch.kernels.lu import kernel as lu_kernel
    W, b = lu_systems(n, N, dtype)
    W, b = W.to(cuda), b.to(cuda)
    Wl, bl = W.permute(1, 2, 0).contiguous(), b.T.contiguous()
    Wv = W if layout == "batch-major" else Wl.permute(2, 0, 1)
    before = lu_kernel.factor_launches, lu_kernel.resolve_launches
    lu, piv, pm = lu_kernel.lu_factor(Wv, pivot=pivot)
    x = lu_kernel.lu_resolve(lu, piv, b.T)      # a strided right-hand side
    assert (lu_kernel.factor_launches, lu_kernel.resolve_launches) == (
        before[0] + 1, before[1] + 1)
    x1, pm1 = lu_kernel.lu_solve(Wl, bl, pivot=pivot)
    assert same_bits(x, x1) and same_bits(pm, pm1)
    plain = lu_kernel.pack_factors(lu_kernel.lu_factor_lanes(Wl, pivot=pivot),
                                   n)
    for got, want in zip((lu, piv, pm), plain):
        assert same_bits(got.double(), want.double())


@pytest.mark.cuda
def test_cuda_lu_reroute_at_factor_time_matches_batched_solve(cuda):
    from repro_torch.kernels.lu import ops as lu_ops
    W, b = lu_systems(3, 5000, torch.float64)
    W, b = W.to(cuda), b.to(cuda)
    fac = lu_ops.factor(W)
    assert fac.singular is not None
    before = lu_ops.rerouted
    want = lu_ops.batched_solve(W, b)
    k = lu_ops.rerouted - before
    got = lu_ops.resolve(fac, b.T)
    assert lu_ops.rerouted - before == 2 * k == 2 * fac.singular.numel()
    assert same_bits(got, want.T)


@pytest.mark.cuda
def test_cuda_lu_resolve_does_not_sync(cuda):
    """A resolve against a factorization with no singular system reads
    nothing back to the host: it runs under set_sync_debug_mode('error'),
    under which a host read raises."""
    from repro_torch.core import rosenbrock as rb
    from repro_torch.kernels.lu import ops as lu_ops
    W, b = lu_systems(3, 4096, torch.float64)
    W = W.to(cuda) + 4.0 * torch.eye(3, dtype=W.dtype, device=cuda)
    b = b.to(cuda).T.contiguous()
    fac = rb._w_factor(W, "cuda")
    assert fac.singular is None
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = rb._w_resolve(fac, b, "cuda")
        x2 = lu_ops.resolve(fac, 2.0 * b)
        with pytest.raises(RuntimeError):
            int(x.sum())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert same_bits(x2, lu_ops.resolve(fac, 2.0 * b))
    assert same_bits(x, lu_ops.batched_solve(W, b.T).T)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps,save_every", [(1, 1), (40, 40), (40, 8)])
@pytest.mark.parametrize("name,alg", [("crn", "em"), ("crn", "heun_strat"),
                                      ("gbm", "em"), ("gbm", "platen_w2")])
def test_cuda_sde_kernel_edges_match_plain_version(cuda, name, alg, n_steps,
                                                   save_every):
    """The normals drawn a step ahead and CRN's Hill term shared between
    drift and noise, at one step, a save only at the end, and N = 1000 (not
    a multiple of the block): f64 against the plain version at the bars of
    test_cuda_sde_kernel_matches_plain_version."""
    prob, u0s, ps = sde_inputs(name, 1000)
    ep = ensemble_problem(prob, u0s, ps, device=cuda)
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, dt0=0.05,
              n_steps=n_steps, save_every=save_every, seed=5,
              lane_offset=2 ** 32 - 300, device=cuda)
    before = sde_kernel.launches
    rk = tsolve(ep, backend="cuda", **kw)
    rt = tsolve(ep, backend="torch", **kw)
    assert sde_kernel.launches == before + 1
    fin = torch.isfinite(rt.us)
    assert torch.equal(torch.isfinite(rk.us), fin)
    torch.testing.assert_close(rk.us[fin], rt.us[fin], rtol=1e-12,
                               atol=1e-14)
    assert torch.equal(rk.naccept, rt.naccept)
    assert torch.equal(rk.t_final, rt.t_final) and int(rk.nf) == int(rt.nf)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n_steps,save_every", [(200, 50), (1, 1)])
def test_cuda_sde_barrier_frozen_lanes_bitwise(cuda, dtype, n_steps,
                                               save_every):
    """The event form (every operation rounded alone) on lanes that freeze
    at the barrier at different steps and lanes that never reach it: a
    frozen lane has drawn one step ahead and uses none of it, so states,
    times and counts equal the plain version's bit for bit."""
    from repro_torch.convert import ensemble_problem
    N = 1000
    u0 = np.linspace(0.05, 0.2, N)
    ep = ensemble_problem(tdp.gbm_problem(r=1.5, v=0.2, dtype=dtype),
                          np.stack([u0] * 3, 1), np.tile([1.5, 0.2], (N, 1)),
                          device=cuda, dtype=dtype)
    kw = dict(alg="em", t0=0.0, dt0=1 / 200, n_steps=n_steps,
              save_every=save_every, seed=5, event=tdp.gbm_barrier_event(),
              device=cuda)
    rk = tsolve(ep, ensemble="kernel", backend="cuda", **kw)
    rt = tsolve(ep, ensemble="kernel", backend="torch", **kw)
    if n_steps > 1:
        frozen = rk.naccept < n_steps
        assert 0 < int(frozen.sum()) < N
    assert_event_parity(rk, rt, 0)


# ---------------------------------------------------------------------------
# the automated translation (src/repro_torch/translate): an RHS without a
# registration traced into a generated functor of K1, K2, K3 and K4,
# held against the hand-written functor on the same inputs (bitwise: the
# same expressions) and against its plain version, driven by the traced
# function's `evaluate`; f64, N = 256
# ---------------------------------------------------------------------------

def _wrap(fn):
    """fn without its registration."""
    return lambda u, p, t: fn(u, p, t)


def _same(a, b):
    for k in ("us", "u_final", "t_final", "naccept", "nreject", "nf",
              "status", "njac", "nfact"):
        x = torch.as_tensor(getattr(a, k)).cpu()
        y = torch.as_tensor(getattr(b, k)).cpu()
        if x.is_floating_point():
            x, y = torch.nan_to_num(x), torch.nan_to_num(y)
        if not torch.equal(x, y):
            return False
    return True


def _plain_ep(ep, shapes):
    """ep with its callbacks replaced by their traced plain versions."""
    import dataclasses
    from repro_torch.translate.ir import as_function
    from repro_torch.translate.trace import trace
    prob = ep.prob
    repl = {k: as_function(trace(getattr(prob, k), prob.u0.shape[0],
                                 prob.p.shape[0], outputs=shape))
            for k, shape in shapes.items()}
    u0s, ps = ep.materialize()
    return EnsembleProblem(dataclasses.replace(prob, **repl),
                           ep.n_trajectories, u0s=u0s, ps=ps)


def _replaced(ep, **repl):
    import dataclasses
    u0s, ps = ep.materialize()
    return EnsembleProblem(dataclasses.replace(ep.prob, **repl),
                           ep.n_trajectories, u0s=u0s, ps=ps)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["tsit5", "dopri5", "rkck54", "bs3",
                                 "rkf45", "rk4", "vern7", "gbs10"])
def test_cuda_generated_k1_matches_hand_written_and_plain(cuda, alg):
    u0s, ps = lorenz_arrays(256)
    ep = ensemble_problem(lorenz_problem(torch.float64), u0s, ps,
                          device=cuda)
    gen = _replaced(ep, f=_wrap(tdp.lorenz_rhs))
    fixed = alg == "rk4"
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=0.5, dt0=2.0 ** -7,
              rtol=1e-8, atol=1e-8, adaptive=not fixed,
              saveat=torch.linspace(0, 0.5, 6), device=cuda)
    rh = tsolve(ep, backend="cuda", **kw)
    before = erk_kernel.launches
    rg = tsolve(gen, backend="cuda", **kw)
    assert erk_kernel.launches == before + 1
    assert _same(rg, rh)
    rp = tsolve(_plain_ep(gen, {"f": (3,)}), backend="torch", **kw)
    assert torch.equal(rg.naccept, rp.naccept)
    torch.testing.assert_close(rg.us, rp.us, rtol=1e-10, atol=1e-10)
    if alg in ROUNDED:
        assert _same(rg, rp)


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False])
def test_cuda_generated_user_tableau_is_its_plain_version(cuda, adaptive):
    from repro_torch.convert import tableau_from_arrays
    heun = tableau_from_arrays("heun_euler", [[0.0, 0.0], [1.0, 0.0]],
                               [0.5, 0.5], [-0.5, 0.5], [0.0, 1.0], order=2,
                               embedded_order=1, fsal=False)
    u0s, ps = lorenz_arrays(256)
    ep = ensemble_problem(lorenz_problem(torch.float64), u0s, ps,
                          device=cuda)
    kw = dict(alg=heun, ensemble="kernel", t0=0.0, tf=0.5, dt0=2.0 ** -8,
              rtol=1e-5, atol=1e-5, adaptive=adaptive,
              saveat=torch.linspace(0, 0.5, 6), device=cuda)
    for f in (tdp.lorenz_rhs, _wrap(tdp.lorenz_rhs)):
        before = erk_kernel.launches
        rg = tsolve(_replaced(ep, f=f), backend="cuda", **kw)
        assert erk_kernel.launches == before + 1
        rp = tsolve(_plain_ep(_replaced(ep, f=_wrap(tdp.lorenz_rhs)),
                              {"f": (3,)}), backend="torch", **kw)
        assert _same(rg, rp)


def _rober_ep(cuda, N=256):
    return ensemble_problem(
        tdp.rober_problem(tspan=(0.0, 1e4)), np.tile([1.0, 0.0, 0.0], (N, 1)),
        np.stack([np.geomspace(0.01, 0.1, N), np.full(N, 3e7),
                  np.full(N, 1e4)], 1), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("w_reuse", [False, True], ids=["eager", "lazyW"])
@pytest.mark.parametrize("alg", ["rosenbrock23", "rodas4", "rodas5p"])
def test_cuda_generated_k3_with_traced_jacobian_is_hand_written(cuda, alg,
                                                                w_reuse):
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    ep = _rober_ep(cuda)
    kw = dict(alg=alg, w_reuse=w_reuse, ensemble="kernel", t0=0.0, tf=1e4,
              dt0=1e-6, rtol=1e-6, atol=1e-8, device=cuda,
              saveat=torch.tensor([1e-2, 1.0, 1e2, 1e4], dtype=torch.float64))
    rh = tsolve(ep, backend="cuda", **kw)
    before = rb_kernel.launches
    rg = tsolve(_replaced(ep, f=_wrap(tdp.rober_rhs)), backend="cuda", **kw)
    assert rb_kernel.launches == before + 1
    assert _same(rg, rh)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rober", "orego", "vdp", "cos"])
def test_cuda_generated_k3_derived_jacobian_is_its_plain_version(cuda, name):
    """jac=None: the derived Jacobian against `torch.func.jacfwd` in the
    plain version (bitwise on these four in f64)."""
    from repro_torch.core.problem import ODEProblem
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    N = 256
    f64 = torch.float64
    sv = torch.linspace(0.0, 1.0, 5, dtype=f64)
    if name == "rober":
        ep, alg, tf, sv = _rober_ep(cuda), "rodas5p", 1e4, torch.tensor(
            [1e-2, 1.0, 1e2, 1e4], dtype=f64)
    elif name == "orego":
        ep = ensemble_problem(tdp.orego_problem(tspan=(0.0, 5.0)),
                              np.tile([1.0, 2.0, 3.0], (N, 1)),
                              np.tile([77.27, 8.375e-6, 0.161], (N, 1)),
                              device=cuda)
        alg, tf, sv = "rodas5p", 5.0, torch.linspace(0.0, 5.0, 6, dtype=f64)
    elif name == "vdp":
        ep = ensemble_problem(tdp.vdp_problem(), np.tile([2.0, 0.0], (N, 1)),
                              np.linspace(5.0, 20.0, N)[:, None],
                              device=cuda)
        alg, tf = "rodas4", 1.0
    else:
        cos_rhs = lambda u, p, t: torch.stack(  # noqa: E731
            [-p[0] * (u[0] - torch.cos(t))])
        ep = ensemble_problem(ODEProblem(cos_rhs, torch.zeros(1, dtype=f64),
                                         torch.ones(1, dtype=f64),
                                         (0.0, 1.0)),
                              np.zeros((N, 1)),
                              np.geomspace(1e3, 1e5, N)[:, None], device=cuda)
        alg, tf = "rosenbrock23", 1.0
    gen = _replaced(ep, f=_wrap(ep.prob.f), jac=None)
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=tf, dt0=1e-6,
              rtol=1e-6, atol=1e-8, saveat=sv, device=cuda)
    before = rb_kernel.launches
    rg = tsolve(gen, backend="cuda", **kw)
    assert rb_kernel.launches == before + 1
    n = ep.prob.u0.shape[0]
    rp = tsolve(_plain_ep(gen, {"f": (n,)}), backend="torch",
                linsolve="lanes", **kw)
    assert _same(rg, rp)


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True], ids=["rng", "table"])
@pytest.mark.parametrize("name,alg", [
    ("gbm", "em"), ("gbm", "heun_strat"), ("gbm", "platen_w2"),
    ("gbm", "milstein"), ("crn", "em"), ("crn", "heun_strat")])
def test_cuda_generated_k4_matches_hand_written_and_plain(cuda, name, alg,
                                                          table):
    N = 256
    if name == "gbm":
        prob = tdp.gbm_problem(r=1.5, v=0.2, dtype=torch.float64)
        rng = np.random.default_rng(0)
        u0s, ps = 0.1 + 0.01 * rng.random((N, 3)), np.array(
            [1.5, 0.2]) + 0.01 * rng.random((N, 2))
        kw = dict(dt0=0.01, n_steps=100, save_every=25)
    else:
        prob = tdp.crn_problem(dtype=torch.float64)
        u0s, ps = tdp.crn_sweep_arrays(N, 0)
        kw = dict(dt0=0.1, n_steps=100, save_every=25)
    ep = ensemble_problem(prob, u0s, ps, device=cuda)
    gen = _replaced(ep, f=_wrap(prob.f), g=_wrap(prob.g))
    m = prob.noise_dim()
    Z = (torch.randn((kw["n_steps"], m, N), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0)).to(cuda)
         if table else None)
    kw = dict(kw, alg=alg, ensemble="kernel", t0=0.0, seed=7,
              noise_table=Z, device=cuda)
    rh = tsolve(ep, backend="cuda", **kw)
    before = sde_kernel.launches
    rg = tsolve(gen, backend="cuda", **kw)
    assert sde_kernel.launches == before + 1
    if name == "gbm":
        assert _same(rg, rh)
    else:
        # K4's no-event form contracts; the generated CRN functor shares
        # sub-expressions the hand-written one recomputes, so nvcc may fuse
        # other products (ROADMAP queue 3): the plain-version bar
        assert torch.equal(rg.naccept, rh.naccept)
        fin = torch.isfinite(rh.u_final)
        assert torch.equal(fin, torch.isfinite(rg.u_final))
        torch.testing.assert_close(rg.u_final[fin], rh.u_final[fin],
                                   rtol=1e-12, atol=1e-12)
    if table:
        g_out = (3,) if name == "gbm" else (4, 8)
        rp = tsolve(_plain_ep(gen, {"f": (prob.u0.shape[0],), "g": g_out}),
                    backend="torch", **kw)
        fin = torch.isfinite(rp.u_final)
        assert torch.equal(fin, torch.isfinite(rg.u_final))
        torch.testing.assert_close(rg.u_final[fin], rp.u_final[fin],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_cuda_untraceable_rhs_raises_and_runs_nothing(cuda):
    """An RHS the translator cannot take raises at trace time on CUDA
    tensors: no kernel launch, no plain version."""
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.translate import ir
    calls = []
    real = ir.evaluate
    ir.evaluate = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        u0s, ps = lorenz_arrays(16)
        ep = ensemble_problem(lorenz_problem(torch.float64), u0s, ps,
                              device=cuda)
        before = (erk_kernel.launches, rb_kernel.launches)
        bad = _replaced(ep, f=lambda u, p, t: torch.stack(
            [torch.erf(u[0]), u[1], u[2]]))
        with pytest.raises(NotImplementedError, match="torch.erf"):
            tsolve(bad, alg="tsit5", backend="cuda", t0=0.0, tf=0.1,
                   dt0=1e-3, device=cuda)
        with pytest.raises(NotImplementedError, match="torch.where"):
            tsolve(_replaced(ep, f=_branchy), alg="rodas4", backend="cuda",
                   t0=0.0, tf=0.1, dt0=1e-3, device=cuda)
        assert (erk_kernel.launches, rb_kernel.launches) == before
        assert not calls
    finally:
        ir.evaluate = real


# ---------------------------------------------------------------------------
# the translation's event, data and K5 forms: generated against the
# hand-written form and the plain version; the forms no source compiles
# against the plain version (f64, N = 256 unless stated)
# ---------------------------------------------------------------------------

def _unreg(fn):
    def wrapper(*args):
        return fn(*args)
    return wrapper


def _plain_event(ev, n, m):
    from repro_torch.translate.ir import as_function
    from repro_torch.translate.trace import trace_event
    cond, affect = trace_event(ev.condition, ev.affect, n, m)
    return ev._replace(condition=as_function(cond),
                       affect=None if affect is None else as_function(affect))


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["tsit5", "vern7"])
def test_cuda_generated_event_form_is_hand_written_and_plain(cuda, alg):
    """The bouncing ball's condition and affect translated: bitwise the
    hand-written event form (tsit5) and its plain version."""
    N = 256
    es = np.linspace(0.3, 0.9, N)
    ep = ensemble_problem(tdp.bouncing_ball_problem(),
                          np.stack([np.full(N, 10.0), np.zeros(N)], 1),
                          np.stack([np.full(N, 9.8), es], 1), device=cuda)
    ev = tdp.bouncing_ball_event()
    gev = ev._replace(condition=_unreg(ev.condition),
                      affect=_unreg(ev.affect))
    kw = dict(alg=alg, ensemble="kernel", t0=0.0, tf=2.0, dt0=1e-3,
              rtol=1e-9, atol=1e-9, saveat=[0.5, 1.0, 1.5, 2.0],
              device=cuda)
    before = erk_kernel.launches
    rg = tsolve(ep, backend="cuda", event=gev, **kw)
    assert erk_kernel.launches == before + 1
    if alg == "tsit5":
        assert _same(rg, tsolve(ep, backend="cuda", event=ev, **kw))
    rp = tsolve(ep, backend="torch", event=_plain_event(gev, 2, 2), **kw)
    assert _same(rg, rp)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gather", "cubic"])
def test_cuda_generated_data_form_is_hand_written_and_plain(cuda, mode):
    """The forced oscillator's RHS translated with its table: bitwise the
    hand-written data form and its plain version (tsit5, fixed dt)."""
    from repro_torch.translate.ir import as_function
    from repro_torch.translate.trace import trace
    ep = osc_ensemble(256, cuda, mode=mode)
    gen = _replaced(ep, f=_unreg(ep.prob.f))
    kw = dict(alg="tsit5", ensemble="kernel", t0=0.0, tf=1.0, dt0=1.0 / 200,
              adaptive=False, saveat=[0.5, 1.0], device=cuda)
    before = erk_kernel.launches
    rg = tsolve(gen, backend="cuda", **kw)
    assert erk_kernel.launches == before + 1
    assert _same(rg, tsolve(ep, backend="cuda", **kw))
    f = as_function(trace(gen.prob.f, 2, 2, outputs=(2,),
                          data=ep.prob.data))
    assert _same(rg, tsolve(_replaced(gen, f=f), backend="torch", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("alg,est", [
    ("em", "doubling"), ("heun_strat", "doubling"), ("platen_w2", "doubling"),
    ("milstein", "doubling"), ("em", "embedded"), ("milstein", "embedded")])
def test_cuda_generated_k5_matches_hand_written(cuda, alg, est):
    """K5 on GBM, drift and diffusion translated (gdg derived; ddb the
    derivative of gdg along g): bitwise the hand-written functor's run."""
    from repro_torch.kernels.em import adaptive as k5
    N = 256
    rng = np.random.default_rng(0)
    prob = tdp.gbm_problem(r=1.5, v=0.2, dtype=torch.float64)
    ep = ensemble_problem(prob, 0.1 + 0.01 * rng.random((N, 3)),
                          np.array([1.5, 0.2]) + 0.01 * rng.random((N, 2)),
                          device=cuda)
    gen = _replaced(ep, f=_unreg(prob.f), g=_unreg(prob.g))
    kw = dict(alg=alg, ensemble="kernel", adaptive=True, error_est=est,
              t0=0.0, tf=1.0, dt0=0.05, rtol=1e-3, atol=1e-5, seed=7,
              saveat=[0.25, 0.5, 0.75, 1.0], device=cuda)
    before = k5.launches
    rg = tsolve(gen, backend="cuda", **kw)
    assert k5.launches == before + 1
    assert _same(rg, tsolve(ep, backend="cuda", **kw))


@pytest.mark.cuda
def test_cuda_k3_f32_event_form_matches_plain_version(cuda):
    """Van der Pol in f32 on rodas4 with a terminal event on u[0] = 0
    downward (no hand-written f32 event form): bitwise its f32 plain
    version."""
    from repro_torch.core.events import Event
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    N = 256
    mus = np.linspace(2.0, 3.0, N)[:, None]
    ep = ensemble_problem(tdp.vdp_problem(tspan=(0.0, 4.0),
                                          dtype=torch.float32),
                          np.tile([2.0, 0.0], (N, 1)), mus, device=cuda,
                          dtype=torch.float32)
    ev = Event(condition=lambda u, p, t: u[0], terminal=True, direction=-1)
    kw = dict(alg="rodas4", ensemble="kernel", t0=0.0, tf=4.0, dt0=1e-3,
              rtol=1e-4, atol=1e-6, saveat=[1.0, 2.0, 3.0, 4.0],
              device=cuda)
    before = rb_kernel.launches
    rk = tsolve(ep, backend="cuda", event=ev, **kw)
    assert rb_kernel.launches == before + 1
    assert bool((rk.t_final < 4.0).all())
    assert _same(rk, tsolve(ep, backend="torch", linsolve="lanes",
                            event=_plain_event(ev, 2, 1), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cuda_k4_data_and_event_form_matches_plain_version(cuda, dtype):
    """The rate-table GBM with a terminal up-and-out barrier at 1.1 (no
    hand-written data-and-event form): bitwise its plain version, on the
    counter stream."""
    from repro_torch.core.events import Event
    N = 4096
    ep = ensemble_problem(tdp.gbm_rate_problem(dtype=dtype),
                          np.ones((N, 1)), np.full((N, 1), 0.2), device=cuda,
                          dtype=dtype)
    ev = Event(condition=lambda u, p, t: u[0] - 1.1, terminal=True,
               direction=1)
    kw = dict(alg="em", ensemble="kernel", t0=0.0, dt0=1e-3, n_steps=500,
              save_every=250, seed=7, device=cuda)
    before = sde_kernel.launches
    rk = tsolve(ep, backend="cuda", event=ev, **kw)
    assert sde_kernel.launches == before + 1
    hit = float((rk.t_final < 0.5 - 1e-6).double().mean())
    assert 0.2 < hit < 0.8
    assert _same(rk, tsolve(ep, backend="torch",
                            event=_plain_event(ev, 1, 1), **kw))


@pytest.mark.cuda
def test_cuda_bf16_embedding_gradient_sums_in_float32(cuda):
    """The models' embedding lookup: on the card its backward sums a
    token's repeats in float32, so a bf16 table's gradient is within a
    bf16 rounding (2^-8 by norm) of the float64 one on Zipf tokens, where
    indexing's backward (sums in bf16) is ~3% off."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.model import build_model
    cfg = get_arch("internlm2-1.8b-smoke")
    toks = synth_batch(cfg, 0, 0, 2, 4096)["tokens"].to(cuda)
    up = torch.randn(*toks.shape, cfg.d_model, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
    grads = {}
    for dtype in (torch.float64, torch.bfloat16):
        model = build_model(cfg, dtype, device=cuda)
        with torch.no_grad():
            model.embed.zero_()
        (model._embed(toks) * up.to(dtype)).sum().backward()
        grads[dtype] = model.embed.grad.double()
    want = grads[torch.float64]
    assert float((grads[torch.bfloat16] - want).norm() / want.norm()) \
        <= 2.0 ** -8
