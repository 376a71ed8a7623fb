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


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    tab = get_tableau("tsit5")
    u0 = torch.ones(3, 8, dtype=torch.float64, device=cuda)
    p = torch.ones(3, 8, dtype=torch.float64, device=cuda)
    sv = torch.linspace(0, 1, 3, dtype=torch.float64, device=cuda)
    kw = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6, adaptive=True,
              max_iters=100)
    f = lorenz_problem().f
    with pytest.raises(NotImplementedError, match="device form"):
        erk_kernel.erk_ensemble(lambda u, p, t: -u, tab, u0, p, sv, **kw)
    with pytest.raises(NotImplementedError, match="not compiled"):
        erk_kernel.erk_ensemble(f, get_tableau("vern7"), u0, p, sv, **kw)
    with pytest.raises(ValueError, match="ascending"):
        erk_kernel.erk_ensemble(f, tab, u0, p, sv.flip(0).contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        erk_kernel.erk_ensemble(f, tab, u0.T.contiguous().T, p, sv, **kw)
    with pytest.raises(ValueError, match="float64"):
        erk_kernel.erk_ensemble(f, tab, u0, p.float(), sv, **kw)


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
    plain = SDEProblem(lambda u, p, t: p[0] * u, lambda u, p, t: p[1] * u,
                       torch.full((3,), 0.1, dtype=torch.float64),
                       torch.tensor([1.5, 0.2], dtype=torch.float64),
                       (0.0, 1.0))
    with pytest.raises(NotImplementedError, match="device form"):
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
    plain = ODEProblem(lambda u, p, t: -u, prob.u0, prob.p, (0.0, 1.0))
    kw = dict(alg="rodas4", backend="cuda", dt0=1e-6, device=cuda)
    with pytest.raises(NotImplementedError, match="device form"):
        tsolve(EnsembleProblem(plain, 8), **kw)
    other_jac = ODEProblem(prob.f, prob.u0, prob.p, (0.0, 1.0),
                           jac=lambda u, p, t: tdp.rober_jac(u, p, t))
    with pytest.raises(NotImplementedError, match="Jacobian"):
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
