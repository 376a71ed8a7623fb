"""The CUDA kernel itself, on the card: marked `cuda`, skipped without it.

This file imports only torch and the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.de_problems import lorenz_problem
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.tableaus import get_tableau
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
