"""Data-driven problems (paper §6.7, `prob.data`) through the port's front
door, against the reference's (tests/test_texture_data.py:57-190), on the
port's four paths: ``vmap``, ``array``, ``kernel``/``torch`` and
``kernel``/``cuda`` (on the CPU its plain version), in float64 on the same
numpy inputs (`repro_torch.convert`).

Bars: fixed dt within 1e-12; adaptive within the reference's kink-limited
2e-5 (the table's knots are kinks of the RHS, and there the step-size
sequence follows rounding: per-lane counts are held between the port's two
kernel backends exactly and to the compiled reference within 10% (accepted)
and 15% (rejected));
rosenbrock23 (the reference's case, its span cut from 3 to 0.5) within
2e-5 with per-lane counts equal to the reference's (∂f/∂t through the
table takes JAX's tangent at t0 = 0, the first knot);
the SDE on a shared noise table within 1e-12, and adaptive on the
reference's normals with identical counts; event times within 1e-6 (the
kink-limited grid again; the port's two kernel backends bitwise).  The
reference's gradient case is held in tests/test_torch_grad_parity.py
(`test_grad_wrt_table_values_matches_reference`); its sharding case
(sharded == local bitwise, here over a one-rank gloo group, as the
reference's runs over a one-device mesh; tests/test_torch_api_distributed.py
runs it over two ranks) and its autotune cases (the key's data component)
close the file.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.de_problems import forced_oscillator_problem as r_osc
from repro.core import interp as R
from repro.core.ensemble import solve_ensemble_local as rsolve
from repro.core.events import Event as REvent
from repro.core.methods import get_method as r_get
from repro.core.methods import valid_dispatch as r_valid
from repro.core.problem import EnsembleProblem as REP
from repro.core.problem import SDEProblem as RSDE
from repro_torch import convert
from repro_torch.configs import de_problems as tdp
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.methods import get_method, valid_dispatch
from repro_torch.core.problem import bind_problem_data

PATHS = [("vmap", "torch"), ("array", "torch"), ("kernel", "torch"),
         ("kernel", "cuda")]
KERNEL_PATHS = PATHS[2:]


def osc_inputs(N=8):
    rp = r_osc()
    u0s = np.stack([np.asarray(rp.u0)] * N) * np.linspace(0.5, 1.5, N)[:,
                                                                       None]
    ps = np.stack([np.asarray(rp.p)] * N)
    return rp, u0s, ps


def r_ens(prob, u0s, ps):
    return REP(prob, u0s.shape[0], u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))


def t_ens(prob, u0s, ps, data=None):
    return convert.ensemble_problem(prob, u0s, ps, data=data)


def port(ep, strat, backend, **kw):
    return tsolve(ep, ensemble=strat, backend=backend, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def reference(case):
    """The reference's runs, once per case: (vmap, kernel/xla)."""
    if case == "fixed":
        rp, u0s, ps = osc_inputs()
        kw = dict(alg="tsit5", adaptive=False, dt0=0.01,
                  saveat=jnp.linspace(1.0, 5.0, 5))
    elif case == "adaptive":
        rp, u0s, ps = osc_inputs()
        kw = dict(alg="tsit5", saveat=jnp.linspace(0.0, 5.0, 11), dt0=1e-2,
                  rtol=1e-8, atol=1e-8)
    else:
        rp, u0s, ps = stiff_inputs()
        kw = dict(alg="rosenbrock23", saveat=jnp.linspace(0.0, STIFF_TF, 7),
                  dt0=1e-3, rtol=1e-8, atol=1e-8)
    ep = r_ens(rp, u0s, ps)
    return (rsolve(ep, ensemble="vmap", backend="xla", **kw),
            rsolve(ep, ensemble="kernel", backend="xla", **kw))


# ---------------------------------------------------------------------------
# the explicit-RK family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strat,backend", PATHS)
def test_fixed_dt_parity_all_paths(strat, backend):
    _, u0s, ps = osc_inputs()
    ref, _ = reference("fixed")
    r = port(t_ens(tdp.forced_oscillator_problem(), u0s, ps), strat,
             backend, alg="tsit5", adaptive=False, dt0=0.01,
             saveat=np.linspace(1.0, 5.0, 5))
    np.testing.assert_allclose(r.us.numpy(), np.asarray(ref.us), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r.u_final.numpy(), np.asarray(ref.u_final),
                               rtol=0, atol=1e-12)


ADAPTIVE = dict(alg="tsit5", saveat=np.linspace(0.0, 5.0, 11), dt0=1e-2,
                rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("strat,backend", PATHS)
def test_adaptive_parity_kink_limited(strat, backend):
    _, u0s, ps = osc_inputs()
    ref, ref_k = reference("adaptive")
    r = port(t_ens(tdp.forced_oscillator_problem(), u0s, ps), strat,
             backend, **ADAPTIVE)
    np.testing.assert_allclose(r.u_final.numpy(), np.asarray(ref.u_final),
                               rtol=0, atol=2e-5)
    if strat == "kernel":
        # XLA fuses the compiled reference's multiply-adds; at the kinks
        # the accept decisions follow that rounding (measured: naccept
        # within 5.3%, nreject within 12.7% per lane)
        for mine, theirs, band in ((r.naccept, ref_k.naccept, 0.1),
                                   (r.nreject, ref_k.nreject, 0.15)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=band)


def test_adaptive_kernel_backends_are_twins():
    """The CUDA kernel's plain version and the lanes path are the same
    computation: states bitwise, per-lane counts identical."""
    _, u0s, ps = osc_inputs()
    ep = t_ens(tdp.forced_oscillator_problem(), u0s, ps)
    a = port(ep, "kernel", "torch", **ADAPTIVE)
    b = port(ep, "kernel", "cuda", **ADAPTIVE)
    assert torch.equal(a.us, b.us) and torch.equal(a.u_final, b.u_final)
    assert torch.equal(a.naccept, b.naccept)
    assert torch.equal(a.nreject, b.nreject)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_gather_onehot_cubic_modes_in_kernel(backend):
    """The bench configuration's three lookup modes (N = 4, 200 fixed
    steps): gather and onehot agree within 1e-12, and each mode matches the
    reference's kernel lanes path on the same table."""
    N = 4
    u0s = np.stack([[1.0, 0.0]] * N) * np.linspace(0.5, 1.5, N)[:, None]
    ps = np.tile([4.0, 0.2], (N, 1))
    xs = np.linspace(0.0, 1.0, 64)
    F = np.sin(6.0 * xs) + 0.5 * np.cos(17.0 * xs)
    rtab = R.UniformTable1D(jnp.asarray(F), 0.0, float(xs[1] - xs[0]))
    kw = dict(alg="tsit5", adaptive=False, dt0=1 / 200, n_steps=200,
              save_every=200)
    out = {}
    for mode in ("gather", "onehot", "cubic"):
        def rhs(u, p, t, data, _m=mode):
            return jnp.stack([u[1], -p[0] * u[0] - p[1] * u[1]
                              + R.interp1d(data["force"], t, _m)])
        rp = dataclasses.replace(r_osc(), f=rhs, tspan=(0.0, 1.0),
                                 data={"force": rtab})
        ref = rsolve(r_ens(rp, u0s, ps), ensemble="kernel", backend="xla",
                     **kw)
        tp = tdp.texture_oscillator_problem(mode, dtype=torch.float64)
        r = port(t_ens(tp, u0s, ps), "kernel", backend, **kw)
        np.testing.assert_allclose(r.u_final.numpy(),
                                   np.asarray(ref.u_final), rtol=0,
                                   atol=1e-12)
        out[mode] = r.u_final
    torch.testing.assert_close(out["gather"], out["onehot"], rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the stiff family: ∂f/∂t through the table
# ---------------------------------------------------------------------------

# the reference's case runs to t = 3 (about 3,000 steps); the first 0.5
# holds the first step from the table's first knot, where the tie rule acts
STIFF_TF = 0.5


def stiff_inputs(N=6):
    def stiff_rhs(u, p, t, data):
        return jnp.stack([u[1], -p[0] * u[0] - p[1] * u[1]
                          + R.interp1d(data["force"], t)])
    rp = dataclasses.replace(r_osc(), f=stiff_rhs,
                             p=jnp.asarray([50.0, 2.0], jnp.float64),
                             tspan=(0.0, STIFF_TF))
    u0s = np.stack([np.asarray(rp.u0)] * N) * np.linspace(0.5, 1.5, N)[:,
                                                                       None]
    return rp, u0s, np.stack([np.asarray(rp.p)] * N)


@pytest.mark.parametrize("strat,backend", PATHS)
def test_rosenbrock_data_parity(strat, backend):
    _, u0s, ps = stiff_inputs()
    ref, ref_k = reference("stiff")
    prob = dataclasses.replace(tdp.forced_oscillator_problem(),
                               tspan=(0.0, STIFF_TF))
    r = port(t_ens(prob, u0s, ps), strat, backend, alg="rosenbrock23",
             saveat=np.linspace(0.0, STIFF_TF, 7), dt0=1e-3, rtol=1e-8,
             atol=1e-8)
    np.testing.assert_allclose(r.u_final.numpy(), np.asarray(ref.u_final),
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(r.naccept.numpy(),
                                  np.asarray(ref_k.naccept))
    np.testing.assert_array_equal(r.nreject.numpy(),
                                  np.asarray(ref_k.nreject))


# ---------------------------------------------------------------------------
# the SDE family
# ---------------------------------------------------------------------------

def rate_problems(N=8):
    ts = np.linspace(0.0, 2.0, 33)
    rate = R.UniformTable1D(jnp.asarray(0.02 + 0.01 * np.sin(ts)), 0.0,
                            float(ts[1] - ts[0]))

    def drift(u, p, t, d):
        return R.interp1d(d["rate"], t) * u

    def diffusion(u, p, t, d):
        return p[0] * u

    rp = RSDE(f=drift, g=diffusion, u0=jnp.ones(1), p=jnp.asarray([0.2]),
              tspan=(0.0, 1.0), noise="diagonal", data={"rate": rate})
    return (r_ens(rp, np.ones((N, 1)), np.full((N, 1), 0.2)),
            t_ens(tdp.gbm_rate_problem(), np.ones((N, 1)),
                  np.full((N, 1), 0.2)))


@pytest.mark.parametrize("strat,backend", PATHS)
def test_sde_data_parity_on_shared_noise(strat, backend):
    rep, tep = rate_problems()
    z = np.random.default_rng(7).standard_normal((500, 1, 8))
    kw = dict(alg="em", dt0=1e-3, n_steps=500, save_every=250)
    ref = rsolve(rep, ensemble="vmap", backend="xla",
                 noise_table=jnp.asarray(z), **kw)
    r = port(tep, strat, backend, noise_table=z, **kw)
    np.testing.assert_allclose(r.us.numpy(), np.asarray(ref.us), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r.u_final.numpy(), np.asarray(ref.u_final),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("strat,backend", PATHS)
def test_sde_adaptive_data_on_the_reference_normals(strat, backend,
                                                    monkeypatch):
    """The adaptive SDE engine sees the dataset too: with the reference's
    bridge normals substituted (their float32 Box–Muller differs by ulps,
    tests/test_torch_bridge.py), per-lane counts identical, states 1e-12."""
    from test_torch_adaptive_sde import ref_normals
    from repro_torch.kernels import rng as trng
    monkeypatch.setattr(trng, "bridge_normals", ref_normals)
    rep, tep = rate_problems()
    kw = dict(alg="em", adaptive=True, dt0=1e-3, rtol=1e-4, atol=1e-6,
              seed=7)
    ref = rsolve(rep, ensemble="kernel", backend="xla",
                 saveat=jnp.linspace(0.0, 1.0, 5), **kw)
    r = port(tep, strat, backend, saveat=np.linspace(0.0, 1.0, 5), **kw)
    np.testing.assert_allclose(r.u_final.numpy(), np.asarray(ref.u_final),
                               rtol=1e-12, atol=0)
    np.testing.assert_array_equal(r.naccept.numpy(), np.asarray(ref.naccept))
    np.testing.assert_array_equal(r.nreject.numpy(), np.asarray(ref.nreject))


# ---------------------------------------------------------------------------
# events with data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strat,backend", [("vmap", "torch")] + KERNEL_PATHS)
def test_events_compose_with_data(strat, backend):
    def rhs(u, p, t, data):
        return jnp.stack([u[1], -p[0] * u[0] + R.interp1d(data["force"], t)])
    rp = dataclasses.replace(r_osc(), f=rhs, u0=jnp.asarray([0.0, 2.0]),
                             p=jnp.asarray([1.0, 0.0]))
    N = 4
    u0s = np.stack([[0.0, 2.0]] * N) * np.linspace(0.8, 1.2, N)[:, None]
    ps = np.tile([1.0, 0.0], (N, 1))
    ev = REvent(condition=lambda u, p, t: u[0] - 1.5, direction=1,
                terminal=True)
    kw = dict(alg="tsit5", dt0=1e-2, rtol=1e-8, atol=1e-8)
    ref = rsolve(r_ens(rp, u0s, ps), ensemble="vmap", backend="xla",
                 saveat=jnp.linspace(0.0, 5.0, 6), event=ev, **kw)
    # the forced oscillator with damping p[1] = 0 computes the same RHS
    r = port(t_ens(tdp.forced_oscillator_problem(), u0s, ps), strat,
             backend, saveat=np.linspace(0.0, 5.0, 6),
             event=tdp.osc_level_event(), **kw)
    # the step grid before the crossing is kink-limited as above, so the
    # located time carries the dense output's error there (measured
    # 2.5e-7), not one bisection quantum (about 1e-11)
    np.testing.assert_allclose(r.t_final.numpy(), np.asarray(ref.t_final),
                               rtol=0, atol=1e-6)
    assert bool((r.t_final < 5.0).all())
    if strat == "kernel":
        twin = port(t_ens(tdp.forced_oscillator_problem(), u0s, ps),
                    "kernel", "torch", saveat=np.linspace(0.0, 5.0, 6),
                    event=tdp.osc_level_event(), **kw)
        assert torch.equal(r.t_final, twin.t_final)


# ---------------------------------------------------------------------------
# capability flag, binding, conversion
# ---------------------------------------------------------------------------

def test_valid_dispatch_rejects_data_incapable_method():
    spec = get_method("tsit5")
    assert valid_dispatch(spec, "vmap", "torch", data=True)[0]
    nodata = dataclasses.replace(spec, name="nodata", data_rhs=False)
    ok, why = valid_dispatch(nodata, "vmap", "torch", data=True)
    assert not ok and "data_rhs" in why
    assert valid_dispatch(nodata, "vmap", "torch", data=False)[0]
    # the reference answers the same
    r_nodata = dataclasses.replace(r_get("tsit5"), data_rhs=False)
    assert r_valid(r_nodata, "vmap", "xla", data=True)[0] is False


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_front_door_rejects_data_incapable_method(backend):
    _, u0s, ps = osc_inputs(2)
    ep = t_ens(tdp.forced_oscillator_problem(), u0s, ps)
    spec = dataclasses.replace(get_method("tsit5"), name="nodata_tsit5",
                               data_rhs=False)
    with pytest.raises(ValueError, match="data_rhs"):
        port(ep, "kernel", backend, alg=spec, saveat=[5.0], dt0=1e-2)


def test_bind_problem_data_closes_over_tables():
    prob = tdp.forced_oscillator_problem()
    bound = bind_problem_data(prob)
    assert bound.data is None
    u = torch.tensor([1.0, 0.0], dtype=torch.float64)
    want = prob.f(u, prob.p, 0.37, prob.data)
    assert torch.equal(bound.f(u, prob.p, 0.37), want)
    assert bind_problem_data(tdp.lorenz_problem()) is not None
    sde = bind_problem_data(tdp.gbm_rate_problem())
    assert torch.equal(sde.g(u[:1], sde.p, 0.0), 0.2 * u[:1])


def test_convert_carries_the_reference_dataset_exactly():
    rp = r_osc()
    d = convert.dataset(rp.data)
    np.testing.assert_array_equal(d["force"].values.numpy(),
                                  np.asarray(rp.data["force"].values))
    assert d["force"].dx == rp.data["force"].dx
    f32 = convert.dataset(rp.data, dtype=torch.float32)
    np.testing.assert_array_equal(
        f32["force"].values.numpy(),
        np.asarray(rp.data["force"].values).astype(np.float32))
    _, u0s, ps = osc_inputs(2)
    ep = convert.ensemble_problem(tdp.lorenz_problem(), u0s[:, :1].repeat(
        3, 1), np.tile([10.0, 20.0, 8 / 3], (2, 1)), data=rp.data)
    assert ep.prob.data["force"].values.dtype == torch.float64


def test_staged_driver_passes_the_tables_to_every_segment():
    """K2 (`run_ensemble_kernel_staged`) with data: the "table" extras reach
    every segment's body; three segments of the fixed-dt data form agree
    with one launch within 1e-12 (each segment restarts its clock at its
    first save, where one launch has summed the steps)."""
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
    _, u0s, ps = osc_inputs(4)
    ep = t_ens(tdp.forced_oscillator_problem(), u0s, ps)
    sv = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    kw = dict(t0=0.0, tf=4.0, dt0=0.01, rtol=1e-8, atol=1e-8, adaptive=False,
              saveat=sv, data=ep.prob.data)
    staged = solve_ensemble_cuda(ep.prob, ep.u0s, ep.ps, get_tableau("tsit5"),
                                 save_chunks=3, **kw)
    one = solve_ensemble_cuda(ep.prob, ep.u0s, ep.ps, get_tableau("tsit5"),
                              save_chunks=1, **kw)
    torch.testing.assert_close(staged.us, one.us, rtol=0, atol=1e-12)
    assert int(staged.naccept.sum()) == int(one.naccept.sum())


# ---------------------------------------------------------------------------
# sharded == local, and the autotune key's data component
# ---------------------------------------------------------------------------

def test_sharded_equals_local_with_data():
    import torch.distributed as dist
    from repro_torch.core.api import solve_ensemble
    _, u0s, ps = osc_inputs()
    ep = t_ens(tdp.forced_oscillator_problem(), u0s, ps)
    kw = dict(alg="tsit5", saveat=np.linspace(0.0, 5.0, 6), dt0=1e-2,
              rtol=1e-7, atol=1e-7, ensemble="kernel", backend="cuda",
              device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rm = solve_ensemble(ep, dist.group.WORLD, **kw)
    finally:
        dist.destroy_process_group()
    rl = tsolve(ep, **kw)
    assert torch.equal(rl.u_final, rm.u_final)
    assert torch.equal(rl.us, rm.us)
    assert torch.equal(rl.naccept, rm.naccept)


def test_autotune_key_has_data_component():
    from repro_torch.core.autotune import config_key
    from repro_torch.core.interp import data_signature
    prob = tdp.forced_oscillator_problem()
    spec = get_method("tsit5")
    kw = dict(n=2, N=8, dtype=torch.float64, adaptive=True, events=False,
              w_reuse=False, error_est="none")
    k_free = config_key(spec, **kw)
    k_data = config_key(spec, data_sig=data_signature(prob.data), **kw)
    assert "data=none" in k_free
    assert "data=" in k_data and k_free != k_data
    # the signature tracks shape and dtype, so either re-tunes
    assert data_signature(prob.data) != "none"
    assert data_signature(prob.data) == R.data_signature(r_osc().data)


def test_resolve_auto_key_distinguishes_data(tmp_path):
    from repro_torch.core.autotune import clear_memory_cache, resolve_auto
    _, u0s, ps = osc_inputs(4)
    ep = t_ens(tdp.forced_oscillator_problem(), u0s, ps)
    clear_memory_cache()
    cache = str(tmp_path / "tune.json")
    spec = get_method("tsit5")
    kw = dict(dt0=1e-2, saveat=np.linspace(0.0, 5.0, 6), cache_path=cache,
              repeats=1, device="cpu")
    dec_data = resolve_auto(ep, spec, **kw)
    bound = bind_problem_data(ep.prob)
    free = t_ens(dataclasses.replace(bound, name="free"), u0s, ps)
    dec_free = resolve_auto(free, spec, **kw)
    assert dec_data.key != dec_free.key
    assert "data=" in dec_data.key
    clear_memory_cache()
