"""Elastic fault-tolerant ensembles (`repro_torch.dist.elastic`,
`solve_ensemble_elastic`) against the reference's (`repro.dist.elastic`)
on the same numpy inputs, in float64 on the CPU, with tile_width=4.

Against the reference (clean, a killed shard, a checkpoint-write crash):
the same `report["mode"]`, failures and per-lane counts, adaptive states
within 1e-10, counter-stream SDE paths within 3e-7, the stiff one-shot
tiles at the ROBER bar (rtol 1e-6).

Inside the port, bitwise: every elastic run — clean, killed, resumed from
disk onto another shard count, or SIGKILLed in a subprocess and resumed in
a new one — equals one `solve_ensemble_local(..., ensemble="kernel",
backend="torch", lane_tile=tile_width)` call; one-shot runs equal their
clean run.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core import EnsembleProblem as JEnsembleProblem
from repro.dist import chaos as jchaos
from repro.dist import elastic as jelastic
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem
from repro_torch.core import solve_ensemble_local
from repro_torch.core.api import solve_ensemble_elastic
from repro_torch.dist import chaos as tchaos
from repro_torch.dist import elastic as telastic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
ADAPTIVE_TOL = 1e-10
RNG_TOL = 3e-7
CPU = dict(device="cpu")
ODE_KW = dict(tile_width=4, segment_steps=32, t0=0.0, tf=2.0, dt0=1e-2,
              rtol=1e-6, atol=1e-6, backoff_base=0.0)
SDE_KW = dict(tile_width=4, segment_steps=64, t0=0.0, tf=1.0, dt0=1.0 / 256,
              n_steps=256, seed=7, backoff_base=0.0)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def lorenz(N=12, seed=0):
    rng = np.random.default_rng(seed)
    u0s = np.array([1.0, 0.0, 0.0]) + 0.1 * rng.random((N, 3))
    ps = np.stack([np.full(N, 10.0), 21.0 * rng.random(N),
                   np.full(N, 8.0 / 3.0)], 1)
    return (JEnsembleProblem(jdp.lorenz_problem(jnp.float64), N,
                             u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
            ensemble_problem(tdp.lorenz_problem(F64), u0s, ps))


def gbm(N=12, seed=1):
    rng = np.random.default_rng(seed)
    u0s = 0.1 + 0.01 * rng.random((N, 3))
    ps = np.array([1.5, 0.2]) + 0.01 * rng.random((N, 2))
    return (JEnsembleProblem(jdp.gbm_problem(r=1.5, v=0.2,
                                             dtype=jnp.float64), N,
                             u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
            ensemble_problem(tdp.gbm_problem(r=1.5, v=0.2, dtype=F64), u0s,
                             ps))


def ref_ode(tep):
    return solve_ensemble_local(tep, alg="tsit5", ensemble="kernel",
                                backend="torch", t0=0.0, tf=2.0, dt0=1e-2,
                                rtol=1e-6, atol=1e-6, lane_tile=4, **CPU)


def ref_sde(tep):
    return solve_ensemble_local(tep, alg="em", ensemble="kernel",
                                backend="torch", t0=0.0, tf=1.0,
                                dt0=1.0 / 256, n_steps=256, seed=7,
                                lane_tile=4, **CPU)


def assert_bitwise(res, ref):
    np.testing.assert_array_equal(res.u_final, ref.u_final.numpy())
    np.testing.assert_array_equal(res.t_final, ref.t_final.numpy())
    np.testing.assert_array_equal(res.naccept, ref.naccept.numpy())
    np.testing.assert_array_equal(res.nreject, ref.nreject.numpy())
    assert (res.status == 0).all()


def run_both(alg, jep, tep, kw, schedule=(), tmp=None, **extra):
    """The same supervisor, chaos schedule and shard count in both
    packages: (reference result, port result)."""
    out = []
    for el, ch, ep, dev in ((jelastic, jchaos, jep, {}),
                            (telastic, tchaos, tep, CPU)):
        chaos = ch.ChaosMonkey(schedule=list(schedule)) if schedule else None
        d = tmp / ("ref" if el is jelastic else "port")
        out.append(el.ElasticSupervisor(ep, alg, ckpt_dir=str(d),
                                        chaos=chaos, **kw, **extra,
                                        **dev).run())
    return out


def assert_matches_reference(got, want, tol):
    assert got.report["mode"] == want.report["mode"]
    assert got.report["failures"] == want.report["failures"]
    assert got.report["epochs"] == want.report["epochs"]
    assert got.report["snapshots"] == want.report["snapshots"]
    np.testing.assert_array_equal(got.naccept, want.naccept)
    np.testing.assert_array_equal(got.nreject, want.nreject)
    np.testing.assert_array_equal(got.status, want.status)
    assert rel(got.u_final, want.u_final) <= tol
    assert rel(got.t_final, want.t_final) <= tol


# ---------------------------------------------------------------------------
# against the reference: clean, kill, checkpoint-write crash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,n_shards", [
    ((), 3), (((2, 1, "kill"),), 3), (((2, -1, "ckpt_crash"),), 2)],
    ids=["clean", "kill", "ckpt_crash"])
def test_ode_matches_reference_and_the_local_solve(tmp_path, schedule,
                                                   n_shards):
    """Adaptive tsit5 in segment mode: the port's report and counts are the
    reference's, its states within 1e-10; and bitwise one local solve."""
    jep, tep = lorenz()
    want, got = run_both("tsit5", jep, tep, ODE_KW, schedule, tmp_path,
                         n_shards=n_shards)
    assert got.report["mode"] == "segment"
    assert_matches_reference(got, want, ADAPTIVE_TOL)
    ref = ref_ode(tep)
    assert_bitwise(got, ref)
    assert got.nf == int(ref.nf)
    kinds = [f["kind"] for f in got.report["failures"]]
    assert kinds == [k for _, _, k in schedule]
    if schedule and schedule[0][2] == "kill":
        assert got.report["reshards"] >= 1 and got.report["restored_tiles"]
        assert 1 not in got.report["alive_shards"]
    if schedule and schedule[0][2] == "ckpt_crash":
        assert got.report["snapshots"] == got.report["epochs"] - 1


@pytest.mark.parametrize("schedule", [(), ((2, 0, "kill"),)],
                         ids=["clean", "kill"])
def test_sde_matches_reference_and_the_local_solve(tmp_path, schedule):
    """Fixed-dt em on the counter stream: a lane replayed on another shard
    redraws its own noise (GLOBAL lane index), so the killed run equals the
    local solve bit for bit, and the reference's within 3e-7."""
    jep, tep = gbm()
    want, got = run_both("em", jep, tep, SDE_KW, schedule, tmp_path,
                         n_shards=3)
    assert_matches_reference(got, want, RNG_TOL)
    assert_bitwise(got, ref_sde(tep))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_oneshot_rosenbrock_kill(tmp_path, backend):
    """Rosenbrock runs tiles one-shot (on `backend`: the stiff kernel's
    plain version on CPU tensors for "cuda").  A kill re-runs the lost
    tile: clean and killed agree bitwise, dense saves included, and with
    the local solve of lane_tile=4; the reference at the ROBER bar."""
    N = 8
    k1 = np.exp(np.linspace(np.log(0.01), np.log(0.1), N))
    u0s = np.tile([1.0, 0.0, 0.0], (N, 1))
    ps = np.stack([k1, np.full(N, 3e7), np.full(N, 1e4)], 1)
    jep = JEnsembleProblem(jdp.rober_problem(), N, u0s=jnp.asarray(u0s),
                           ps=jnp.asarray(ps))
    tep = ensemble_problem(tdp.rober_problem(), u0s, ps)
    kw = dict(tile_width=4, t0=0.0, tf=1.0, dt0=1e-6, rtol=1e-6, atol=1e-8,
              backoff_base=0.0)
    kill = [(1, 1, "kill")]

    def port(d, schedule=None):
        chaos = tchaos.ChaosMonkey(schedule=schedule) if schedule else None
        return telastic.ElasticSupervisor(
            tep, "rosenbrock23", ckpt_dir=str(tmp_path / d), n_shards=2,
            backend=backend, chaos=chaos, **kw, **CPU).run()

    clean, killed = port("a"), port("b", kill)
    want = jelastic.ElasticSupervisor(
        jep, "rosenbrock23", ckpt_dir=str(tmp_path / "ref"), n_shards=2,
        chaos=jchaos.ChaosMonkey(schedule=kill), **kw).run()
    assert clean.report["mode"] == killed.report["mode"] == "oneshot"
    assert want.report["mode"] == "oneshot"
    assert [f["kind"] for f in killed.report["failures"]] == ["kill"]
    for k in ("u_final", "naccept", "status", "us"):
        np.testing.assert_array_equal(getattr(killed, k), getattr(clean, k))
    assert killed.njac == clean.njac and killed.nfact == clean.nfact
    local = solve_ensemble_local(tep, alg="rosenbrock23", ensemble="kernel",
                                 backend=backend, lane_tile=4,
                                 **{k: v for k, v in kw.items()
                                    if k in ("t0", "tf", "dt0", "rtol",
                                             "atol")}, **CPU)
    np.testing.assert_array_equal(clean.u_final, local.u_final.numpy())
    np.testing.assert_array_equal(want.naccept, killed.naccept)
    np.testing.assert_allclose(killed.u_final, want.u_final, rtol=1e-6,
                               atol=1e-14)


def test_oneshot_adaptive_sde_kill(tmp_path):
    """Adaptive SDE (dt-path-dependent Brownian tree) rides the one-shot
    path: a killed-and-retried tile re-quantizes onto the same global tree,
    so killed == clean bitwise; counts as the reference's."""
    jep, tep = gbm(8)
    kw = dict(tile_width=4, t0=0.0, tf=1.0, dt0=0.05, adaptive=True,
              rtol=1e-3, atol=1e-5, seed=3, error_est="embedded",
              backoff_base=0.0)
    clean = telastic.ElasticSupervisor(tep, "em", ckpt_dir=str(tmp_path / "a"),
                                       n_shards=2, **kw, **CPU).run()
    want, killed = run_both("em", jep, tep, kw, ((1, 0, "kill"),), tmp_path,
                            n_shards=2)
    assert clean.report["mode"] == killed.report["mode"] == "oneshot"
    np.testing.assert_array_equal(killed.u_final, clean.u_final)
    np.testing.assert_array_equal(killed.naccept, clean.naccept)
    np.testing.assert_array_equal(killed.naccept, want.naccept)
    assert rel(killed.u_final, want.u_final) <= RNG_TOL
    assert killed.report["failures"] == want.report["failures"]


# ---------------------------------------------------------------------------
# inside the port: resume from disk, identity, degradation ladder
# ---------------------------------------------------------------------------

def test_disk_resume_different_shard_count_bitwise(tmp_path):
    """A run stopped after 2 epochs on 3 shards resumes on 2 shards, and the
    stitched run equals the local solve bitwise."""
    _, tep = lorenz()
    part = telastic.ElasticSupervisor(tep, "tsit5", ckpt_dir=str(tmp_path),
                                      n_shards=3, max_epochs=2, **ODE_KW,
                                      **CPU).run()
    assert (part.status == 1).any()      # genuinely unfinished mid-run
    res = solve_ensemble_elastic(tep, "tsit5", ckpt_dir=str(tmp_path),
                                 n_shards=2, resume=True, **ODE_KW, **CPU)
    assert res.report["resumed_from_epoch"] == 2
    assert_bitwise(res, ref_ode(tep))


def test_resume_identity_mismatch_rejected(tmp_path):
    _, tep = lorenz()
    telastic.ElasticSupervisor(tep, "tsit5", ckpt_dir=str(tmp_path),
                               n_shards=2, max_epochs=1, **ODE_KW,
                               **CPU).run()
    sup = telastic.ElasticSupervisor(tep, "tsit5", ckpt_dir=str(tmp_path),
                                     n_shards=2,
                                     **dict(ODE_KW, tile_width=8), **CPU)
    with pytest.raises(ValueError, match="tile_width"):
        sup.run(resume=True)


def test_degradation_ladder_partial_result(tmp_path):
    """Every epoch kills a shard: the ladder walks down to a single revived
    host and, past max_failures, bails to a partial result whose unfinished
    lanes carry STATUS_SHARD_LOST."""
    _, tep = lorenz()
    sup = telastic.ElasticSupervisor(
        tep, "tsit5", ckpt_dir=str(tmp_path), n_shards=2, max_failures=3,
        chaos=tchaos.ChaosMonkey(seed=1, p_kill=1.0),
        **dict(ODE_KW, segment_steps=8), **CPU)
    res = sup.run()
    assert res.report["bailed"] and res.report["degraded_single_host"]
    assert res.report["ladder"] and res.report["ladder"][-1] == 1
    got = set(np.unique(res.status).tolist())
    assert telastic.STATUS_SHARD_LOST in got
    assert got <= {0, telastic.STATUS_SHARD_LOST}


def test_real_tile_error_rides_the_ladder_as_its_own_kind(tmp_path):
    """A tile that raises (not an injected failure) is recorded with kind
    "error", so a report shows real faults apart from injected ones."""
    _, tep = lorenz(4)
    sup = telastic.ElasticSupervisor(tep, "tsit5", ckpt_dir=str(tmp_path),
                                     n_shards=1, max_failures=0, **ODE_KW,
                                     **CPU)

    def boom(*a, **k):
        raise RuntimeError("launch failed")
    sup.engine.step_segment = boom
    res = sup.run()
    assert [f["kind"] for f in res.report["failures"]] == ["error"]
    assert res.report["bailed"]


# ---------------------------------------------------------------------------
# SIGKILL a real process mid-run, resume in a new one, diff bitwise
# ---------------------------------------------------------------------------

ELASTIC_SCRIPT = r"""
import sys
import numpy as np, torch
from repro_torch.configs.de_problems import gbm_problem, lorenz_problem
from repro_torch.convert import ensemble_problem
from repro_torch.core import solve_ensemble_local
from repro_torch.dist.chaos import ChaosMonkey
from repro_torch.dist.elastic import ElasticSupervisor

phase, case, ckpt_dir = sys.argv[1], sys.argv[2], sys.argv[3]
rng = np.random.default_rng(0)
if case == "ode":
    u0s = np.array([1.0, 0.0, 0.0]) + 0.1 * rng.random((12, 3))
    ps = np.stack([np.full(12, 10.0), 21.0 * rng.random(12),
                   np.full(12, 8.0 / 3.0)], 1)
    ep = ensemble_problem(lorenz_problem(torch.float64), u0s, ps)
    alg = "tsit5"
    kw = dict(tile_width=4, segment_steps=32, t0=0.0, tf=2.0, dt0=1e-2,
              rtol=1e-6, atol=1e-6, backoff_base=0.0, device="cpu")
    ref_kw = dict(alg=alg, ensemble="kernel", backend="torch", t0=0.0,
                  tf=2.0, dt0=1e-2, rtol=1e-6, atol=1e-6, lane_tile=4,
                  device="cpu")
else:
    ep = ensemble_problem(gbm_problem(r=1.5, v=0.2, dtype=torch.float64),
                          0.1 + 0.01 * rng.random((12, 3)),
                          np.array([1.5, 0.2]) + 0.01 * rng.random((12, 2)))
    alg = "em"
    kw = dict(tile_width=4, segment_steps=64, t0=0.0, tf=1.0, dt0=1.0 / 256,
              n_steps=256, seed=7, backoff_base=0.0, device="cpu")
    ref_kw = dict(alg=alg, ensemble="kernel", backend="torch", t0=0.0,
                  tf=1.0, dt0=1.0 / 256, n_steps=256, seed=7, lane_tile=4,
                  device="cpu")

if phase == "kill":
    # epoch 1 commits + snapshots, then shard 0's first tile of epoch 2
    # SIGKILLs the whole process — an uncatchable hard kill
    chaos = ChaosMonkey(schedule=[(2, 0, "sigkill")])
    ElasticSupervisor(ep, alg, ckpt_dir=ckpt_dir, n_shards=3, chaos=chaos,
                      **kw).run()
    print("UNREACHABLE")
else:
    res = ElasticSupervisor(ep, alg, ckpt_dir=ckpt_dir, n_shards=2,
                            **kw).run(resume=True)
    assert res.report["resumed_from_epoch"] >= 1, res.report
    ref = solve_ensemble_local(ep, **ref_kw)
    for k in ("u_final", "t_final", "naccept", "nreject"):
        assert np.array_equal(getattr(res, k),
                              getattr(ref, k).numpy()), k
    assert (res.status == 0).all()
    print("ELASTIC-RESUME-OK")
"""


def _run_phase(phase, case, ckpt_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-c", ELASTIC_SCRIPT, phase, case, ckpt_dir],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


@pytest.mark.parametrize("case", ["ode", "sde"])
def test_sigkill_resume_bitwise_subprocess(case, tmp_path):
    """A 3-shard run is SIGKILLed (signal 9, no cleanup) mid-epoch; a NEW
    process resumes the snapshot on disk onto 2 shards and finishes; the
    stitched trajectories equal one uninterrupted local solve bitwise."""
    ckpt = str(tmp_path / "ck")
    kill = _run_phase("kill", case, ckpt)
    assert kill.returncode == -9, (kill.returncode, kill.stdout,
                                   kill.stderr[-2000:])
    assert "UNREACHABLE" not in kill.stdout
    assert os.path.isdir(ckpt), "SIGKILL landed before the first snapshot"
    resume = _run_phase("resume", case, ckpt)
    assert resume.returncode == 0, resume.stderr[-4000:]
    assert "ELASTIC-RESUME-OK" in resume.stdout
