"""The sharded solve (`repro_torch.core.api`, paper §6.3) over one spawned
2-process gloo group on the CPU, every case held against the local solve
(the counterparts of tests/test_api_distributed.py,
tests/test_adaptive_sde.py:284-320, tests/test_texture_data.py:193 and
tests/test_autotune.py:177):

- lorenz-kernel: K1 (``backend="cuda"``, its plain version here), fixed
  dt and adaptive, bitwise;
- gbm-em-fixed and gbm-em-adaptive: K4's counter stream and K5's embedded
  pair, bitwise, the two ranks' trajectories distinct (disjoint streams);
- osc-data: the forced oscillator's table, bitwise;
- auto: ``ensemble="auto"`` tuned on rank 0 alone, one decision on both
  ranks, the result bitwise the explicit solve with it, block by block
  (the array strategy's lock-step dt is each block's own) and, for a
  per-trajectory strategy, whole;
- moments: `ensemble_moments` within the reference's bars (1e-12 mean,
  1e-9 variance), and the centered form on an f32 GBM at large drift;
- adjoint: dL/du0s and dL/d(table values) through the sharded adjoint
  within 1e-12 of the local solve's;
- divisibility: N not divisible by the world size refuses.

Without a group: ``launch/solve.py --work-queue`` (tiles leased from the
`WorkQueue`) gives the plain run's trajectories, and
`solve_ensemble_elastic` (formerly a refusal) equals the local solve
(tests/test_torch_elastic.py holds it in full).

Both ranks run the cases in order in one group (`WORKER`) and write each
case's outcome to a file as it ends; each test waits for its case with a
timeout of its own."""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

WORKER = r'''
import json, os, sys, time, traceback
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch.mesh import make_local_group
from repro_torch.configs import de_problems as dp
from repro_torch.core import autotune as at
from repro_torch.core.api import ensemble_moments, solve_ensemble
from repro_torch.core.ensemble import solve_ensemble_local
from repro_torch.core.interp import UniformTable1D
from repro_torch.core.methods import BACKENDS, STRATEGIES, get_method
from repro_torch.core.problem import EnsembleProblem

out = open(sys.argv[1], "a")
g = make_local_group("gloo")
rank, world = dist.get_rank(), dist.get_world_size()
F64 = torch.float64
CPU = dict(device="cpu")
FIELDS = ("us", "u_final", "t_final", "naccept", "nreject", "nf", "status",
          "njac", "nfact")


def same(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k


def block(x, n):
    lo = rank * (n // world)
    return x[lo:lo + n // world]


def lorenz_kernel():
    ep = dp.lorenz_ensemble(64, dtype=F64)
    for kw in (dict(adaptive=False, dt0=1e-3, save_every=1000),
               dict(adaptive=True, dt0=1e-3, rtol=1e-8, atol=1e-8,
                    saveat=[0.25, 0.5, 1.0])):
        kw = dict(kw, alg="tsit5", ensemble="kernel", backend="cuda",
                  t0=0.0, tf=1.0, **CPU)
        same(solve_ensemble(ep, g, **kw), solve_ensemble_local(ep, **kw))


def _gbm(kw):
    ens = EnsembleProblem(dp.gbm_problem(r=1.5, v=0.2, dtype=F64), 10)
    kw = dict(kw, alg="em", t0=0.0, tf=1.0, seed=3, ensemble="kernel",
              backend="cuda", **CPU)
    r2 = solve_ensemble(ens, g, **kw)
    same(r2, solve_ensemble_local(ens, **kw))
    assert not torch.equal(r2.u_final[:5], r2.u_final[5:])


def gbm_em_fixed():
    _gbm(dict(dt0=0.025, save_every=40))


def gbm_em_adaptive():
    _gbm(dict(dt0=0.05, adaptive=True, rtol=1e-3, atol=1e-5,
              error_est="embedded"))


def osc(N=8, requires_grad=False):
    prob = dp.forced_oscillator_problem(dtype=F64)
    if requires_grad:
        tab = prob.data["force"]
        prob = prob.__class__(**{**prob.__dict__, "data": {
            "force": UniformTable1D(tab.values.clone().requires_grad_(),
                                    tab.x0, tab.dx)}})
    u0s = torch.stack([prob.u0] * N) * torch.linspace(
        0.5, 1.5, N, dtype=F64)[:, None]
    ps = torch.stack([prob.p] * N)
    return prob, u0s, ps


def osc_data():
    prob, u0s, ps = osc()
    ep = EnsembleProblem(prob, 8, u0s=u0s, ps=ps)
    kw = dict(alg="tsit5", saveat=torch.linspace(0.0, 5.0, 6, dtype=F64),
              dt0=1e-2, rtol=1e-7, atol=1e-7, ensemble="kernel",
              backend="cuda", **CPU)
    same(solve_ensemble(ep, g, **kw), solve_ensemble_local(ep, **kw))


def auto():
    calls = {"n": 0}
    real = at.measure

    def counting(fn, *a, **k):
        calls["n"] += 1
        return real(fn, *a, **k)

    at.measure = counting
    ep = dp.lorenz_ensemble(32, dtype=F64)
    kw = dict(t0=0.0, tf=0.5, dt0=1e-2, rtol=1e-5, atol=1e-5, **CPU)
    r = solve_ensemble(ep, g, ensemble="auto", **kw)
    at.measure = real
    assert (calls["n"] > 1) == (rank == 0), calls     # rank 0 alone tunes
    u0s, ps = ep.materialize()
    sub = EnsembleProblem(ep.prob, 16, u0s=u0s[:16], ps=ps[:16])
    mine = (at.resolve_auto(sub, get_method("tsit5"), **kw) if rank == 0
            else at.Decision("vmap", "torch", None, source="placeholder"))
    assert rank != 0 or mine.source == "cache"   # the solve above tuned
    dec = at.broadcast_decision(mine, g)
    choice = torch.tensor([STRATEGIES.index(dec.strategy),
                           BACKENDS.index(dec.backend),
                           -1 if dec.lane_tile is None else dec.lane_tile])
    both = [torch.zeros_like(choice) for _ in range(world)]
    dist.all_gather(both, choice)
    assert torch.equal(both[0], both[1])        # one decision on both
    # each rank solves its block with the decision: block by block the
    # local solve (the array strategy's lock-step dt is a block's own)
    blocks = [solve_ensemble_local(
        EnsembleProblem(ep.prob, 16, u0s=u0s[lo:lo + 16], ps=ps[lo:lo + 16]),
        ensemble=dec.strategy, backend=dec.backend, lane_tile=dec.lane_tile,
        **kw) for lo in (0, 16)]
    for k in ("us", "u_final", "t_final"):
        assert torch.equal(getattr(r, k), torch.cat(
            [getattr(b, k) for b in blocks])), k
    if dec.strategy != "array":
        same(r, solve_ensemble_local(ep, ensemble=dec.strategy,
                                     backend=dec.backend,
                                     lane_tile=dec.lane_tile, **kw))


def moments():
    us = torch.arange(32.0, dtype=F64).reshape(32, 1)
    m1, v1 = ensemble_moments(block(us, 32), g)
    m0, v0 = ensemble_moments(us)
    torch.testing.assert_close(m1, m0, rtol=1e-12, atol=0)
    torch.testing.assert_close(v1, v0, rtol=1e-9, atol=0)
    # the centered form on an f32 GBM at large drift (mean/std > 300)
    N = 512
    prob = dp.gbm_problem(r=6.7, v=0.001, dtype=torch.float32)
    ep = EnsembleProblem(prob, N, u0s=torch.ones((N, 3)),
                         ps=torch.tensor([6.7, 0.001]).expand(N, 2))
    res = solve_ensemble(ep, g, alg="em", ensemble="kernel",
                         backend="cuda", t0=0.0, tf=1.0, dt0=1e-2,
                         n_steps=100, save_every=100, seed=11, **CPU)
    ref_mean = res.u_final.double().mean(dim=0)
    ref_var = res.u_final.double().var(dim=0, unbiased=False)
    assert float(ref_mean[0] / ref_var[0].sqrt()) > 300.0
    mean, var = ensemble_moments(block(res.u_final, N), g)
    assert bool((var >= 0).all())
    torch.testing.assert_close(mean.double(), ref_mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(var.double(), ref_var, rtol=5e-2, atol=0)


def adjoint():
    grads = {}
    for sharded in (False, True):
        prob, u0s, ps = osc(requires_grad=True)
        u0s = u0s.clone().requires_grad_()
        ep = EnsembleProblem(prob, 8, u0s=u0s, ps=ps)
        kw = dict(alg="tsit5", adaptive=False, dt0=0.01,
                  saveat=torch.linspace(1.0, 5.0, 5, dtype=F64),
                  ensemble="kernel", backend="cuda", sensitivity="adjoint",
                  adjoint_steps=520, **CPU)
        r = (solve_ensemble(ep, g, **kw) if sharded
             else solve_ensemble_local(ep, **kw))
        loss = (r.u_final ** 2).sum() + (r.us ** 2).sum()
        loss.backward()
        grads[sharded] = (u0s.grad, prob.data["force"].values.grad)
    (gu, gt), (su, st) = grads[False], grads[True]
    mine = block(su, 8)
    assert float((mine - block(gu, 8)).abs().max()) <= \
        1e-12 * float(gu.abs().max())
    assert float((st - gt).abs().max()) <= 1e-12 * float(gt.abs().max())
    # the other rank's block gets nothing here: it is that rank's
    assert float(su.abs().sum() - mine.abs().sum()) == 0.0


def divisibility():
    ep = dp.lorenz_ensemble(7, dtype=F64)
    try:
        solve_ensemble(ep, g, adaptive=False, dt0=1e-2, **CPU)
    except AssertionError as e:
        assert "must divide" in str(e)
    else:
        raise AssertionError("N = 7 over 2 ranks did not refuse")


for fn in (lorenz_kernel, gbm_em_fixed, gbm_em_adaptive, osc_data, auto,
           moments, adjoint, divisibility):
    tic = time.perf_counter()
    try:
        fn()
        got = "ok"
    except Exception:
        got = traceback.format_exc()
    out.write(json.dumps({"case": fn.__name__, "result": got,
                          "s": time.perf_counter() - tic}) + "\n")
    out.flush()
dist.destroy_process_group()
'''

CASES = {"lorenz_kernel": 60, "gbm_em_fixed": 30, "gbm_em_adaptive": 60,
         "osc_data": 30, "auto": 60, "moments": 30, "adjoint": 120,
         "divisibility": 30}
# the group's start (two interpreters importing torch) before the first case
START_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    d = tmp_path_factory.mktemp("group")
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
           "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "REPRO_AUTOTUNE_CACHE": str(d / "autotune.json"),
           "REPRO_AUTOTUNE_REPEATS": "1"}
    procs = []
    for r in (0, 1):
        with open(d / f"rank{r}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(d / f"rank{r}.jsonl")],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stderr=err,
                stdout=subprocess.DEVNULL))
    state = {"dir": d, "procs": procs, "since": time.monotonic() + START_S}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _outcome(d: Path, r: int, case: str):
    path = d / f"rank{r}.jsonl"
    if not path.exists():
        return None
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if rec["case"] == case:
            return rec
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_local(group, case):
    d, procs = group["dir"], group["procs"]
    deadline = max(time.monotonic(), group["since"]) + CASES[case]
    got = {}
    while len(got) < 2:
        for r in (0, 1):
            if r not in got:
                rec = _outcome(d, r, case)
                if rec is not None:
                    got[r] = rec
                elif procs[r].poll() is not None:
                    pytest.fail(f"rank {r} exited ({procs[r].returncode}) "
                                f"before {case}: "
                                + (d / f"rank{r}.err").read_text()[-3000:])
        if len(got) < 2:
            if time.monotonic() > deadline:
                pytest.fail(f"{case}: no outcome within {CASES[case]} s")
            time.sleep(0.05)
    group["since"] = time.monotonic()
    for r in (0, 1):
        assert got[r]["result"] == "ok", f"rank {r}:\n{got[r]['result']}"


@pytest.mark.parametrize("adaptive", [False, True])
def test_work_queue_launcher_equals_the_plain_run(capsys, adaptive):
    """``--work-queue`` over-decomposes into tiles of 8 x --lane-tile
    leased from the WorkQueue: every tile's trajectories are the plain
    run's, so the printed mean |u_f| is the same."""
    from repro_torch.launch import solve as launcher
    argv = ["--n", "64", "--lane-tile", "4", "--dt", "1e-2",
            "--device", "cpu"] + (["--adaptive"] if adaptive else [])
    means = []
    for extra in ([], ["--work-queue"]):
        launcher.main(argv + extra)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        means.append(line.split("mean |u_f| = ")[1])
    assert means[0] == means[1]


def test_solve_ensemble_elastic_runs(tmp_path):
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.api import solve_ensemble_elastic
    from repro_torch.core.ensemble import solve_ensemble_local
    ep = dp.lorenz_ensemble(8, dtype=torch.float64)
    kw = dict(t0=0.0, tf=0.5, dt0=1e-2, rtol=1e-6, atol=1e-6)
    res = solve_ensemble_elastic(ep, "tsit5", ckpt_dir=str(tmp_path),
                                 tile_width=4, device="cpu", **kw)
    ref = solve_ensemble_local(ep, alg="tsit5", lane_tile=4, device="cpu",
                               **kw)
    assert res.report["mode"] == "segment"
    assert np.array_equal(res.u_final, ref.u_final.numpy())
