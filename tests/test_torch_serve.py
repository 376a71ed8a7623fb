"""The continuous-batching service (`repro_torch.serve`) against the
reference's (`repro.serve`): the same requests, made from a numpy seed, go
through both services in the same order, in float64, on the CPU.

Bars (ROADMAP): adaptive erk results have per-lane naccept/nreject equal
and states within 1e-10; the counter-stream SDE within 3e-7 (the float32
normals of XLA and PyTorch differ by a few ulps; the Threefry words are
equal: tests/test_torch_resumable.py); the stiff batch at the ROBER bar
(rtol 1e-6).  The bouncing ball is held to the reference run op by op
(`jax.disable_jit`): compiled, XLA's fused multiply-adds move each located
bounce by up to one bisection quantum (ROADMAP queue 3).

Inside the port, bitwise: a request served in RECYCLED slots (admitted
while others are in flight, at its service-assigned lane_offset) equals a
fresh `solve_ensemble_local(..., ensemble="kernel", backend="torch")` of
the same request, and a `BatchPool` request equals its own fresh solve on
its backend.  Then the service's behaviour, case for case with
tests/test_serve.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import de_problems as jdp
from repro.core import EnsembleProblem as JEnsembleProblem
from repro.core.events import Event as JEvent
from repro.core.methods import list_methods as jlist_methods
from repro_torch import serve as tserve
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem
from repro_torch.core import EnsembleProblem, solve_ensemble_local
from repro_torch.core.methods import get_method, list_methods
from repro_torch.core.problem import ODEProblem

F64 = torch.float64
ADAPTIVE_TOL = 1e-10
RNG_TOL = 3e-7
CPU = dict(device="cpu")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def lorenz_arrays(N, seed=0):
    rng = np.random.default_rng(seed)
    u0s = np.array([1.0, 0.0, 0.0]) + 0.1 * rng.random((N, 3))
    ps = np.stack([np.full(N, 10.0), 21.0 * rng.random(N),
                   np.full(N, 8.0 / 3.0)], 1)
    return u0s, ps


def both(jprob, tprob, u0s, ps):
    return (JEnsembleProblem(jprob, len(u0s), u0s=jnp.asarray(u0s),
                             ps=jnp.asarray(ps)),
            ensemble_problem(tprob, u0s, ps))


def serve_both(requests, *, pump_until_first=True, **svc_kw):
    """Submit `requests` [(jep, tep, submit kwargs)] to a reference and a
    port service in the same order: the first two, pumps until the first
    is done, then the rest, then drain.  Returns the two ticket lists."""
    out = []
    for mod, pick, extra in ((jserve, 0, {}), (tserve, 1, CPU)):
        svc = mod.EnsembleService(**svc_kw, **extra)
        tickets = [svc.submit(r[pick], **r[2]) for r in requests[:2]]
        while pump_until_first and not tickets[0].done:
            svc.pump()
        tickets += [svc.submit(r[pick], **r[2]) for r in requests[2:]]
        svc.drain()
        out.append(tickets)
    return out


def assert_counts_equal(got, want):
    np.testing.assert_array_equal(got.naccept, np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject, np.asarray(want.nreject))
    assert got.status == want.status and got.nf == want.nf


def fresh_erk(tep, tf, **kw):
    return solve_ensemble_local(tep, alg="tsit5", ensemble="kernel",
                                backend="torch", t0=0.0, tf=tf, **kw, **CPU)


def assert_bitwise(result, ref):
    np.testing.assert_array_equal(result.u_final, ref.u_final.numpy())
    np.testing.assert_array_equal(result.t_final, ref.t_final.numpy())
    np.testing.assert_array_equal(result.naccept, ref.naccept.numpy())
    assert result.nf == int(ref.nf)


# ---------------------------------------------------------------------------
# the same requests through both services
# ---------------------------------------------------------------------------

def test_lorenz_tsit5_adaptive_recycled_matches_reference():
    """A (short) retires early; C refills A's slots while B (long) is
    mid-flight.  Each result: counts equal to the reference's, states
    within 1e-10, and bitwise the port's fresh solve."""
    u0s, ps = lorenz_arrays(12)
    jp, tp = jdp.lorenz_problem(jnp.float64), tdp.lorenz_problem(F64)
    tfs = (0.5, 2.0, 1.5)
    kw = dict(rtol=1e-8, atol=1e-8, dt0=1e-2)
    reqs = [both(jp, tp, u0s[4 * i:4 * i + 4], ps[4 * i:4 * i + 4])
            + (dict(alg="tsit5", tf=tf, **kw),) for i, tf in enumerate(tfs)]
    jt, tt = serve_both(reqs, slot_width=8, segment_steps=20)
    for j, t, r, tf in zip(jt, tt, reqs, tfs):
        assert t._req.lane_offset == j._req.lane_offset
        assert_counts_equal(t.result, j.result)
        assert rel(t.result.u_final, j.result.u_final) <= ADAPTIVE_TOL
        assert rel(t.result.t_final, j.result.t_final) <= ADAPTIVE_TOL
        assert_bitwise(t.result, fresh_erk(r[1], tf, **kw))


def test_ball_event_matches_reference_op_by_op():
    """The bouncing ball's non-terminal event on tsit5 through the slot
    pool: located bounces, counts and states as the reference's run op by
    op; the port's result is bitwise its fresh solve."""
    N = 8
    es = np.linspace(0.3, 0.9, N)
    u0s = np.stack([np.full(N, 10.0), np.zeros(N)], 1)
    ps = np.stack([np.full(N, 9.8), es], 1)
    jp, tp = jdp.bouncing_ball_problem(), tdp.bouncing_ball_problem()
    jev, tev = jdp.bouncing_ball_event(), tdp.bouncing_ball_event()
    kw = dict(alg="tsit5", t0=0.0, dt0=1e-3, rtol=1e-8, atol=1e-8)
    halves = [both(jp, tp, u0s[:4], ps[:4]), both(jp, tp, u0s[4:], ps[4:])]
    out = []
    for mod, pick, ev, extra in ((jserve, 0, jev, {}), (tserve, 1, tev, CPU)):
        svc = mod.EnsembleService(slot_width=4, segment_steps=16, **extra)
        ta = svc.submit(halves[0][pick], tf=1.6, event=ev, **kw)
        with jax.disable_jit():
            while not ta.done:
                svc.pump()
            tb = svc.submit(halves[1][pick], tf=2.0, event=ev, **kw)
            svc.drain()
        out.append((ta, tb))
    for j, t, tf, half in zip(out[0], out[1], (1.6, 2.0), halves):
        assert_counts_equal(t.result, j.result)
        np.testing.assert_array_equal(t.result.event_count,
                                      j.result.event_count)
        assert (t.result.event_count >= 1).all()
        np.testing.assert_allclose(t.result.event_t, j.result.event_t,
                                   rtol=ADAPTIVE_TOL, atol=0)
        np.testing.assert_allclose(t.result.u_final, j.result.u_final,
                                   rtol=0, atol=ADAPTIVE_TOL)
        ref = solve_ensemble_local(half[1], ensemble="kernel",
                                   backend="torch", tf=tf, event=tev, **kw,
                                   **CPU)
        np.testing.assert_array_equal(t.result.u_final, ref.u_final.numpy())
        np.testing.assert_array_equal(t.result.naccept, ref.naccept.numpy())


def gbm_requests(N=4, seed=2):
    rng = np.random.default_rng(seed)
    jp = jdp.gbm_problem(r=1.5, v=0.2, dtype=jnp.float64)
    tp = tdp.gbm_problem(r=1.5, v=0.2, dtype=F64)
    return [both(jp, tp, 0.1 + 0.01 * rng.random((N, 3)),
                 np.array([1.5, 0.2]) + 0.01 * rng.random((N, 2)))
            for _ in range(3)]


def test_gbm_em_barrier_recycled_matches_reference():
    """GBM em at fixed dt with the terminal up-and-out barrier at 0.18:
    recycled slots keep their request's stream (lane_offset), paths within
    3e-7 of the reference's, located hits within 3e-7, and bitwise the
    port's fresh solve at the assigned lane_offset."""
    subs = gbm_requests()
    # the reference's barrier (tests/test_event_parity.py:99)
    jev = JEvent(condition=lambda u, p, t: u[0] - 0.18, terminal=True,
                 direction=1)
    tev = tdp.gbm_barrier_event()
    steps = (32, 96, 64)
    out = []
    for mod, pick, ev, extra in ((jserve, 0, jev, {}), (tserve, 1, tev, CPU)):
        svc = mod.EnsembleService(seed=13, slot_width=8, segment_steps=16,
                                  **extra)
        kw = lambda n: dict(alg="em", t0=0.0, tf=n * 1e-2, dt0=1e-2,
                            n_steps=n, event=ev)
        tk = [svc.submit(s[pick], **kw(n))
              for s, n in zip(subs[:2], steps[:2])]
        while not tk[0].done:
            svc.pump()
        tk.append(svc.submit(subs[2][pick], **kw(steps[2])))
        svc.drain()
        out.append(tk)
    hits = 0
    for j, t, s, n in zip(out[0], out[1], subs, steps):
        assert t._req.lane_offset == j._req.lane_offset
        np.testing.assert_array_equal(t.result.naccept, j.result.naccept)
        np.testing.assert_array_equal(t.result.event_count,
                                      j.result.event_count)
        assert rel(t.result.u_final, j.result.u_final) <= RNG_TOL
        assert rel(t.result.t_final, j.result.t_final) <= RNG_TOL
        hits += int(t.result.event_count.sum())
        ref = solve_ensemble_local(
            s[1], alg="em", ensemble="kernel", backend="torch", t0=0.0,
            tf=n * 1e-2, dt0=1e-2, n_steps=n, save_every=n, seed=13,
            lane_offset=t._req.lane_offset, event=tev, **CPU)
        np.testing.assert_array_equal(t.result.u_final, ref.u_final.numpy())
        np.testing.assert_array_equal(t.result.t_final, ref.t_final.numpy())
        np.testing.assert_array_equal(t.result.naccept, ref.naccept.numpy())
        # served nf counts the steps a lane was active (a frozen lane stops
        # counting); the fresh solve's is the nominal n_steps a lane, in
        # both packages
        assert t.result.nf == int(t.result.naccept.sum()) == j.result.nf
    assert hits > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_rober_rodas5p_batch_matches_reference(backend):
    """ROBER rodas5p through `BatchPool`: two requests of one signature
    coalesce into one solve; each at the ROBER bar of the reference's
    batch, counts equal, and bitwise the port's own fresh solve of the
    coalesced batch on the same backend (the stiff kernel's plain version
    on CPU tensors for "cuda")."""
    N = 4
    rng = np.random.default_rng(4)
    k1 = np.exp(np.log(0.01) + (np.log(0.1) - np.log(0.01)) * rng.random(2 * N))
    u0s = np.tile([1.0, 0.0, 0.0], (2 * N, 1))
    ps = np.stack([k1, np.full(2 * N, 3e7), np.full(2 * N, 1e4)], 1)
    jp, tp = jdp.rober_problem(), tdp.rober_problem()
    halves = [both(jp, tp, u0s[:N], ps[:N]), both(jp, tp, u0s[N:], ps[N:])]
    kw = dict(alg="rodas5p", t0=0.0, tf=1.0, dt0=1e-6, rtol=1e-6, atol=1e-8)
    out = []
    for mod, pick, extra in ((jserve, 0, {}), (tserve, 1, dict(
            backend=backend))):
        svc = mod.EnsembleService(**({} if mod is jserve else CPU))
        tk = [svc.submit(h[pick], tenant=f"t{i}", **kw, **extra)
              for i, h in enumerate(halves)]
        svc.drain()
        assert not any(k[0] == "batch" for k in svc._pools)
        out.append((svc, tk))
    (jsvc, jt), (tsvc, tt) = out
    whole = solve_ensemble_local(ensemble_problem(tp, u0s, ps),
                                 ensemble="kernel", backend=backend, **kw,
                                 **CPU)
    for i, (j, t) in enumerate(zip(jt, tt)):
        np.testing.assert_array_equal(t.result.naccept, j.result.naccept)
        np.testing.assert_allclose(t.result.u_final, j.result.u_final,
                                   rtol=1e-6, atol=1e-14)
        np.testing.assert_array_equal(
            t.result.u_final, whole.u_final[i * N:(i + 1) * N].numpy())
        assert t.result.status == 0
    for k in ("njac", "nfact"):
        assert sum(tsvc.accounting[f"t{i}"][k] for i in (0, 1)) == \
            pytest.approx(int(whole.__getattribute__(k)), abs=1)


def test_gbm_em_adaptive_batch_matches_reference():
    """Adaptive GBM em (its embedded pair) through `BatchPool`, one batch a
    request (keyed on lane_offset): counts equal to the reference's, paths
    within 3e-7, and bitwise the port's fresh solve at the assigned
    lane_offset on the adaptive kernel's plain version."""
    subs = gbm_requests(seed=6)[:2]
    kw = dict(alg="em", t0=0.0, tf=1.0, dt0=0.05, adaptive=True, rtol=1e-3,
              atol=1e-5)
    out = []
    for mod, pick, extra in ((jserve, 0, {}), (tserve, 1, dict(
            backend="cuda"))):
        svc = mod.EnsembleService(seed=7, **({} if mod is jserve else CPU))
        tk = [svc.submit(s[pick], **kw, **extra) for s in subs]
        svc.drain()
        out.append(tk)
    for j, t, s in zip(out[0], out[1], subs):
        assert t._req.lane_offset == j._req.lane_offset
        np.testing.assert_array_equal(t.result.naccept, j.result.naccept)
        np.testing.assert_array_equal(t.result.nreject, j.result.nreject)
        assert rel(t.result.u_final, j.result.u_final) <= RNG_TOL
        ref = solve_ensemble_local(s[1], ensemble="kernel", backend="cuda",
                                   seed=7, lane_offset=t._req.lane_offset,
                                   **kw, **CPU)
        np.testing.assert_array_equal(t.result.u_final, ref.u_final.numpy())


# ---------------------------------------------------------------------------
# service behaviour (tests/test_serve.py, case for case)
# ---------------------------------------------------------------------------

def lorenz_subs():
    u0s, ps = lorenz_arrays(12, seed=5)
    prob = tdp.lorenz_problem(F64)
    return [ensemble_problem(prob, u0s[4 * i:4 * i + 4], ps[4 * i:4 * i + 4])
            for i in range(3)]


def test_heterogeneous_requests_share_one_pool():
    subs = lorenz_subs()
    svc = tserve.EnsembleService(slot_width=8, segment_steps=32, **CPU)
    tkts = [svc.submit(s, alg="tsit5", tf=tf, dt0=1e-2)
            for s, tf in zip(subs, (0.4, 0.9, 1.3))]
    svc.drain()
    assert all(t.done for t in tkts)
    assert len(svc._pools) == 1          # one coalesce key
    for t, s, tf in zip(tkts, subs, (0.4, 0.9, 1.3)):
        assert_bitwise(t.result, fresh_erk(s, tf, dt0=1e-2))


def test_per_tenant_accounting():
    subs = lorenz_subs()
    svc = tserve.EnsembleService(slot_width=8, **CPU)
    ta = svc.submit(subs[0], alg="tsit5", tf=0.5, tenant="alice")
    tb = svc.submit(subs[1], alg="tsit5", tf=0.5, tenant="bob")
    tc = svc.submit(subs[2], alg="tsit5", tf=0.5, tenant="alice")
    svc.drain()
    acct = svc.accounting
    assert acct["alice"]["requests"] == 2 and acct["bob"]["requests"] == 1
    assert acct["alice"]["lanes"] == 8 and acct["bob"]["lanes"] == 4
    assert acct["alice"]["nf"] == ta.result.nf + tc.result.nf
    assert acct["bob"]["nf"] == tb.result.nf
    assert acct["alice"]["failures"] == acct["bob"]["failures"] == 0


def test_backpressure_and_release():
    subs = lorenz_subs()
    svc = tserve.EnsembleService(slot_width=8, max_pending=2, **CPU)
    svc.submit(subs[0], alg="tsit5", tf=0.3)
    svc.submit(subs[1], alg="tsit5", tf=0.3)
    with pytest.raises(tserve.Backpressure):
        svc.submit(subs[2], alg="tsit5", tf=0.3)
    svc.drain()
    t3 = svc.submit(subs[2], alg="tsit5", tf=0.3)   # capacity freed
    svc.drain()
    assert t3.done and t3.result.status == 0


def test_attempt_budget_evicts_lane_and_fillers_retire_it():
    """A lane past its request's attempt budget is force-retired with
    status 1 and its slot is reused; evicted columns with no refill get a
    one-iteration filler, so every carry column ends done."""
    subs = lorenz_subs()
    svc = tserve.EnsembleService(slot_width=8, segment_steps=16, **CPU)
    big = EnsembleProblem(subs[0].prob, 8,
                          u0s=torch.cat([subs[0].u0s, subs[1].u0s]),
                          ps=torch.cat([subs[0].ps, subs[1].ps]))
    t1 = svc.submit(big, alg="tsit5", tf=50.0, dt0=1e-2, max_iters=40)
    svc.drain()
    assert t1.done and t1.result.status == 1
    t2 = svc.submit(subs[2], alg="tsit5", tf=0.5, dt0=1e-2)
    svc.drain()
    assert_bitwise(t2.result, fresh_erk(subs[2], 0.5, dt0=1e-2))
    pool = next(iter(svc._pools.values()))
    assert bool(pool.carry["done"].all()) and not pool._scrub.any()


def test_batch_pool_coalesces_and_passes_backend(monkeypatch):
    """Same full signature -> one solve of both requests on the request's
    backend; the one-shot pool is dropped after its solve; njac is
    attributed, not duplicated."""
    from repro_torch.serve import slots as slots_mod
    rp = tdp.rober_problem()
    u0 = np.tile([1.0, 0.0, 0.0], (4, 1))
    p = np.tile([0.04, 3e7, 1e4], (4, 1))
    svc = tserve.EnsembleService(**CPU)
    kw = dict(alg="rosenbrock23", t0=0.0, tf=1.0, dt0=1e-6, rtol=1e-5,
              atol=1e-8, backend="cuda")
    calls = []
    orig = slots_mod.solve_ensemble_local
    monkeypatch.setattr(
        slots_mod, "solve_ensemble_local",
        lambda ep, **k: (calls.append((ep.n_trajectories, k["backend"],
                                       str(k["device"]))),
                         orig(ep, **k))[1])
    ta = svc.submit(ensemble_problem(rp, u0, p), tenant="a", **kw)
    tb = svc.submit(ensemble_problem(rp, u0, p), tenant="b", **kw)
    svc.drain()
    assert calls == [(8, "cuda", "cpu")]
    assert ta.done and tb.done and not svc._pools
    total = svc.accounting["a"]["njac"] + svc.accounting["b"]["njac"]
    ref = solve_ensemble_local(ensemble_problem(rp, np.tile(u0, (2, 1)),
                                                np.tile(p, (2, 1))),
                               ensemble="kernel", **kw, **CPU)
    assert abs(total - int(ref.njac)) <= 1
    tc = svc.submit(ensemble_problem(rp, u0, p), tenant="a",
                    **dict(kw, backend="torch"))
    svc.drain()
    assert calls[-1][1] == "torch" and tc.result.status == 0


def test_inflight_request_survives_lease_timeout():
    """A request whose solve outlasts queue_timeout is not re-admitted:
    exactly one completion, counted once, _pending back to 0."""
    subs = lorenz_subs()
    svc = tserve.EnsembleService(slot_width=8, segment_steps=8,
                                 queue_timeout=1e-9, **CPU)
    t1 = svc.submit(subs[0], alg="tsit5", tf=1.0, dt0=1e-2)
    svc.drain()
    assert t1.done and t1.result.status == 0
    assert svc.accounting["default"]["requests"] == 1
    assert svc.accounting["default"]["lanes"] == 4
    assert svc._pending == 0 and not svc._inflight
    assert_bitwise(t1.result, fresh_erk(subs[0], 1.0, dt0=1e-2))


def test_rejected_submit_does_not_consume_capacity():
    subs = lorenz_subs()
    svc = tserve.EnsembleService(slot_width=8, max_pending=2, **CPU)
    for _ in range(4):
        with pytest.raises(KeyError):
            svc.submit(subs[0], alg="no-such-method")
    assert svc._pending == 0
    ta = svc.submit(subs[0], alg="tsit5", tf=0.3)
    tb = svc.submit(subs[1], alg="tsit5", tf=0.3)
    svc.drain()
    assert ta.done and tb.done


def test_batch_pool_status_is_per_lane(monkeypatch):
    """One tenant's failing lane does not mark coalesced tenants failed."""
    from types import SimpleNamespace
    from repro_torch.serve import slots as slots_mod
    from repro_torch.serve.service import SolveRequest

    def fake_solve(ep, **kw):
        n = ep.n_trajectories
        return SimpleNamespace(
            u_final=np.zeros((n, 3)), t_final=np.ones(n),
            naccept=np.full(n, 10), nreject=np.zeros(n),
            nf=np.asarray(60), njac=np.asarray(20), nfact=np.asarray(20),
            status=np.asarray([0, 0, 2, 2]))   # only tenant b's lanes fail
    monkeypatch.setattr(slots_mod, "solve_ensemble_local", fake_solve)
    done = []
    pool = slots_mod.BatchPool(get_method("rosenbrock23"), None,
                               solve_kwargs={}, on_complete=done.append)

    def req(tenant):
        return SolveRequest(
            prob=None, alg="rosenbrock23", u0s=np.zeros((2, 3)),
            ps=np.zeros((2, 1)), t0=0.0, tf=1.0, dt0=1e-3, n_steps=None,
            adaptive=True, rtol=1e-6, atol=1e-6, max_iters=100,
            event=None, tenant=tenant, lane_offset=0, n_lanes=2)
    ra, rb = req("a"), req("b")
    pool.admit(ra)
    pool.admit(rb)
    assert pool.pump()
    assert [r.tenant for r in done] == ["a", "b"]
    assert ra.assemble().status == 0
    assert rb.assemble().status == 2


def test_background_thread_serving():
    subs = lorenz_subs()
    svc = tserve.EnsembleService(slot_width=8, segment_steps=32, **CPU)
    svc.start()
    try:
        tkts = [svc.submit(s, alg="tsit5", tf=0.5) for s in subs]
        for t in tkts:
            assert t.wait(timeout=120.0)
    finally:
        svc.stop()
    assert_bitwise(tkts[0].result, fresh_erk(subs[0], 0.5))
    assert all(t.latency is not None and t.latency >= 0 for t in tkts)


def test_resumable_flags_equal_the_reference_registry():
    want = {s.name: s.resumable for s in jlist_methods()}
    got = {s.name: s.resumable for s in list_methods()}
    assert got == want
    assert get_method("tsit5").resumable and get_method("em").resumable
    assert not get_method("rosenbrock23").resumable


def test_pump_failure_counter_and_last_error_per_tenant():
    """A request whose RHS raises must not take the service down: the
    failure is charged to its tenant, retried max_request_retries times,
    then failed permanently (ticket.error set, result None, capacity
    released) while another tenant's request completes bitwise."""
    def bad_rhs(u, p, t):
        raise RuntimeError("boom rhs")

    bad_prob = ODEProblem(bad_rhs, torch.ones(1, dtype=F64),
                          torch.ones(1, dtype=F64), (0.0, 1.0))
    bad = EnsembleProblem(bad_prob, 4, ps=torch.ones(4, 1, dtype=F64))
    sa = lorenz_subs()[0]
    svc = tserve.EnsembleService(slot_width=4, segment_steps=16,
                                 max_request_retries=2, **CPU)
    tb = svc.submit(bad, alg="tsit5", tf=1.0, tenant="chaos")
    th = svc.submit(sa, alg="tsit5", tf=0.5, tenant="steady")
    svc.drain()
    assert tb.done and tb.result is None and "boom rhs" in tb.error
    chaos = svc.accounting["chaos"]
    assert chaos["failures"] == 3 and "boom rhs" in chaos["last_error"]
    assert chaos["requests"] == 0
    assert th.done and th.result.status == 0
    assert_bitwise(th.result, fresh_erk(sa, 0.5))
    steady = svc.accounting["steady"]
    assert steady["failures"] == 0 and steady["last_error"] is None
    assert svc._pending == 0 and svc._wq.finished


def test_service_defaults_to_the_card():
    """The service runs where every entry point of the port runs: without
    CUDA and without device='cpu' it refuses instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.EnsembleService()
