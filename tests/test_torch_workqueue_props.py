"""Property tests for the lease-token WorkQueue, run on the port's
(`repro_torch.dist.fault`) and the reference's (`repro.dist.fault`) alike,
plus a differential run of the two on the same seeded operation sequences.

The queue is the scheduler under `repro_torch.serve`: multiple pump threads
claim requests under lease, stragglers expire, and stale completions must
never retire an item a live worker re-claimed.  These tests drive
randomized claim/expire/complete interleavings (seeded — deterministic) and
check the invariants the serve layer depends on:

  I1  an item is retired by exactly ONE completion, and that completion's
      token is the item's latest issued lease generation at retire time;
  I2  a completion with a stale token is rejected and changes nothing;
  I3  no two live (unexpired) leases for the same item coexist;
  I4  the queue always drains: with workers that eventually complete,
      `finished` goes True and every item was retired exactly once;
  I5  expiry-reclaim backs off (jittered, capped), deterministically.
"""
import random
import threading
import time

import pytest

from repro.dist import chaos as jchaos
from repro.dist import fault as jfault
from repro_torch.dist import chaos as tchaos
from repro_torch.dist import fault as tfault

IMPLS = {"port": (tfault, tchaos), "reference": (jfault, jchaos)}
impl = pytest.mark.parametrize("fault,chaos", list(IMPLS.values()),
                               ids=list(IMPLS))


@impl
def test_random_interleavings_single_thread(fault, chaos):
    """Exhaustive-ish seeded fuzz of claim/expire/complete sequences."""
    for seed in range(40):
        rng = random.Random(seed)
        n = rng.randint(1, 6)
        # timeout 0: every lease is already expired
        q = fault.WorkQueue(n_items=n, tile=1, timeout=0.0)
        outstanding = []        # (idx, token) leases held by "workers"
        retired = {}            # idx -> token that retired it
        issued = {i: 0 for i in range(n)}   # latest generation per item

        for _ in range(200):
            op = rng.random()
            if op < 0.5:
                got = q.claim()
                if got is None:
                    assert q.finished
                    break
                idx, _, tok = got
                assert idx not in retired                      # I2 for claims
                assert tok == issued[idx] + 1, "generation must bump"
                issued[idx] = tok
                outstanding.append((idx, tok))
            elif outstanding:
                pick = rng.randrange(len(outstanding))
                idx, tok = outstanding.pop(pick)
                ok = q.complete(idx, tok)
                stale = tok != issued[idx] or idx in retired
                assert ok == (not stale)                       # I1 + I2
                if ok:
                    retired[idx] = tok

        # drain: complete everything via fresh claims
        while (got := q.claim()) is not None:
            idx, _, tok = got
            assert q.complete(idx, tok)
            retired[idx] = tok
        assert q.finished and len(retired) == n                # I4


@impl
def test_stale_straggler_cannot_retire_reclaimed_item(fault, chaos):
    q = fault.WorkQueue(n_items=1, tile=1, timeout=0.05)
    i1, _, t1 = q.claim()
    time.sleep(0.06)                 # lease expires
    i2, _, t2 = q.claim()            # live worker re-claims
    assert (i1, t2) == (i2, t1 + 1)
    assert not q.complete(i1, t1)    # straggler wakes up late: rejected
    assert not q.finished            # the live worker still owns it
    assert q.complete(i2, t2)
    assert q.finished


@impl
def test_live_lease_not_double_claimed(fault, chaos):
    q = fault.WorkQueue(n_items=2, tile=1, timeout=60.0)
    a = q.claim()
    b = q.claim()
    assert a[0] != b[0]              # I3: distinct items while leases live
    assert q.claim() is None


@impl
def test_renew_keeps_inflight_lease_alive(fault, chaos):
    """An actively-renewed lease never expires: a worker solving past the
    timeout keeps its item, and its original token still completes."""
    q = fault.WorkQueue(n_items=1, tile=1, timeout=0.05)
    idx, _, tok = q.claim()
    for _ in range(3):
        time.sleep(0.03)
        assert q.renew(idx, tok)
        assert q.claim() is None         # never re-leased while renewed
    assert q.complete(idx, tok)
    assert q.finished
    # stale/retired renews are rejected without side effects
    assert not q.renew(idx, tok)


@impl
def test_retired_prefix_is_compacted_and_payloads_released(fault, chaos):
    """Completed items are garbage-collected (payload freed, done prefix
    dropped) while indices stay valid and late stale calls are no-ops."""
    q = fault.WorkQueue(timeout=60.0)
    idxs = [q.push(f"req-{i}") for i in range(50)]
    assert idxs == list(range(50))
    leases = {}
    for _ in range(50):
        idx, payload, tok = q.claim()
        assert payload == f"req-{idx}"
        leases[idx] = tok
    for idx in idxs[:49]:
        assert q.complete(idx, leases[idx])
    q.claim()                            # triggers prefix compaction
    assert len(q._done) <= 2             # history dropped, not retained
    assert q.pending == 1 and not q.finished
    # retired-and-compacted indices reject late completes/releases/renews
    assert not q.complete(idxs[0], leases[idxs[0]])
    assert not q.release(idxs[0], leases[idxs[0]])
    assert not q.renew(idxs[0], leases[idxs[0]])
    # the survivor's global index still works, and new pushes stay global
    new_idx = q.push("req-50")
    assert new_idx == 50
    assert q.complete(idxs[-1], leases[idxs[-1]])
    i, p, t = q.claim()
    assert (i, p) == (50, "req-50")
    assert q.complete(i, t)
    assert q.finished and q.pending == 0


@impl
def test_threaded_workers_retire_each_item_exactly_once(fault, chaos):
    """8 threads hammer a 60-item queue with a tiny lease timeout (forced
    re-leases) and randomized delays; every item must end up retired exactly
    once and every completion outcome must be consistent with token
    freshness."""
    n = 60
    q = fault.WorkQueue(n_items=n, tile=1, timeout=0.002)
    accepted = [0] * n
    lock = threading.Lock()

    def worker(wid):
        rng = random.Random(wid)
        idle = 0
        while idle < 50:
            got = q.claim()
            if got is None:
                if q.finished:
                    return
                idle += 1
                time.sleep(0.001)
                continue
            idle = 0
            idx, _, tok = got
            if rng.random() < 0.3:
                time.sleep(0.004)    # straggle past the lease timeout
            if q.complete(idx, tok):
                with lock:
                    accepted[idx] += 1

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert q.finished
    assert accepted == [1] * n       # exactly-once retirement


# ---------------------------------------------------------------------------
# expiry-reclaim backoff (I5): dead-worker items must not thrash
# ---------------------------------------------------------------------------

def _clocked_queue(fault, **kw):
    """Queue on an injected manual clock — backoff schedules without sleep."""
    t = [0.0]
    q = fault.WorkQueue(clock=lambda: t[0], **kw)
    return q, t


@impl
def test_expiry_reclaim_backs_off_exponentially(fault, chaos):
    """I5: the FIRST expiry reclaims at the base timeout; every further
    expiry of the same item multiplies its effective lease timeout by
    backoff_factor, capped at backoff_max_mult x base."""
    q, t = _clocked_queue(fault, n_items=1, tile=1, timeout=1.0,
                          backoff_factor=2.0, backoff_max_mult=8.0,
                          backoff_jitter=0.0)
    assert q.claim() is not None          # fresh lease at t=0
    t[0] = 0.99
    assert q.claim() is None              # not yet expired
    t[0] = 1.0
    assert q.claim() is not None          # expiry #1: base timeout
    t[0] += 1.99
    assert q.claim() is None              # now needs 2x base
    t[0] += 0.01
    assert q.claim() is not None          # expiry #2 at 2x
    t[0] += 3.99
    assert q.claim() is None              # now needs 4x base
    t[0] += 0.01
    assert q.claim() is not None          # expiry #3 at 4x
    t[0] += 7.99
    assert q.claim() is None              # 8x base
    t[0] += 0.01
    assert q.claim() is not None          # expiry #4 at 8x
    t[0] += 7.99
    assert q.claim() is None              # capped: STILL 8x, not 16x
    t[0] += 0.01
    got = q.claim()
    assert got is not None
    idx, _, tok = got
    assert q.complete(idx, tok)
    assert q.finished


@impl
def test_backoff_jitter_is_bounded_and_deterministic(fault, chaos):
    """Jitter stretches the backed-off timeout by at most backoff_jitter x,
    never shrinks it, and is a pure function of (seed, item, attempt):
    two queues replaying the same sequence agree exactly."""
    waits = []
    for _ in range(2):
        q, t = _clocked_queue(fault, n_items=1, tile=1, timeout=1.0,
                              backoff_factor=2.0, backoff_max_mult=8.0,
                              backoff_jitter=0.25, jitter_seed=7)
        assert q.claim() is not None
        t[0] = 1.0
        assert q.claim() is not None      # first expiry: base, jitter-free
        run = []
        for mult in (2.0, 4.0):
            lo, hi = mult, mult * 1.25
            t[0] += lo - 1e-9
            assert q.claim() is None      # below the un-jittered floor: never
            lo_probe = t[0]
            while q.claim() is None:      # scan to the jittered deadline
                t[0] += mult / 256.0
            run.append(t[0] - lo_probe)
            assert t[0] - lo_probe <= hi - lo + mult / 128.0
        waits.append(run)
    assert waits[0] == waits[1]           # deterministic across queues


@impl
def test_release_resets_backoff(fault, chaos):
    """A voluntary release (live worker handing the item back) resets the
    expiry ladder: the next lease expires at the base timeout again."""
    q, t = _clocked_queue(fault, n_items=1, tile=1, timeout=1.0,
                          backoff_factor=2.0, backoff_jitter=0.0)
    q.claim()
    t[0] = 1.0
    q.claim()                             # expiry #1
    t[0] += 2.0
    idx, _, tok = q.claim()               # expiry #2 (2x)
    assert q.release(idx, tok)
    got = q.claim()                       # immediate: released, not expired
    assert got is not None
    idx, _, tok = got
    t[0] += 0.999
    assert q.claim() is None
    t[0] += 0.001
    assert q.claim() is not None          # base timeout again, not 4x
    assert not q.complete(idx, tok)       # stale after the re-lease


@impl
def test_zero_timeout_stays_immediate_under_backoff(fault, chaos):
    """timeout=0 ("every lease already expired" test mode) is unaffected by
    backoff: 0 x anything = 0, so reclaim stays immediate at every attempt."""
    q = fault.WorkQueue(n_items=1, tile=1, timeout=0.0)
    toks = [q.claim()[2] for _ in range(5)]
    assert toks == [1, 2, 3, 4, 5]


@impl
def test_lease_expiry_storm_reclaims_all(fault, chaos):
    """`chaos.force_lease_expiry` (mass worker death) makes every live lease
    reclaimable at once; generation tokens still fence the dead cohort."""
    q = fault.WorkQueue(n_items=4, tile=1, timeout=3600.0)
    dead = [q.claim() for _ in range(4)]
    assert q.claim() is None              # all leased, nothing expired
    assert chaos.force_lease_expiry(q) == 4
    live = [q.claim() for _ in range(4)]
    assert all(c is not None for c in live)
    for (idx, _, tok) in dead:
        assert not q.complete(idx, tok)   # dead cohort fenced out
    for (idx, _, tok) in live:
        assert q.complete(idx, tok)
    assert q.finished


# ---------------------------------------------------------------------------
# the port against the reference: same operations, same answers
# ---------------------------------------------------------------------------

def test_mix_and_hash_draws_are_the_references_bit_for_bit():
    rng = random.Random(3)
    for _ in range(2000):
        a, b, c = (rng.randrange(2 ** 40) for _ in range(3))
        assert tfault._mix_unit(a, b, c) == jfault._mix_unit(a, b, c)
        assert tchaos._hash_draw(a, b, c) == jchaos._hash_draw(a, b, c)
    assert tchaos._hash_draw(5, 3, -1) == jchaos._hash_draw(5, 3, -1)


@pytest.mark.parametrize("seed", range(12))
def test_port_replays_the_reference_on_random_operations(seed):
    """Push, claim, complete, release, renew and clock moves drawn from one
    seed, applied to a port queue and a reference queue on the same manual
    clock: every return value and the queues' counts agree step for
    step."""
    rng = random.Random(seed)
    kw = dict(n_items=rng.randint(0, 20), tile=rng.randint(1, 4),
              timeout=rng.choice([0.0, 0.5, 2.0]), backoff_jitter=0.25,
              jitter_seed=seed)
    clock = [0.0]
    queues = [f.WorkQueue(clock=lambda: clock[0], **kw)
              for f in (tfault, jfault)]
    leases = []
    for step in range(300):
        op = rng.random()
        if op < 0.1:
            got = [q.push(("item", step)) for q in queues]
        elif op < 0.5:
            got = [q.claim() for q in queues]
            if got[0] is not None:
                leases.append((got[0][0], got[0][2]))
        elif op < 0.7 and leases:
            idx, tok = leases.pop(rng.randrange(len(leases)))
            got = [q.complete(idx, tok) for q in queues]
        elif op < 0.8 and leases:
            idx, tok = rng.choice(leases)
            got = [q.release(idx, tok) for q in queues]
        elif op < 0.9 and leases:
            idx, tok = rng.choice(leases)
            got = [q.renew(idx, tok) for q in queues]
        else:
            clock[0] += rng.choice([0.1, 0.6, 3.0])
            got = [None, None]
        assert got[0] == got[1], (step, got)
        assert queues[0].pending == queues[1].pending
        assert queues[0].finished == queues[1].finished


@pytest.mark.parametrize("seed", range(4))
def test_chaos_schedules_fire_as_the_references(seed):
    """A random kill/ckpt_crash process and an explicit schedule fire the
    same (epoch, shard, kind) sequence in both packages."""
    fired = []
    for chaos in (tchaos, jchaos):
        monkey = chaos.ChaosMonkey(seed=seed, schedule=[(2, 1, "kill")],
                                   p_kill=0.3, p_ckpt_crash=0.4,
                                   max_failures=6)
        log = []
        for epoch in range(1, 12):
            for shard in range(3):
                try:
                    monkey.on_tile(epoch, shard, 0)
                except chaos.ShardFailure as e:
                    log.append((epoch, e.shard, e.kind))
            try:
                monkey.on_snapshot(epoch)
            except chaos.CheckpointWriteCrash:
                log.append((epoch, -1, "ckpt_crash"))
        assert log == monkey.fired
        fired.append(log)
    assert fired[0] == fired[1] and fired[0]
