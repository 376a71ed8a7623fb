"""Fault tolerance: checkpoint supervision and straggler work reassignment
(the port of `repro.dist.fault`; pure Python, kept here as the port's own
copy).

`TrainSupervisor` wraps the atomic step-addressed checkpointer
(`repro_torch.checkpoint.ckpt`) with the restart contract: crash-and-rerun
resumes from the newest complete checkpoint, and periodic saves are one
call in the training loop.  `WorkQueue` is the ensemble-tile analogue of a
straggler-tolerant scheduler: tiles of the trajectory axis are leased to
workers and become reassignable when a lease times out (a dead worker never
wedges the sweep — the same tile-local-termination property the fused
kernel has on device, at the job level).  It is also the request scheduler
behind `repro_torch.serve`: requests are `push()`-ed as work items, pool
pumps `claim()` them under lease, and a pump that dies mid-request simply
lets the lease expire so the next pump retries the request.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


def _mix_unit(seed: int, idx: int, n: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, item index, reclaim
    count) — splitmix64-style integer mixing, stable across processes."""
    x = (seed * 0x9E3779B97F4A7C15 + idx * 0xBF58476D1CE4E5B9
         + n * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x / 2.0 ** 64


class TrainSupervisor:
    """Periodic-checkpoint + resume-from-latest supervision for a train loop.

    There is deliberately no checkpoint writer here: `_save` delegates to
    `repro.checkpoint.ckpt.save` — the repo's single atomic
    tmp-dir-fsync-rename path — so a crash mid-save can never corrupt this
    supervisor's latest checkpoint either (crash-mid-save coverage for both
    sync and async write modes lives in
    tests/test_torch_checkpoint_fault.py).
    """

    def __init__(self, ckpt_dir: str, save_every: int = 1000,
                 async_save: bool = False, device=None):
        self.ckpt_dir = ckpt_dir
        self.device = device     # where a restore puts the state
        self.save_every = int(save_every)
        self.async_save = async_save
        self._pending = None
        self._last_saved: Optional[int] = None

    def resume_or_init(self, init_fn: Callable[[], Any], like_tree: Any
                       ) -> Tuple[int, Any, Dict]:
        """Restore the newest checkpoint into `like_tree`'s structure, or call
        `init_fn` for a fresh start. Returns (step, state, extra)."""
        from repro_torch.checkpoint import ckpt as ckpt_lib
        latest = ckpt_lib.restore_latest(self.ckpt_dir, like_tree,
                                         device=self.device)
        if latest is None:
            return 0, init_fn(), {}
        step, state, extra = latest
        return step, state, extra

    def maybe_save(self, step: int, state: Any,
                   extra: Optional[Dict] = None) -> bool:
        """Checkpoint when `step` lands on the save_every grid.

        Step 0 is skipped: `0 % save_every == 0` used to write a pointless
        checkpoint of the exact init state every run (and, worse, a restart
        would then "resume" from step 0 instead of calling init_fn fresh).
        The final, possibly off-grid state is the loop's responsibility —
        call `finalize(step, state)` at loop exit.
        """
        if step == 0 or step % self.save_every != 0:
            return False
        return self._save(step, state, extra)

    def finalize(self, step: int, state: Any,
                 extra: Optional[Dict] = None) -> bool:
        """Checkpoint the loop-exit state (even off the save_every grid) and
        join any in-flight async write.  No-op when `step` was already saved
        by `maybe_save` (exit step on the grid)."""
        if step == self._last_saved or step == 0:
            self.flush()
            return False
        saved = self._save(step, state, extra)
        self.flush()
        return saved

    def _save(self, step: int, state: Any, extra: Optional[Dict]) -> bool:
        from repro_torch.checkpoint import ckpt as ckpt_lib
        self.flush()
        self._pending = ckpt_lib.save(self.ckpt_dir, step, state, extra=extra,
                                      async_write=self.async_save)
        self._last_saved = step
        return True

    def flush(self):
        """Join any in-flight async write (call before exit/restore)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None


class WorkQueue:
    """Lease-based tile queue with straggler reassignment.

    `n_items` units are split into `tile`-sized work units. `claim()` leases
    the first tile that is unfinished and either unclaimed or past its lease
    `timeout` (seconds) — a crashed/straggling worker's tile is simply handed
    to the next claimer.

    Concurrency contract (this is what makes the queue safe as the
    `repro_torch.serve` scheduler):

    * every method takes an internal `threading.Lock`, so claims from
      concurrent pump threads never hand the same lease out twice;
    * `claim()` returns ``(idx, span, token)`` where `token` is the lease
      *generation* for that tile — re-leasing an expired tile bumps the
      generation, so a timed-out straggler that wakes up late and calls
      `complete(idx, token)` with its stale token is a no-op instead of
      retiring work that a live worker re-claimed (and may be mid-flight
      on, or may have claimed a *different attempt* of).
    * `push(payload)` appends a work item dynamically (request arrival);
    * `renew(idx, token)` refreshes a live lease's clock — a worker actively
      solving an item keeps calling it so in-flight work is never re-leased
      just because it outlasts `timeout`;
    * retired items are garbage-collected: the done prefix is dropped from
      the internal lists (indices stay valid — they are global, offset by an
      internal base) and retired payloads are released immediately, so a
      long-running service neither retains every request ever served nor
      scans the full history on each `claim()`;
    * expiry-reclaim backs off: the FIRST expiry of a lease reclaims at the
      base `timeout`, but every further expiry of the SAME item multiplies
      its effective lease timeout by `backoff_factor` (capped at
      `backoff_max_mult` × base) plus a deterministic per-(item, attempt)
      jitter of up to `backoff_jitter` × the backed-off timeout — so a dead
      worker's items don't thrash between survivors under tiny timeouts,
      and a thundering herd of claimers doesn't resynchronize on the same
      expiry instant.  A voluntary `release` resets the item's backoff (the
      worker was alive; nothing expired), as does a successful re-lease
      followed by `complete`.  ``timeout == 0`` stays immediate at every
      attempt (0 × anything = 0) — the serve layer's "every lease already
      expired" test mode keeps working.

    `clock` is injectable (defaults to `time.monotonic`) so backoff
    schedules are testable without sleeping
    (tests/test_torch_workqueue_props.py).
    """

    def __init__(self, n_items: int = 0, tile: int = 1,
                 timeout: float = 60.0, *, backoff_factor: float = 2.0,
                 backoff_max_mult: float = 8.0, backoff_jitter: float = 0.25,
                 jitter_seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.tiles: List[Any] = [
            (lo, min(lo + tile, n_items)) for lo in range(0, n_items, tile)]
        self.timeout = float(timeout)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_mult = float(backoff_max_mult)
        self.backoff_jitter = float(backoff_jitter)
        self._jitter_seed = int(jitter_seed)
        self._clock = clock
        self._done = [False] * len(self.tiles)
        self._leased_at: List[Optional[float]] = [None] * len(self.tiles)
        self._gen = [0] * len(self.tiles)
        self._expiries = [0] * len(self.tiles)   # expiry-reclaims per item
        self._base = 0                      # global index of tiles[0]
        self._n_pushed = len(self.tiles)
        self._n_done = 0
        self._lock = threading.Lock()

    def _lease_timeout_locked(self, off: int) -> float:
        """Effective lease timeout for item `off`'s CURRENT lease: base
        timeout, exponentially backed off by prior expiry-reclaims, with
        deterministic jitter keyed on (item, attempt)."""
        n = self._expiries[off]
        if n == 0:
            return self.timeout
        mult = min(self.backoff_factor ** n, self.backoff_max_mult)
        jit = self.backoff_jitter * _mix_unit(
            self._jitter_seed, self._base + off, n)
        return self.timeout * mult * (1.0 + jit)

    def push(self, payload: Any) -> int:
        """Append one work item (any payload; tile spans are just the
        original payload shape). Returns its (global) index."""
        with self._lock:
            self.tiles.append(payload)
            self._done.append(False)
            self._leased_at.append(None)
            self._gen.append(0)
            self._expiries.append(0)
            self._n_pushed += 1
            return self._base + len(self.tiles) - 1

    def _compact_locked(self) -> None:
        # drop the retired prefix; global indices stay valid via _base
        k = 0
        while k < len(self._done) and self._done[k]:
            k += 1
        if k:
            del self.tiles[:k]
            del self._done[:k]
            del self._leased_at[:k]
            del self._gen[:k]
            del self._expiries[:k]
            self._base += k

    def claim(self) -> Optional[Tuple[int, Any, int]]:
        """Lease the first available item: (idx, payload, lease token).

        An unclaimed item leases immediately.  A leased item is reclaimable
        only once its CURRENT lease has outlived its effective timeout —
        base `timeout` on the first expiry, jittered-exponentially larger on
        each subsequent expiry of the same item (see class docstring)."""
        now = self._clock()
        with self._lock:
            self._compact_locked()
            for off, done in enumerate(self._done):
                if done:
                    continue
                leased = self._leased_at[off]
                if leased is None:
                    self._leased_at[off] = now
                    self._gen[off] += 1
                    return self._base + off, self.tiles[off], self._gen[off]
                if now - leased >= self._lease_timeout_locked(off):
                    self._expiries[off] += 1
                    self._leased_at[off] = now
                    self._gen[off] += 1
                    return self._base + off, self.tiles[off], self._gen[off]
        return None

    def complete(self, idx: int, token: int) -> bool:
        """Retire item `idx` iff `token` is its *current* lease generation.

        Returns True when the completion was accepted; False for a stale
        token (the lease expired and the item was re-leased — the caller's
        result must be discarded, the live claimer owns the item now)."""
        with self._lock:
            off = idx - self._base
            if off < 0 or off >= len(self._done) or self._done[off]:
                return False
            if token != self._gen[off]:
                return False
            self._done[off] = True
            self._leased_at[off] = None
            self.tiles[off] = None          # release the payload now
            self._n_done += 1
            return True

    def release(self, idx: int, token: int) -> bool:
        """Voluntarily return a leased item to the pool (still unfinished).
        Stale tokens are ignored, like `complete`.  Resets the item's
        expiry backoff: the worker proved alive, so the next lease runs on
        the base timeout again."""
        with self._lock:
            off = idx - self._base
            if off < 0 or off >= len(self._done) or self._done[off] \
                    or token != self._gen[off]:
                return False
            self._leased_at[off] = None
            self._expiries[off] = 0
            return True

    def renew(self, idx: int, token: int) -> bool:
        """Refresh a live lease's clock (worker still actively on the item),
        so in-flight work outlasting `timeout` is not handed to another
        claimer.  Stale tokens are ignored, like `complete`."""
        with self._lock:
            off = idx - self._base
            if off < 0 or off >= len(self._done) or self._done[off] \
                    or token != self._gen[off]:
                return False
            self._leased_at[off] = self._clock()
            return True

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._n_done == self._n_pushed

    @property
    def pending(self) -> int:
        """Items not yet retired (leased or not)."""
        with self._lock:
            return self._n_pushed - self._n_done
