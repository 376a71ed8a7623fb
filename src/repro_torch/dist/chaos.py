"""Deterministic fault injection for elastic ensemble runs (the port of
`repro.dist.chaos`; its draws are the reference's bit for bit).

The elastic supervisor (`repro_torch.dist.elastic`) exposes two chaos
points per run — once per (epoch, shard) before that shard's tile work,
and once per snapshot before the checkpoint write.  `ChaosMonkey` drives
them from a deterministic schedule (explicit ``(epoch, shard, kind)`` triples) and/or a
seed-driven random process whose draws are keyed on ``(seed, epoch, shard)``
— NOT on call order — so the same failure sequence replays bitwise across
runs, re-shards and processes.

Failure kinds:

``"kill"``
    Raise `ShardFailure` — models a clean shard loss (host OOM, preemption
    notice, network partition detected by the supervisor).  The supervisor's
    retry ladder catches it, discards the shard's in-memory tile state, and
    re-shards the surviving lanes from the last snapshot.
``"sigkill"``
    SIGKILL the current PROCESS — models an uncatchable hard kill.  Only
    meaningful from a subprocess harness: the parent observes returncode -9
    and relaunches with ``resume=True`` (see tests/test_torch_elastic.py).
``"ckpt_crash"``
    Raise `CheckpointWriteCrash` from the snapshot chaos point — models a
    crash while checkpointing.  The atomic tmp-dir-rename layer guarantees
    the previous complete snapshot survives; the supervisor records the
    failure and carries on with the old snapshot as its restore point.

For crash-at-the-syscall-level coverage, `install_ckpt_write_crash` arms the
checkpoint layer's stage hook so the next `ckpt.save` SIGKILLs itself
mid-write (optionally tearing the half-written arrays file first) — used by
the crash-mid-save atomicity tests in
tests/test_torch_checkpoint_fault.py.

`force_lease_expiry` ages every live lease in a `WorkQueue` to simulate a
lease-expiry storm (mass worker death) without sleeping through timeouts.
"""
from __future__ import annotations

import os
import signal
from typing import Iterable, List, Optional, Tuple


class ShardFailure(RuntimeError):
    """A shard died (injected or real); its in-memory tile state is lost."""

    def __init__(self, shard: int, kind: str = "kill", detail: str = ""):
        msg = f"shard {shard} failed ({kind})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.shard = int(shard)
        self.kind = kind
        self.detail = detail


class CheckpointWriteCrash(RuntimeError):
    """Injected crash during a snapshot write (previous snapshot survives)."""


def _hash_draw(seed: int, epoch: int, shard: int) -> float:
    """Deterministic uniform in [0, 1) keyed on (seed, epoch, shard).

    Integer mixing (splitmix64-style) rather than `hash(tuple)` so draws are
    stable across processes regardless of PYTHONHASHSEED.
    """
    x = (seed * 0x9E3779B97F4A7C15 + epoch * 0xBF58476D1CE4E5B9
         + shard * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x / 2.0 ** 64


class ChaosMonkey:
    """Seed-driven failure schedules for the elastic supervisor.

    Args:
      seed: base seed for the random failure process.
      schedule: explicit ``(epoch, shard, kind)`` triples; each entry fires
        at most ONCE (a failure rolls the epoch back for the dead shard's
        tiles, so without one-shot semantics a scheduled kill would re-fire
        forever on the retried epoch).  ``kind == "ckpt_crash"`` entries fire
        from the snapshot chaos point (their shard field is ignored).
      p_kill: per-(epoch, shard) probability of a random ``"kill"``.
      p_ckpt_crash: per-epoch probability of a random ``"ckpt_crash"``.
      max_failures: cap on TOTAL fired events (None = unlimited).
    """

    def __init__(self, seed: int = 0,
                 schedule: Iterable[Tuple[int, int, str]] = (),
                 p_kill: float = 0.0, p_ckpt_crash: float = 0.0,
                 max_failures: Optional[int] = None):
        self.seed = int(seed)
        self._schedule: List[Tuple[int, int, str]] = [
            (int(e), int(s), str(k)) for e, s, k in schedule]
        self.p_kill = float(p_kill)
        self.p_ckpt_crash = float(p_ckpt_crash)
        self.max_failures = max_failures
        self.fired: List[Tuple[int, int, str]] = []
        self._rolled = set()            # (epoch, shard) random draws consumed

    def _exhausted(self) -> bool:
        return (self.max_failures is not None
                and len(self.fired) >= self.max_failures)

    def _fire(self, epoch: int, shard: int, kind: str):
        self.fired.append((epoch, shard, kind))
        if kind == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        if kind == "ckpt_crash":
            raise CheckpointWriteCrash(
                f"injected checkpoint-write crash at epoch {epoch}")
        raise ShardFailure(shard, kind, detail=f"injected at epoch {epoch}")

    def on_tile(self, epoch: int, shard: int, tile: int) -> None:
        """Chaos point before shard `shard` works its tiles in `epoch`."""
        if self._exhausted():
            return
        for entry in self._schedule:
            e, s, k = entry
            if e == epoch and s == shard and k != "ckpt_crash":
                self._schedule.remove(entry)
                self._fire(epoch, shard, k)
        key = (epoch, shard)
        if self.p_kill > 0.0 and key not in self._rolled:
            self._rolled.add(key)
            if _hash_draw(self.seed, epoch, shard) < self.p_kill:
                self._fire(epoch, shard, "kill")

    def on_snapshot(self, epoch: int) -> None:
        """Chaos point immediately before a snapshot write."""
        if self._exhausted():
            return
        for entry in self._schedule:
            e, _s, k = entry
            if e == epoch and k == "ckpt_crash":
                self._schedule.remove(entry)
                self._fire(epoch, -1, k)
        key = (epoch, -1)
        if self.p_ckpt_crash > 0.0 and key not in self._rolled:
            self._rolled.add(key)
            if _hash_draw(self.seed ^ 0x5DEECE66D, epoch, -1) \
                    < self.p_ckpt_crash:
                self._fire(epoch, -1, "ckpt_crash")


def install_ckpt_write_crash(stage: str = "pre_rename",
                             tear_arrays: bool = False) -> None:
    """Arm `repro_torch.checkpoint.ckpt` so the NEXT save SIGKILLs itself at
    `stage` ("arrays" — payload written, meta/rename pending; "meta" — tmp
    dir complete, publish rename pending; "pre_rename" — immediately before
    the publish rename, after any same-step predecessor was moved aside).
    With ``tear_arrays`` the
    half-written ``arrays.npz`` is truncated first, simulating a torn write.
    Process-fatal by design — only call from a sacrificial subprocess.
    """
    from repro_torch.checkpoint import ckpt as ckpt_lib

    def hook(name: str, tmp_dir: str) -> None:
        if name != stage:
            return
        if tear_arrays:
            path = os.path.join(tmp_dir, "arrays.npz")
            if os.path.exists(path):
                with open(path, "r+b") as fh:
                    fh.truncate(max(os.path.getsize(path) // 2, 1))
        os.kill(os.getpid(), signal.SIGKILL)

    ckpt_lib._crash_hook = hook


def force_lease_expiry(queue) -> int:
    """Age every live lease in a `WorkQueue` so it is immediately
    reclaimable (a lease-expiry storm: all workers presumed dead at once).
    Backoff state is preserved — reclaim pacing still applies on repeated
    storms.  Returns the number of leases expired."""
    n = 0
    with queue._lock:
        for off, leased in enumerate(queue._leased_at):
            if leased is not None and not queue._done[off]:
                queue._leased_at[off] = -1.0e18
                n += 1
    return n
