"""Elastic fault-tolerant sharded ensemble runs — the port of
`repro.dist.elastic`.

`ElasticSupervisor` wraps an ensemble solve in bounded segments so the run
can survive shard loss:

* the N requested lanes are packed into tiles of a FIXED width B
  (``tile_width``; the last tile is padded with one-iteration filler
  columns, the `repro_torch.serve.slots.SlotPool` convention).  B is part
  of the run identity (the reference's XLA codegen is width-sensitive at
  the ulp level, and a reduction on the card may be too), so elasticity
  NEVER changes widths — failures redistribute whole tiles across shards,
  they never repartition lanes;
* resumable methods (erk, fixed-dt sde) advance through ONE
  `ResumableEngine` (the lanes engine on the supervisor's device) per
  epoch (`segment_steps` attempts per lane);
  non-resumable methods (rosenbrock's batch-coupled lazy-W gates, adaptive
  SDE's dt-path-dependent Brownian-tree state) run tiles as one-shot
  `solve_ensemble_local` calls instead (on ``backend``: ``"cuda"`` runs
  the hand-written kernels) — a lost shard re-runs its in-flight tile from
  scratch, which is bitwise harmless because the tile's lane content is
  fixed;
* every ``snapshot_every`` epochs the supervisor host-gathers all tile
  carries (u, t, dt, naccept/nreject, per-lane constants, RNG lane indices
  — the COMPLETE restart state) and writes them through the atomic
  checkpoint layer (`repro_torch.checkpoint.ckpt`).  Snapshots are
  unsharded, so a restore may re-shard onto ANY shard count — including a
  different process after SIGKILL (``run(resume=True)``);
* on a shard failure (injected via `repro_torch.dist.chaos` or a real
  exception from tile work) the dead shard's in-memory tile state is
  discarded, its tiles are restored from the last snapshot (or fresh state before the
  first snapshot), and the unfinished tiles are re-dealt over the
  survivors through a `WorkQueue` ordered by per-tile straggler pressure
  (active lanes + accept/reject attempt deltas since the last snapshot);
* retry follows a degradation ladder: jittered exponential backoff per
  failure, fewer shards → a single revived host when every shard has died,
  and — past ``max_failures`` — a PARTIAL result in which unfinished lanes
  carry ``status == STATUS_SHARD_LOST`` instead of the run aborting.

Bitwise-resume contract: a lane's trajectory is the body-application
sequence of its own column, and applying the body to a done lane is an
exact no-op — so WHICH epochs advanced a lane, which shard held it, and how
often it was rolled back to a snapshot and replayed are all invisible in
the final state.  Because the counter-RNG stream (and the virtual Brownian
tree above it) is a pure function of (seed; step, GLOBAL lane index, row),
this holds across re-sharding too: a killed-and-resumed run is bitwise
identical to an uninterrupted one (tests/test_torch_elastic.py SIGKILLs a
run mid-flight and diffs trajectories).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.core.ensemble import (export_resume_carry,
                                       import_resume_carry,
                                       make_resumable_engine, resolve_device,
                                       solve_ensemble_local)
from repro_torch.core.methods import get_method
from repro_torch.core.problem import EnsembleProblem
from repro_torch.dist.chaos import (CheckpointWriteCrash, ShardFailure,
                                    _hash_draw)
from repro_torch.dist.fault import WorkQueue

#: Per-lane status for lanes the degradation ladder could not finish
#: (supervisor bailed past max_failures / ran out of epochs while degraded).
#: Extends the solver vocabulary {0: success, 1: iter budget, 2: dt_min}.
STATUS_SHARD_LOST = 3


@dataclass
class ElasticResult:
    """Per-lane final states + stats of an elastic run (host numpy).

    `report` documents the run's fault history: epochs, failures (with
    epoch/shard/kind), re-shard events, snapshot count, degradation-ladder
    steps, and whether the run bailed to a partial result.  One-shot mode
    also returns dense saves (`us`, `ts`) when every tile completed in this
    process (tiles restored from a process-level resume carry final states
    only).
    """
    u_final: np.ndarray          # (N, n)
    t_final: np.ndarray          # (N,)
    naccept: np.ndarray          # (N,)
    nreject: np.ndarray          # (N,)
    status: np.ndarray           # (N,) int32
    event_t: np.ndarray          # (N,)
    event_count: np.ndarray      # (N,)
    nf: int
    njac: int
    nfact: int
    report: Dict[str, Any] = field(default_factory=dict)
    us: Optional[np.ndarray] = None     # (N, S, n) one-shot mode only
    ts: Optional[np.ndarray] = None     # (S,)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _finalize_status(status, done, bailed: bool):
    undone_code = STATUS_SHARD_LOST if bailed else 1
    return np.where(status > 0, status,
                    np.where(done, 0, undone_code)).astype(np.int32)


class ElasticSupervisor:
    """Segmented, snapshotting, re-sharding ensemble run supervisor.

    Args:
      eprob: `EnsembleProblem` (lane content is materialized once, up
        front — tile membership never changes, which is what makes re-runs
        and re-shards bitwise-invisible).
      alg: registry method name / MethodSpec / Tableau.
      ckpt_dir: snapshot directory (atomic step-addressed layout).  A fresh
        run (``resume=False``) clears prior steps in it; ``resume=True``
        restores the newest complete snapshot — with THIS supervisor's
        ``n_shards``, which may differ from the writer's.
      n_shards: worker count to deal tiles over.  This is a scheduling
        property only; results are independent of it.
      tile_width: compiled lane width B (fixed for the run's lifetime).
      segment_steps: solver attempts per lane per epoch (segment mode).
      snapshot_every: epochs between snapshots.
      max_failures: failures tolerated before bailing to a partial result.
      backoff_base/backoff_factor/backoff_max/backoff_jitter: retry-delay
        ladder (seconds; deterministic jitter).  ``backoff_base=0`` never
        sleeps (tests).
      chaos: optional `repro_torch.dist.chaos.ChaosMonkey`.
      backend: the one-shot tiles' backend (``"torch"``, the counterpart of
        the reference's ``"xla"``, or ``"cuda"``); segment mode always runs
        the lanes engine.
      device: where the tiles run (None: the card).
      solver knobs (t0, tf, dt0, n_steps, adaptive, rtol, atol, event,
        seed, lane_offset, max_iters, **solve_kwargs) mirror
        `solve_ensemble_local`; extra kwargs are passed through to one-shot
        tile solves (error_est, w_reuse, linsolve, saveat, ...).
    """

    def __init__(self, eprob: EnsembleProblem, alg="tsit5", *, ckpt_dir: str,
                 n_shards: int = 2, tile_width: int = 8,
                 segment_steps: int = 64, snapshot_every: int = 1,
                 keep_snapshots: int = 2, max_epochs: int = 100_000,
                 max_failures: int = 8, backoff_base: float = 0.01,
                 backoff_factor: float = 2.0, backoff_max: float = 2.0,
                 backoff_jitter: float = 0.25, chaos=None, rebalance=True,
                 t0=None, tf=None, dt0: float = 1e-2,
                 n_steps: Optional[int] = None, adaptive=None,
                 rtol: float = 1e-6, atol: float = 1e-6, event=None,
                 seed: int = 0, lane_offset: int = 0,
                 max_iters: int = 100_000, backend: str = "torch",
                 device=None, **solve_kwargs):
        self.spec = get_method(alg)
        self.prob = eprob.prob
        u0s, ps = eprob.materialize()
        self._u0s = _host(u0s)
        self._ps = _host(ps).astype(self._u0s.dtype)
        self.N = int(self._u0s.shape[0])
        self.n = int(self._u0s.shape[1])
        self.dtype = self._u0s.dtype
        self.ckpt_dir = ckpt_dir
        self.n_shards = int(n_shards)
        self.B = int(tile_width)
        self.T = -(-self.N // self.B)                 # ceil
        self.segment_steps = int(segment_steps)
        self.snapshot_every = max(int(snapshot_every), 1)
        self.keep_snapshots = int(keep_snapshots)
        self.max_epochs = int(max_epochs)
        self.max_failures = int(max_failures)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max = float(backoff_max)
        self.backoff_jitter = float(backoff_jitter)
        self.chaos = chaos
        self.rebalance = bool(rebalance)

        tspan = getattr(self.prob, "tspan", (0.0, 1.0))
        self.t0 = float(tspan[0] if t0 is None else t0)
        self.tf = float(tspan[1] if tf is None else tf)
        self.dt0 = float(dt0)
        self.rtol, self.atol = float(rtol), float(atol)
        self.event = event
        self.seed = int(seed)
        self.lane_offset = int(lane_offset)
        self.max_iters = int(max_iters)
        self.backend = backend
        self.device = resolve_device(device)
        self.solve_kwargs = dict(solve_kwargs)

        if self.spec.family == "sde":
            self.adaptive = bool(adaptive) if adaptive is not None else False
            if not self.adaptive and n_steps is None:
                n_steps = int(round((self.tf - self.t0) / self.dt0))
        else:
            self.adaptive = (self.spec.adaptive if adaptive is None
                             else bool(adaptive))
        self.n_steps = None if n_steps is None else int(n_steps)

        self.mode = ("segment" if self.spec.resumable
                     and not (self.spec.family == "sde" and self.adaptive)
                     else "oneshot")
        if self.mode == "segment":
            self.engine = make_resumable_engine(
                self.spec, self.prob, adaptive=self.adaptive, rtol=self.rtol,
                atol=self.atol, event=self.event, seed=self.seed,
                segment_steps=self.segment_steps, device=self.device)
            # edge-padded lane content: padded columns are fillers that
            # retire in one iteration (tf == t0 / n_steps == 0) and are
            # dropped at assembly
            padn = self.T * self.B - self.N
            self._u0p = np.concatenate(
                [self._u0s, np.repeat(self._u0s[-1:], padn, axis=0)])
            self._psp = np.concatenate(
                [self._ps, np.repeat(self._ps[-1:], padn, axis=0)])
            self._nofill = np.zeros(self.B, bool)
        self._real = [
            np.arange(self.B) < min(self.B, self.N - t * self.B)
            for t in range(self.T)]

    # -- tile state -----------------------------------------------------------

    def _fresh_tile(self, t: int):
        """Fresh device carry for tile `t` (segment mode)."""
        cols = slice(t * self.B, (t + 1) * self.B)
        u0 = np.ascontiguousarray(self._u0p[cols].T)        # (n, B)
        p = np.ascontiguousarray(self._psp[cols].T)         # (k, B)
        real = self._real[t]
        t0v = np.full(self.B, self.t0, self.dtype)
        if self.spec.family == "sde":
            dtv = np.full(self.B, self.dt0, self.dtype)
            nsv = np.where(real, self.n_steps, 0).astype(np.int32)
            lanev = (self.lane_offset + t * self.B
                     + np.minimum(np.arange(self.B), real.sum() - 1)
                     ) & 0xFFFFFFFF
            return self.engine.fresh(u0, p, t0v, dtv, nsv, lanev)
        tfv = np.where(real, self.tf, self.t0).astype(self.dtype)
        dtv = np.full(self.B, self.dt0, self.dtype)
        return self.engine.fresh(u0, p, t0v, tfv, dtv)

    def _tile_stats(self, t: int) -> None:
        """Refresh the host-side done/attempt caches for tile `t`."""
        c = self._carries[t]
        keys = ["done", "naccept"] + (["nreject"] if "nreject" in c else [])
        h = {k: _host(c[k]) for k in keys}
        att = np.asarray(h["naccept"], np.int64)
        if "nreject" in h:
            att = att + np.asarray(h["nreject"], np.int64)
        self._done_host[t] = np.asarray(h["done"])
        self._att_host[t] = att

    def _tile_finished(self, t: int) -> bool:
        if self.mode == "oneshot":
            return bool(self._tile_done[t])
        return bool(self._done_host[t][self._real[t]].all())

    def _enforce_budget(self) -> None:
        """Force-retire lanes past max_iters (status 1), segment mode.

        Runs at epoch boundaries only, where every lane's attempt count is a
        deterministic multiple of segment_steps — so the forced-done
        decision replays identically after any rollback/re-shard."""
        if self.spec.family == "sde":
            return                       # bounded by n_steps per lane
        for t in range(self.T):
            over = (~self._done_host[t]) & (self._att_host[t]
                                            >= self.max_iters)
            if not over.any():
                continue
            c = dict(self._carries[t])
            overd = torch.from_numpy(over).to(self.device)
            c["status"] = torch.where(overd & (c["status"] == 0),
                                      torch.ones_like(c["status"]),
                                      c["status"])
            c["done"] = c["done"] | overd
            self._carries[t] = c
            self._done_host[t] = self._done_host[t] | over

    # -- snapshots ------------------------------------------------------------

    def _like_tree(self) -> Dict[str, np.ndarray]:
        if self.mode == "oneshot":
            return self._oneshot_like_tree()
        probe = export_resume_carry(self._fresh_tile(0))
        return {k: np.zeros((self.T,) + v.shape, v.dtype)
                for k, v in probe.items()}

    def _snapshot(self, epoch: int) -> None:
        if self.chaos is not None:
            self.chaos.on_snapshot(epoch)
        if self.mode == "oneshot":
            tree = self._oneshot_tree()
        else:
            host = {t: export_resume_carry(self._carries[t])
                    for t in range(self.T)}
            tree = {k: np.stack([host[t][k] for t in range(self.T)])
                    for k in host[0]}
            self._snap_host = host
        extra = dict(mode=self.mode, epoch=int(epoch), n_lanes=self.N,
                     tile_width=self.B, n_tiles=self.T,
                     alg=self.spec.name, failures=self._failures)
        ckpt_lib.save(self.ckpt_dir, int(epoch), tree, extra=extra)
        ckpt_lib.prune(self.ckpt_dir, keep=self.keep_snapshots)
        self.report["snapshots"] += 1
        # straggler pressure resets at the snapshot boundary
        if self.mode == "segment":
            self._att_prev = {t: self._att_host[t].copy()
                              for t in range(self.T)}

    def _restore_shard_tiles(self, shard: int) -> int:
        """Discard the dead shard's in-memory tile state; roll its tiles
        back to the last snapshot (fresh state before the first one)."""
        if self.mode == "oneshot":
            return 0                     # completed tiles live on the host
        n = 0
        for t in range(self.T):
            if self._owner[t] != shard:
                continue
            if self._snap_host is not None:
                self._carries[t] = import_resume_carry(self._snap_host[t],
                                                       self.device)
            else:
                self._carries[t] = self._fresh_tile(t)
            self._tile_stats(t)
            n += 1
        self.report["restored_tiles"] += n
        return n

    # -- scheduling -----------------------------------------------------------

    def _rebalance(self, reason: str) -> None:
        """Re-deal unfinished tiles over the alive shards.

        Tiles are pushed into a `WorkQueue` ordered by straggler pressure —
        active lane count plus the tile's accept/reject attempt delta since
        the last snapshot (normalized by segment_steps) — and dealt
        greedily to the least-loaded shard, so hot tiles spread first."""
        unfinished = [t for t in range(self.T) if not self._tile_finished(t)]
        if not unfinished or not self._alive:
            return
        cost: Dict[int, float] = {}
        for t in unfinished:
            if self.mode == "oneshot":
                cost[t] = 1.0
                continue
            active = float((~self._done_host[t] & self._real[t]).sum())
            delta = float((self._att_host[t]
                           - self._att_prev.get(t, 0)).sum())
            cost[t] = 1.0 + active + delta / float(self.segment_steps)
        q = WorkQueue(timeout=3600.0)
        for t in sorted(unfinished, key=lambda t: (-cost[t], t)):
            q.push(t)
        load = {s: 0.0 for s in sorted(self._alive)}
        while (got := q.claim()) is not None:
            idx, tile, tok = got
            s = min(sorted(load), key=lambda k: (load[k], k))
            self._owner[tile] = s
            load[s] += cost[tile]
            q.complete(idx, tok)
        self.report["reshards"] += 1
        self.report["reshard_events"].append(dict(
            reason=reason, shards=sorted(self._alive),
            tiles=len(unfinished)))

    def _handle_failure(self, err: ShardFailure) -> None:
        self._failures += 1
        self.report["failures"].append(dict(
            epoch=self._epoch + 1, shard=err.shard, kind=err.kind))
        if self._failures > self.max_failures:
            self._bailed = True
            self._restore_shard_tiles(err.shard)
            return
        delay = min(self.backoff_max,
                    self.backoff_base
                    * self.backoff_factor ** (self._failures - 1))
        delay *= 1.0 + self.backoff_jitter * _hash_draw(
            self.seed, self._failures, err.shard)
        if delay > 0.0:
            time.sleep(delay)
        self._alive.discard(err.shard)
        if not self._alive:
            # bottom of the ladder: relaunch a single fresh worker
            self._alive = {0}
            self.report["degraded_single_host"] = True
        self.report["ladder"].append(len(self._alive))
        self._restore_shard_tiles(err.shard)
        self._rebalance("failure")

    # -- run loop -------------------------------------------------------------

    def _init_state(self, resume: bool) -> None:
        self._alive = set(range(self.n_shards))
        self._owner = {t: t % self.n_shards for t in range(self.T)}
        self._failures = 0
        self._bailed = False
        self._epoch = 0
        self._snap_host = None
        self.report: Dict[str, Any] = dict(
            mode=self.mode, alg=self.spec.name, n_lanes=self.N,
            tile_width=self.B, n_tiles=self.T, n_shards=self.n_shards,
            epochs=0, snapshots=0, reshards=0, restored_tiles=0,
            failures=[], reshard_events=[], ladder=[],
            degraded_single_host=False, bailed=False,
            resumed_from_epoch=None)
        if self.mode == "oneshot":
            self._tile_done = np.zeros(self.T, bool)
            self._results: Dict[int, Dict[str, Any]] = {}
        else:
            self._done_host: Dict[int, np.ndarray] = {}
            self._att_host: Dict[int, np.ndarray] = {}
            self._att_prev: Dict[int, np.ndarray] = {}
        restored = False
        if resume:
            restored = self._restore_from_disk()
        if not restored:
            ckpt_lib.prune(self.ckpt_dir, keep=0)   # fresh run owns the dir
            if self.mode == "segment":
                self._carries = {t: self._fresh_tile(t)
                                 for t in range(self.T)}
                for t in range(self.T):
                    self._tile_stats(t)
        self._rebalance("initial")
        self.report["reshards"] = 0        # initial deal isn't a re-shard
        self.report["reshard_events"].clear()

    def _restore_from_disk(self) -> bool:
        latest = ckpt_lib.restore_latest(self.ckpt_dir, self._like_tree(),
                                         device="cpu")
        if latest is None:
            return False
        step, tree, extra = latest
        for key, want in (("mode", self.mode), ("n_lanes", self.N),
                          ("tile_width", self.B), ("alg", self.spec.name)):
            if extra.get(key) != want:
                raise ValueError(
                    f"snapshot {key}={extra.get(key)!r} does not match this "
                    f"supervisor ({want!r}) — tile width, lane set and "
                    "method are part of the run identity")
        host_tree = {k: v.numpy() for k, v in tree.items()}
        if self.mode == "oneshot":
            self._restore_oneshot(host_tree)
        else:
            self._snap_host = {
                t: {k: host_tree[k][t] for k in host_tree}
                for t in range(self.T)}
            self._carries = {t: import_resume_carry(self._snap_host[t],
                                                    self.device)
                             for t in range(self.T)}
            for t in range(self.T):
                self._tile_stats(t)
        self._epoch = int(step)
        self.report["resumed_from_epoch"] = int(step)
        return True

    def run(self, resume: bool = False) -> ElasticResult:
        """Drive the run to completion (or a partial result) and assemble.

        Re-runnable: each call starts from fresh state (``resume=False``)
        or the newest on-disk snapshot (``resume=True``) while reusing the
        compiled engine, so an uninterrupted reference run and a
        chaos-interrupted run can share one supervisor instance."""
        self._init_state(resume)
        wall0 = time.perf_counter()
        while self.report["epochs"] < self.max_epochs and not self._bailed:
            if all(self._tile_finished(t) for t in range(self.T)):
                break
            epoch = self._epoch + 1
            try:
                for s in sorted(self._alive):
                    self._work_shard(epoch, s)
                self._epoch = epoch
                self.report["epochs"] += 1
                if self.mode == "segment":
                    self._enforce_budget()
                if epoch % self.snapshot_every == 0:
                    self._snapshot(epoch)
                    if self.rebalance:
                        self._rebalance("snapshot")
            except ShardFailure as exc:
                self._handle_failure(exc)
            except CheckpointWriteCrash:
                # snapshot write died; the previous snapshot is still the
                # restore point (atomic layer) — count it and keep solving
                self._epoch = epoch  # tile work of this epoch DID commit
                self._failures += 1
                self.report["failures"].append(dict(
                    epoch=epoch, shard=-1, kind="ckpt_crash"))
                if self._failures > self.max_failures:
                    self._bailed = True
        if self._bailed:
            self.report["bailed"] = True
        self.report["wall_s"] = time.perf_counter() - wall0
        self.report["alive_shards"] = sorted(self._alive)
        return self._assemble()

    def _work_shard(self, epoch: int, shard: int) -> None:
        mine = [t for t in sorted(self._owner)
                if self._owner[t] == shard and not self._tile_finished(t)]
        if self.mode == "oneshot":
            mine = mine[:1]              # one tile per shard per epoch
        for t in mine:
            if self.chaos is not None:
                self.chaos.on_tile(epoch, shard, t)
            try:
                if self.mode == "oneshot":
                    self._results[t] = self._solve_tile(t)
                    self._tile_done[t] = True
                else:
                    self._carries[t] = self.engine.step_segment(
                        self._carries[t], self._nofill, self._carries[t])
                    self._tile_stats(t)
            except (ShardFailure, CheckpointWriteCrash):
                raise
            except Exception as exc:     # real failure rides the same ladder
                raise ShardFailure(shard, "error", repr(exc)) from exc

    # -- one-shot mode --------------------------------------------------------

    def _solve_tile(self, t: int) -> Dict[str, Any]:
        lo = t * self.B
        hi = min(lo + self.B, self.N)
        nb = hi - lo
        ep = EnsembleProblem(self.prob, nb,
                             u0s=torch.from_numpy(self._u0s[lo:hi]),
                             ps=torch.from_numpy(self._ps[lo:hi]))
        kw = dict(t0=self.t0, tf=self.tf, dt0=self.dt0, rtol=self.rtol,
                  atol=self.atol, adaptive=self.adaptive,
                  max_iters=self.max_iters, event=self.event,
                  lane_tile=self.B, lane_offset=self.lane_offset + lo)
        if self.spec.family == "sde":
            kw.update(seed=self.seed, n_steps=self.n_steps)
        kw.update(self.solve_kwargs)
        res = solve_ensemble_local(ep, alg=self.spec, ensemble="kernel",
                                   backend=self.backend, device=self.device,
                                   **kw)
        return dict(
            u_final=_host(res.u_final),
            t_final=np.broadcast_to(_host(res.t_final), (nb,)).copy(),
            naccept=np.broadcast_to(_host(res.naccept), (nb,)).copy(),
            nreject=np.broadcast_to(_host(res.nreject), (nb,)).copy(),
            status=np.broadcast_to(_host(res.status), (nb,)).copy(),
            nf=int(_host(res.nf)), njac=int(_host(res.njac)),
            nfact=int(_host(res.nfact)),
            us=_host(res.us), ts=_host(res.ts))

    def _oneshot_like_tree(self) -> Dict[str, np.ndarray]:
        T, B, n = self.T, self.B, self.n
        return dict(
            u_final=np.zeros((T, B, n), self.dtype),
            t_final=np.zeros((T, B), self.dtype),
            naccept=np.zeros((T, B), np.int64),
            nreject=np.zeros((T, B), np.int64),
            status=np.zeros((T, B), np.int32),
            nf=np.zeros(T, np.int64), njac=np.zeros(T, np.int64),
            nfact=np.zeros(T, np.int64), tile_done=np.zeros(T, bool))

    def _oneshot_tree(self) -> Dict[str, np.ndarray]:
        tree = self._oneshot_like_tree()
        for t, r in self._results.items():
            nb = int(self._real[t].sum())
            tree["u_final"][t, :nb] = r["u_final"]
            tree["t_final"][t, :nb] = r["t_final"]
            tree["naccept"][t, :nb] = r["naccept"]
            tree["nreject"][t, :nb] = r["nreject"]
            tree["status"][t, :nb] = r["status"]
            tree["nf"][t] = r["nf"]
            tree["njac"][t] = r["njac"]
            tree["nfact"][t] = r["nfact"]
            tree["tile_done"][t] = True
        return tree

    def _restore_oneshot(self, tree: Dict[str, np.ndarray]) -> None:
        self._tile_done = np.asarray(tree["tile_done"]).copy()
        for t in range(self.T):
            if not self._tile_done[t]:
                continue
            nb = int(self._real[t].sum())
            self._results[t] = dict(
                u_final=tree["u_final"][t, :nb],
                t_final=tree["t_final"][t, :nb],
                naccept=tree["naccept"][t, :nb],
                nreject=tree["nreject"][t, :nb],
                status=tree["status"][t, :nb],
                nf=int(tree["nf"][t]), njac=int(tree["njac"][t]),
                nfact=int(tree["nfact"][t]), us=None, ts=None)

    # -- assembly -------------------------------------------------------------

    def _assemble(self) -> ElasticResult:
        if self.mode == "oneshot":
            return self._assemble_oneshot()
        fields = {k: [] for k in ("u", "t", "naccept", "nreject", "nf",
                                  "status", "done", "event_t", "event_count")}
        for t in range(self.T):
            h = export_resume_carry(self._carries[t])
            real = self._real[t]
            fields["u"].append(h["u"][:, real].T)
            fields["t"].append((h["t_out"] if "t_out" in h
                                else h["t"])[real])
            fields["naccept"].append(h["naccept"][real])
            fields["nreject"].append(h["nreject"][real] if "nreject" in h
                                     else np.zeros(real.sum(), np.int32))
            fields["nf"].append(h["nf"][real])
            fields["status"].append(h["status"][real])
            fields["done"].append(h["done"][real])
            fields["event_t"].append(h["event_t"][real])
            fields["event_count"].append(h["event_count"][real])
        cat = {k: np.concatenate(v) for k, v in fields.items()}
        status = _finalize_status(cat["status"], cat["done"], self._bailed)
        return ElasticResult(
            u_final=cat["u"], t_final=cat["t"], naccept=cat["naccept"],
            nreject=cat["nreject"], status=status, event_t=cat["event_t"],
            event_count=cat["event_count"], nf=int(cat["nf"].sum()),
            njac=0, nfact=0, report=dict(self.report))

    def _assemble_oneshot(self) -> ElasticResult:
        N, n = self.N, self.n
        u_final = np.array(self._u0s, copy=True)       # unstarted lanes
        t_final = np.full(N, self.t0, self.dtype)
        naccept = np.zeros(N, np.int64)
        nreject = np.zeros(N, np.int64)
        status = np.zeros(N, np.int32)
        done = np.zeros(N, bool)
        nf = njac = nfact = 0
        us_parts: List[Optional[np.ndarray]] = []
        ts = None
        for t in range(self.T):
            lo = t * self.B
            nb = int(self._real[t].sum())
            r = self._results.get(t)
            if r is None:
                us_parts.append(None)
                continue
            sl = slice(lo, lo + nb)
            u_final[sl] = r["u_final"]
            t_final[sl] = r["t_final"]
            naccept[sl] = r["naccept"]
            nreject[sl] = r["nreject"]
            status[sl] = r["status"]
            done[sl] = True
            nf += r["nf"]
            njac += r["njac"]
            nfact += r["nfact"]
            us_parts.append(r.get("us"))
            if r.get("ts") is not None:
                ts = r["ts"]
        status = _finalize_status(status, done, self._bailed)
        have_us = (all(p is not None for p in us_parts)
                   and len(us_parts) == self.T and self.T > 0)
        us = np.concatenate(us_parts, axis=0) if have_us else None
        return ElasticResult(
            u_final=u_final, t_final=t_final, naccept=naccept,
            nreject=nreject, status=status,
            event_t=np.full(N, np.inf, self.dtype),
            event_count=np.zeros(N, np.int64), nf=nf, njac=njac,
            nfact=nfact, report=dict(self.report), us=us,
            ts=None if us is None else ts)
