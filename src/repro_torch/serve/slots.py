"""Slot pools — the execution layer of the continuous-batching service, the
port of `repro.serve.slots`.

Two pool kinds, one per capability class (`MethodSpec.resumable`):

`SlotPool` (resumable methods: erk, fixed-dt sde)
    B fixed lane slots stepped by ONE resumable engine
    (`repro_torch.core.ensemble.ResumableEngine`, the lanes engine on the
    service's device).  Each slot holds one lane of one request; per-lane
    constants (p, tf / n_steps, lane index) live in the carry, so a retired
    slot is refilled with a DIFFERENT request's lane by a full-width masked
    merge.  Progress happens in bounded segments; between segments the pool
    harvests done lanes, enforces per-request attempt budgets, and admits
    staged lanes into free slots.  Lane results are bitwise a fresh
    `solve_ensemble_local(..., ensemble="kernel", backend="torch")` of the
    same request (same loop body, per-lane control, counter-RNG streams
    keyed by GLOBAL lane index).  The bookkeeping is vectorized over slots
    (numpy index arrays, one host read of the carry a harvest), so a pool
    of 2^16 slots runs no Python loop a lane.

`BatchPool` (non-resumable methods: rosenbrock, adaptive sde)
    Requests sharing the FULL solver signature (``backend`` included) are
    concatenated and solved in one `solve_ensemble_local` call per pump.
    Rosenbrock's lazy-W refresh gates are batch-reduced predicates (they
    couple lanes), so its lanes cannot retire early — coalescing into one
    batch is the right serving shape there.  Adaptive SDE additionally keys
    on the request's `lane_offset` (its Brownian streams are globally
    indexed), so those requests ride the same machinery uncoalesced.  The
    solve returns ensemble-total nf/njac/nfact; they are attributed to
    requests proportionally to per-lane attempt counts (an estimate — the
    engines do not count RHS evaluations a lane on these paths).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.ensemble import (make_resumable_engine,
                                       solve_ensemble_local)
from repro_torch.core.problem import EnsembleProblem


def _finalize_status(status, done):
    # mirror the front door: carried status wins; else 0 if done, 1 if not
    return np.where(status > 0, status, np.where(done, 0, 1))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class SlotPool:
    """Continuous batching over B fixed slots of one resumable engine."""

    def __init__(self, spec, prob, *, n: int, n_params: int, dtype,
                 width: int = 8, segment_steps: int = 64, adaptive=None,
                 rtol: float = 1e-6, atol: float = 1e-6, event=None,
                 seed: int = 0, device=None,
                 on_complete: Optional[Callable] = None):
        self.family = spec.family
        self.B = int(width)
        self.n = int(n)
        self.dtype = np.dtype(dtype)
        self.on_complete = on_complete
        self.engine = make_resumable_engine(
            spec, prob, adaptive=adaptive, rtol=rtol, atol=atol, event=event,
            seed=seed, segment_steps=segment_steps, device=device)
        B = self.B
        # persistent host staging buffers (full width; non-refilled columns
        # carry stale-but-finite filler values that the masked merge
        # discards).  Fillers retire in one iteration: tf == t0 (erk) /
        # n_steps == 0 (sde), so untouched columns never cost segment work.
        self._stage_u0 = np.ones((n, B), self.dtype)
        self._stage_p = np.ones((n_params, B), self.dtype)
        self._stage_t0 = np.zeros(B, self.dtype)
        if self.family == "sde":
            self._stage_dt = np.ones(B, self.dtype)
            self._stage_nsteps = np.zeros(B, np.int32)
            self._stage_lane = np.zeros(B, np.int64)
        else:
            self._stage_tf = np.zeros(B, self.dtype)
            self._stage_dt0 = np.ones(B, self.dtype)
        # slot -> (request, row): a request handle (index into _reqs, -1
        # for a free slot) and the lane's row in its request
        self._slot_req = np.full(B, -1, np.int64)
        self._slot_row = np.zeros(B, np.int64)
        self._reqs = {}                  # handle -> request
        self._next_handle = 0
        self.staged = deque()            # [request, next row] awaiting slots
        self.carry = None
        self._scrub = np.zeros(B, bool)  # budget-evicted slots to force-done
        self.segments = 0                # segments run (a measurement)

    # -- request admission ----------------------------------------------------

    def admit(self, req) -> None:
        self.staged.append([req, 0])

    @property
    def busy(self) -> bool:
        return bool(self.staged) or bool((self._slot_req >= 0).any())

    def inflight_requests(self) -> list:
        """Distinct requests with lanes in slots or staged (failure
        attribution — see EnsembleService._record_pool_failure)."""
        seen, out = set(), []
        held = [self._reqs[h] for h in np.unique(self._slot_req)
                if h >= 0]
        for req in held + [e[0] for e in self.staged]:
            if id(req) not in seen:
                seen.add(id(req))
                out.append(req)
        return out

    def evict(self, req) -> None:
        """Drop every lane of `req` from the pool (permanent failure):
        staged lanes vanish, occupied slots are freed and scheduled for a
        filler scrub so their carry columns stop costing segment work."""
        self.staged = deque(e for e in self.staged if e[0] is not req)
        for h, r in list(self._reqs.items()):
            if r is req:
                mine = self._slot_req == h
                self._slot_req[mine] = -1
                if self.carry is not None:
                    self._scrub |= mine
                del self._reqs[h]

    # -- one scheduling round -------------------------------------------------

    def _handle(self, req) -> int:
        for h, r in self._reqs.items():
            if r is req:
                return h
        h = self._next_handle
        self._next_handle += 1
        self._reqs[h] = req
        return h

    def _stage(self, slots: np.ndarray) -> None:
        """Fill free `slots` (ascending) from the staged lanes, FIFO."""
        at = 0
        while at < len(slots):
            entry = self.staged[0]
            req, row = entry
            k = min(len(slots) - at, req.n_lanes - row)
            cols = slots[at:at + k]
            rows = np.arange(row, row + k)
            self._slot_req[cols] = self._handle(req)
            self._slot_row[cols] = rows
            self._stage_u0[:, cols] = req.u0s[rows].T
            self._stage_p[:, cols] = req.ps[rows].T
            self._stage_t0[cols] = req.t0
            if self.family == "sde":
                self._stage_dt[cols] = req.dt0
                self._stage_nsteps[cols] = req.n_steps
                self._stage_lane[cols] = req.lane_offset + rows
            else:
                self._stage_tf[cols] = req.tf
                self._stage_dt0[cols] = req.dt0
            entry[1] = row + k
            if entry[1] == req.n_lanes:
                self.staged.popleft()
            at += k

    def _stage_filler(self, slots: np.ndarray) -> None:
        self._stage_t0[slots] = 0.0
        if self.family == "sde":
            self._stage_nsteps[slots] = 0
        else:
            self._stage_tf[slots] = 0.0

    def _fresh(self):
        if self.family == "sde":
            return self.engine.fresh(self._stage_u0, self._stage_p,
                                     self._stage_t0, self._stage_dt,
                                     self._stage_nsteps, self._stage_lane)
        return self.engine.fresh(self._stage_u0, self._stage_p,
                                 self._stage_t0, self._stage_tf,
                                 self._stage_dt0)

    def pump(self) -> bool:
        """Refill free slots from the staged queue, advance one segment,
        harvest retired lanes.  Returns True if the pool did work."""
        if not self.busy:
            return False
        free = np.flatnonzero(self._slot_req < 0)
        waiting = sum(e[0].n_lanes - e[1] for e in self.staged)
        fill = free[:waiting]
        self._stage(fill)
        # budget-evicted columns with no refill this round get a
        # one-iteration filler, so a never-done column stops consuming
        # full segments
        scrub = free[waiting:][self._scrub[free[waiting:]]]
        self._stage_filler(scrub)
        self._scrub[:] = False
        mask = np.zeros(self.B, bool)
        mask[fill] = True
        mask[scrub] = True
        if self.carry is None:
            self.carry = self._fresh()
            mask[:] = False
            refill = self.carry
        else:
            refill = self._fresh() if mask.any() else self.carry
        self.carry = self.engine.step_segment(self.carry, mask, refill)
        self.segments += 1
        self._harvest()
        return True

    def _harvest(self) -> None:
        c = self.carry
        held = self._slot_req >= 0
        done = _host(c["done"])
        attempts = _host(c["naccept"]).astype(np.int64)
        if "nreject" in c:
            attempts = attempts + _host(c["nreject"])
        budget = np.zeros(self.B, np.int64)
        for h in np.unique(self._slot_req[held]):
            budget[self._slot_req == h] = self._reqs[h].max_iters
        out = np.flatnonzero(held & (done | (attempts >= budget)))
        if out.size == 0:
            return
        h = {k: _host(c[k]) for k in ("u", "nf", "status", "event_t",
                                      "event_count")}
        t_final = _host(c["t_out"] if "t_out" in c else c["t"])
        nreject = (_host(c["nreject"]) if "nreject" in c
                   else np.zeros(self.B, np.int64))
        naccept = _host(c["naccept"])
        status = _finalize_status(h["status"], done)
        finished = []
        for hd in np.unique(self._slot_req[out]):
            req = self._reqs[hd]
            cols = out[self._slot_req[out] == hd]
            if req.record_rows(self._slot_row[cols], dict(
                    u_final=h["u"][:, cols].T, t_final=t_final[cols],
                    naccept=naccept[cols], nreject=nreject[cols],
                    nf=h["nf"][cols], status=status[cols],
                    event_t=h["event_t"][cols],
                    event_count=h["event_count"][cols])):
                finished.append(req)
            self._slot_req[cols] = -1
        # over-budget lanes: free the slot now, force-retire the carry
        # column next pump so it stops consuming segment work
        self._scrub[out[~done[out]]] = True
        live = set(np.unique(self._slot_req[self._slot_req >= 0]).tolist())
        staged = {id(e[0]) for e in self.staged}
        for hd in list(self._reqs):
            if hd not in live and id(self._reqs[hd]) not in staged:
                del self._reqs[hd]
        if self.on_complete is not None:
            for req in finished:
                self.on_complete(req)


class BatchPool:
    """Coalesced one-shot batches for non-resumable methods."""

    def __init__(self, spec, prob, *, solve_kwargs: dict,
                 on_complete: Optional[Callable] = None):
        self.spec = spec
        self.prob = prob
        self.solve_kwargs = dict(solve_kwargs)
        self.on_complete = on_complete
        self.staged = []

    def admit(self, req) -> None:
        self.staged.append(req)

    @property
    def busy(self) -> bool:
        return bool(self.staged)

    def inflight_requests(self) -> list:
        return list(self.staged)

    def evict(self, req) -> None:
        self.staged = [r for r in self.staged if r is not req]

    def pump(self) -> bool:
        if not self.staged:
            return False
        # staged is cleared only after the solve succeeds: a pump exception
        # leaves the batch intact for the service's retry/fail ladder
        reqs = list(self.staged)
        u0s = np.concatenate([r.u0s for r in reqs], axis=0)
        ps = np.concatenate([r.ps for r in reqs], axis=0)
        N = u0s.shape[0]
        ep = EnsembleProblem(self.prob, N, u0s=torch.from_numpy(u0s),
                             ps=torch.from_numpy(ps))
        res = solve_ensemble_local(ep, alg=self.spec, **self.solve_kwargs)
        self.staged = []
        naccept = np.broadcast_to(_host(res.naccept), (N,))
        nreject = np.broadcast_to(_host(res.nreject), (N,))
        attempts = naccept.astype(np.int64) + nreject.astype(np.int64)
        total_att = max(int(attempts.sum()), 1)
        u_final = _host(res.u_final)
        t_final = np.broadcast_to(_host(res.t_final), (N,))
        # per-lane when the engine reports it: one tenant's failing lane must
        # not mark the whole coalesced batch failed
        status_rows = np.broadcast_to(_host(res.status), (N,))
        nf, njac, nfact = (int(_host(v)) for v in
                           (res.nf, res.njac, res.nfact))
        off = 0
        for req in reqs:
            k = req.n_lanes
            sl = slice(off, off + k)
            # ensemble-total counters attributed by attempt share (estimate)
            share = int(attempts[sl].sum()) / total_att
            req.record_rows(np.arange(k), dict(
                u_final=u_final[sl], t_final=t_final[sl],
                naccept=naccept[sl], nreject=nreject[sl],
                nf=np.full(k, int(round(nf * share / k))),
                status=status_rows[sl], event_t=np.full(k, np.inf),
                event_count=np.zeros(k, np.int64)))
            req.njac = int(round(njac * share))
            req.nfact = int(round(nfact * share))
            off += k
            if self.on_complete is not None:
                self.on_complete(req)
        return True
