"""The serving front end: async submit/poll over the slot pools — the port
of `repro.serve.service`.

`EnsembleService` is a single-process continuous-batching server for DE
ensembles (the "solver as a service" shape of the paper's throughput story)
on one device (`resolve_device`: the card unless the caller asks for the
CPU):

* **submit** is non-blocking: it validates the request, assigns a GLOBAL
  `lane_offset` (the counter-RNG stream base — results are bitwise those of a
  fresh `solve_ensemble_local(..., seed=service.seed, lane_offset=<assigned>)`),
  pushes the request onto the `repro_torch.dist.fault.WorkQueue` (leases +
  generation tokens: a pump that dies mid-request loses its lease and the
  request is re-served), and returns a `Ticket`.
* **coalescing**: requests are routed to pools by capability key.  Resumable
  methods (erk, fixed-dt sde) share a `SlotPool` per
  (problem, method, n, n_params, dtype, adaptive, rtol, atol, event) — time
  spans, step sizes and step counts ride IN the carry, so heterogeneous
  requests fill the same slots and run the lanes engine.  Non-resumable
  methods coalesce into one-shot `BatchPool` solves keyed on the full solver
  signature, ``backend`` included: ``backend="cuda"`` runs the batch on the
  hand-written kernels (the stiff kernel, the adaptive SDE kernel).
* **pump/drain** advance the pools: `pump()` runs one scheduling round
  (admit staged requests, one bounded segment per busy slot pool, one batch
  per staged batch pool); `drain()` pumps until quiet.  `start()` runs the
  pump loop on a background thread for true submit-from-anywhere serving.
* **backpressure**: `submit` raises `Backpressure` once `max_pending`
  requests are in flight — callers retry after polling tickets.
* **accounting**: per-tenant nf/njac/nfact and lane totals, folded from the
  per-lane counts every engine reports — plus a `failures` counter and
  `last_error` string per tenant, so an operator can tell
  degraded-but-serving (failures climbing, requests still completing) from
  healthy without scraping logs.
* **failure isolation**: a pool pump that raises (bad RHS, a kernel that
  fails to build or launch) marks the affected requests failed-once and
  retries them on later pumps; past `max_request_retries` the request is
  failed PERMANENTLY — its ticket gets `error` set (result stays None),
  capacity is released, and the other tenants' requests keep serving.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.ensemble import resolve_device
from repro_torch.core.methods import get_method
from repro_torch.dist.fault import WorkQueue


class Backpressure(RuntimeError):
    """Raised by submit() when the service is at max_pending requests."""


@dataclass
class ServeResult:
    """Final-state result of one served request (serving has no dense-output
    path: snapshots belong to offline solves)."""
    u_final: np.ndarray      # (N, n)
    t_final: np.ndarray      # (N,)
    naccept: np.ndarray      # (N,)
    nreject: np.ndarray      # (N,)
    nf: int
    njac: int
    nfact: int
    status: int              # max over lanes (0 ok, 1 budget, 2 dtmin)
    event_t: np.ndarray      # (N,) located event times (inf = no event)
    event_count: np.ndarray  # (N,)


# the per-lane fields a pool records, and their dtypes (u_final and the
# times take the request's state dtype)
ROW_FIELDS = {"naccept": np.int64, "nreject": np.int64, "nf": np.int64,
              "status": np.int64, "event_count": np.int64}


@dataclass
class SolveRequest:
    """One ensemble solve in flight.  Internal to the service.

    u0s (N, n) and ps (N, k) are host numpy.  Finished lanes are recorded
    into per-request arrays (`record_rows`, vectorized over lanes), so a
    request of 2^14 lanes costs its slot pool no Python loop a lane."""
    prob: Any
    alg: str
    u0s: np.ndarray
    ps: np.ndarray
    t0: float
    tf: float
    dt0: float
    n_steps: Optional[int]
    adaptive: Optional[bool]
    rtol: float
    atol: float
    max_iters: int
    event: Any
    tenant: str
    lane_offset: int
    n_lanes: int
    backend: str = "torch"
    njac: int = 0
    nfact: int = 0
    failures: int = 0        # pump exceptions that hit this request
    _rows: Optional[dict] = None
    _n_done: int = 0
    _wq_lease: Optional[tuple] = None

    def record_rows(self, rows, res: dict) -> bool:
        """Store finished lanes `rows` (an index array) with their fields
        (`res`: u_final (k, n), t_final, event_t and every key of
        ROW_FIELDS, each (k,)); True when the request is complete."""
        rows = np.asarray(rows, np.int64)
        if self._rows is None:
            N, n = self.n_lanes, self.u0s.shape[1]
            dt = self.u0s.dtype
            self._rows = dict(
                u_final=np.zeros((N, n), dt), t_final=np.zeros(N, dt),
                event_t=np.full(N, np.inf, dt),
                **{k: np.zeros(N, v) for k, v in ROW_FIELDS.items()})
        for k, arr in self._rows.items():
            arr[rows] = res[k]
        self._n_done += len(rows)
        return self._n_done == self.n_lanes

    def assemble(self) -> ServeResult:
        r = self._rows
        return ServeResult(
            u_final=r["u_final"], t_final=r["t_final"],
            naccept=r["naccept"], nreject=r["nreject"],
            nf=int(r["nf"].sum()), njac=self.njac, nfact=self.nfact,
            status=int(r["status"].max()), event_t=r["event_t"],
            event_count=r["event_count"])


class Ticket:
    """Async handle returned by submit(): poll `done`, read `result`."""

    def __init__(self, req: SolveRequest):
        self._req = req
        self._event = threading.Event()
        self.result: Optional[ServeResult] = None
        self.error: Optional[str] = None
        self.submitted_at = time.monotonic()
        self.completed_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request completes (background-thread serving)."""
        return self._event.wait(timeout)

    @property
    def latency(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def _complete(self, result: ServeResult) -> None:
        self.result = result
        self.completed_at = time.monotonic()
        self._event.set()

    def _fail(self, error: str) -> None:
        """Permanent failure: `done` goes True with `result` None and
        `error` holding the last pump exception."""
        self.error = error
        self.completed_at = time.monotonic()
        self._event.set()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class EnsembleService:
    """Continuous-batching DE ensemble server (single device, many tenants).

    seed          — the service-global RNG seed: every SDE request draws the
                    (seed; step, global lane, row) Threefry stream at its
                    assigned lane_offset, so any served result can be
                    reproduced offline bitwise.
    max_pending   — in-flight request cap; submit raises Backpressure beyond.
    slot_width    — lanes per SlotPool (its fixed width).
    segment_steps — solver attempts per pump segment: the
                    retire-latency / dispatch-overhead knob.
    device        — where every pool runs (None: the card).
    """

    def __init__(self, seed: int = 0, max_pending: int = 64,
                 slot_width: int = 8, segment_steps: int = 64,
                 queue_timeout: float = 300.0, max_request_retries: int = 2,
                 device=None):
        self.seed = int(seed)
        self.max_pending = int(max_pending)
        self.slot_width = int(slot_width)
        self.segment_steps = int(segment_steps)
        self.max_request_retries = int(max_request_retries)
        self.device = resolve_device(device)
        self._wq = WorkQueue(timeout=queue_timeout)
        self._pools: Dict[tuple, Any] = {}
        self._tickets: Dict[int, Ticket] = {}   # id(req) -> ticket
        self._inflight: Dict[int, SolveRequest] = {}  # admitted, not finished
        self._lane_counter = 0
        self._pending = 0
        self._lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.accounting: Dict[str, Dict[str, Any]] = {}

    def _acct(self, tenant: str) -> Dict[str, Any]:
        return self.accounting.setdefault(
            tenant, dict(requests=0, lanes=0, nf=0, njac=0, nfact=0,
                         failures=0, last_error=None))

    # -- submission -----------------------------------------------------------

    def submit(self, eprob, alg: str = "tsit5", *, tenant: str = "default",
               t0=None, tf=None, dt0: float = 1e-2,
               n_steps: Optional[int] = None, adaptive: Optional[bool] = None,
               rtol: float = 1e-6, atol: float = 1e-6,
               max_iters: int = 100_000, event=None,
               ensemble: str = "kernel", backend: str = "torch") -> Ticket:
        """Enqueue one ensemble solve; returns immediately with a Ticket.

        eprob: `EnsembleProblem` (u0s/ps gathered to the host here).
        Defaults mirror `solve_ensemble_local`; fixed-dt SDE requests take
        n_steps (default round((tf-t0)/dt0)).  ``backend`` reaches the
        one-shot batch solve of a non-resumable method (``"cuda"``: the
        hand-written kernels); slot pools always run the lanes engine.

        Validation (unknown method, materialization failure) happens BEFORE
        the request occupies a pending slot, so rejected submits never eat
        service capacity.
        """
        spec = get_method(alg)
        prob = eprob.prob
        u0s, ps = (_host(a) for a in eprob.materialize())
        t0 = float(prob.tspan[0] if t0 is None else t0)
        tf = float(prob.tspan[1] if tf is None else tf)
        if adaptive is None:
            adaptive = spec.adaptive if spec.family != "sde" else False
        if spec.family == "sde" and not adaptive and n_steps is None:
            n_steps = int(round((tf - t0) / dt0))
        with self._lock:
            if self._pending >= self.max_pending:
                raise Backpressure(
                    f"{self._pending} requests in flight (max_pending="
                    f"{self.max_pending}); poll tickets and retry")
            self._pending += 1
            lane_offset = self._lane_counter
            self._lane_counter += u0s.shape[0]
        req = SolveRequest(
            prob=prob, alg=spec.name, u0s=u0s, ps=ps, t0=t0, tf=tf,
            dt0=float(dt0), n_steps=n_steps, adaptive=adaptive,
            rtol=float(rtol), atol=float(atol), max_iters=int(max_iters),
            event=event, tenant=tenant, lane_offset=lane_offset,
            n_lanes=u0s.shape[0], backend=backend)
        ticket = Ticket(req)
        with self._lock:
            self._tickets[id(req)] = ticket
        self._wq.push(req)
        return ticket

    # -- routing --------------------------------------------------------------

    def _resumable(self, spec, req) -> bool:
        if not spec.resumable:
            return False
        if spec.family == "sde" and req.adaptive:
            return False  # Brownian-tree state is dt-path dependent
        return True

    def _pool_for(self, req) -> Any:
        from .slots import BatchPool, SlotPool
        spec = get_method(req.alg)
        dtype = req.u0s.dtype
        if self._resumable(spec, req):
            key = ("slot", id(req.prob), spec.name, req.u0s.shape[1],
                   req.ps.shape[1], dtype.str, bool(req.adaptive),
                   req.rtol, req.atol, id(req.event) if req.event else None)
            if key not in self._pools:
                self._pools[key] = SlotPool(
                    spec, req.prob, n=req.u0s.shape[1],
                    n_params=req.ps.shape[1], dtype=dtype,
                    width=self.slot_width, segment_steps=self.segment_steps,
                    adaptive=req.adaptive, rtol=req.rtol, atol=req.atol,
                    event=req.event, seed=self.seed, device=self.device,
                    on_complete=self._finish)
            return self._pools[key]
        # full-signature coalescing; adaptive SDE keys on lane_offset too
        # (globally indexed Brownian streams must not be re-based)
        key = ("batch", id(req.prob), spec.name, req.u0s.shape[1],
               req.ps.shape[1], dtype.str, req.t0, req.tf, req.dt0,
               req.n_steps, bool(req.adaptive), req.rtol, req.atol,
               req.max_iters, id(req.event) if req.event else None,
               req.lane_offset if spec.family == "sde" else None,
               req.backend)
        if key not in self._pools:
            kw = dict(ensemble="kernel", backend=req.backend, t0=req.t0,
                      tf=req.tf, dt0=req.dt0, n_steps=req.n_steps,
                      adaptive=req.adaptive, rtol=req.rtol, atol=req.atol,
                      max_iters=req.max_iters, event=req.event,
                      device=self.device)
            if spec.family == "sde":
                kw.update(adaptive=True, seed=self.seed,
                          lane_offset=req.lane_offset)
            self._pools[key] = BatchPool(spec, req.prob, solve_kwargs=kw,
                                         on_complete=self._finish)
        return self._pools[key]

    # -- completion -----------------------------------------------------------

    def _finish(self, req: SolveRequest) -> None:
        # idempotent: a duplicate completion (defensive — e.g. a re-admitted
        # request under a mis-set queue_timeout) must not double-account,
        # double-decrement _pending, or KeyError the pump thread
        with self._lock:
            ticket = self._tickets.pop(id(req), None)
            if ticket is None:
                return
            self._inflight.pop(id(req), None)
            self._pending -= 1
        result = req.assemble()
        acct = self._acct(req.tenant)
        acct["requests"] += 1
        acct["lanes"] += req.n_lanes
        acct["nf"] += result.nf
        acct["njac"] += result.njac
        acct["nfact"] += result.nfact
        if req._wq_lease is not None:
            idx, tok = req._wq_lease
            self._wq.complete(idx, tok)
        ticket._complete(result)

    def _fail_request(self, req: SolveRequest, error: str) -> None:
        """Permanently fail a request (retry budget exhausted): release its
        capacity and lease, set the ticket's error.  Idempotent like
        `_finish`."""
        with self._lock:
            ticket = self._tickets.pop(id(req), None)
            if ticket is None:
                return
            self._inflight.pop(id(req), None)
            self._pending -= 1
        if req._wq_lease is not None:
            idx, tok = req._wq_lease
            self._wq.complete(idx, tok)
        ticket._fail(error)

    def _record_pool_failure(self, pool, exc: Exception) -> None:
        """A pool pump raised: charge the failure to every affected tenant,
        then retry or permanently fail the affected requests."""
        error = f"{type(exc).__name__}: {exc}"
        reqs = pool.inflight_requests()
        for req in reqs:
            req.failures += 1
            acct = self._acct(req.tenant)
            acct["failures"] += 1
            acct["last_error"] = error
        for req in reqs:
            if req.failures > self.max_request_retries:
                pool.evict(req)
                self._fail_request(req, error)

    # -- scheduling -----------------------------------------------------------

    def pump(self) -> bool:
        """One scheduling round; True if any pool still has or did work.

        Serialized: a concurrent caller (inline poll racing the background
        thread) waits for the round in progress instead of double-advancing
        the pools."""
        with self._pump_lock:
            return self._pump_locked()

    def _pump_locked(self) -> bool:
        # keep in-flight leases alive: a request being actively solved must
        # not expire (and get re-admitted) just because its solve outlasts
        # queue_timeout
        for req in list(self._inflight.values()):
            if req._wq_lease is not None:
                self._wq.renew(*req._wq_lease)
        seen = set()
        while (claim := self._wq.claim()) is not None:
            idx, req, tok = claim
            req._wq_lease = (idx, tok)
            if id(req) not in self._inflight:
                self._inflight[id(req)] = req
                self._pool_for(req).admit(req)
            elif idx in seen:
                # queue_timeout shorter than this claim loop: every claim
                # re-leases the same in-flight item — stop; the token stored
                # above is already the freshest generation
                break
            seen.add(idx)
        worked = False
        for key, pool in list(self._pools.items()):
            try:
                worked = pool.pump() or worked
            except Exception as exc:     # degraded, not down: other pools
                self._record_pool_failure(pool, exc)   # keep serving
                worked = True
            if key[0] == "batch" and not pool.busy:
                # batch pools are one-shot; drop them so per-request keys
                # (adaptive-SDE lane_offset) don't accumulate forever
                del self._pools[key]
        return worked or any(p.busy for p in self._pools.values()) \
            or not self._wq.finished

    def drain(self) -> None:
        """Pump until every submitted request has completed."""
        while self.pump():
            pass

    def poll(self, ticket: Ticket) -> Optional[ServeResult]:
        """Non-blocking result check (pump once if serving inline)."""
        if not ticket.done and self._thread is None:
            self.pump()
        return ticket.result

    # -- background serving ---------------------------------------------------

    def start(self) -> None:
        """Serve on a background thread: submit from anywhere, wait() tickets."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.pump():
                    time.sleep(0.002)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
