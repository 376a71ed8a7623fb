"""Autotuned dispatch, ``ensemble="auto"`` — `repro.core.autotune` in
PyTorch: pick strategy, backend and lane_tile from measured time.

The paper's Fig. 4-6 crossovers (kernel overtakes array overtakes vmap as
N grows) move with method, state size n, ensemble size N, dtype and
device.  ``ensemble="auto"`` resolves them by measurement:

  1. The solve's configuration key, ``(method, n, N-bucket, dtype,
     adaptive, events, w_reuse, error_est, sensitivity, data, device)``, is
     looked up in an in-memory and JSON profile cache
     (`default_cache_path`).
  2. On a miss, the capability-pruned candidates (`candidates`: strategy x
     backend from `repro_torch.core.methods.valid_dispatch`, the torch
     kernel strategy over a `lane_tile` ladder) are timed on the real
     problem at reduced N and a short horizon: the median of k wall times,
     each taken after `torch.cuda.synchronize` (`measure`).
  3. The winner is persisted, so every later call, in any process (each
     rank of a sharded `repro_torch.core.api.solve_ensemble` included),
     dispatches straight to it with one dict lookup of overhead.

Cache location: ``~/.cache/repro/autotune.json`` (under
``XDG_CACHE_HOME`` where it is set), or ``REPRO_AUTOTUNE_CACHE``, or the
``cache_path=`` argument.  An entry is invalidated by construction when
the device changes (the card's name is part of the key) and at lookup when
the recorded ``torch.__version__`` differs.  ``REPRO_AUTOTUNE=0`` turns
timing off: ``"auto"`` then takes the static default, kernel/cuda, which
runs on the card, or its plain version where the caller asked for the CPU,
as the front door does for ``backend="cuda"``.

The CUDA kernels take no launch geometry (one trajectory a thread, a fixed
block), so kernel/cuda is one candidate; the reference's VMEM-sized
lane_tile ladder has no counterpart, and the torch kernel strategy's tiles
are a fixed ladder (`LANE_TILE_LADDER`) clamped to the ensemble.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

try:
    import fcntl
except ImportError:          # non-POSIX: single-process semantics only
    fcntl = None

import numpy as np
import torch

from .interp import data_signature
from .methods import BACKENDS, STRATEGIES, MethodSpec, valid_dispatch
from .problem import EnsembleProblem

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
DISABLE_ENV = "REPRO_AUTOTUNE"
CACHE_VERSION = 1

# tuning cost knobs (env-overridable)
TUNE_MAX_N = int(os.environ.get("REPRO_AUTOTUNE_MAX_N", "4096"))
TUNE_REPEATS = int(os.environ.get("REPRO_AUTOTUNE_REPEATS", "3"))
TUNE_HORIZON_FRAC = float(os.environ.get("REPRO_AUTOTUNE_HORIZON", "0.25"))

DEFAULT_STRATEGY = ("kernel", "cuda", None)   # the static default
# trajectories per tile of the torch kernel strategy, clamped to N (at
# most TUNE_MAX_N by default).  On an H100 a tile of 256 ran 13x (Lorenz)
# and 17x (ROBER) slower than one of 4096 at 4096 lanes: the lanes
# engine's loop is launch-bound below ~1024
LANE_TILE_LADDER = (1024, 4096)


# ---------------------------------------------------------------------------
# timing harness
# ---------------------------------------------------------------------------

def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, *args, repeats: int = 3, **kw) -> Dict[str, Any]:
    """Median-of-k wall timing with the warm-up excluded.

    One untimed call absorbs the first use's cost (a kernel's build, a
    trace); each timed repeat synchronizes the card before the clock stops,
    so an asynchronous launch cannot flatter the number.  Returns
    ``{"best", "median", "times"}`` in seconds."""
    fn(*args, **kw)
    _sync()
    times = []
    for _ in range(max(1, repeats)):
        tic = time.perf_counter()
        fn(*args, **kw)
        _sync()
        times.append(time.perf_counter() - tic)
    times.sort()
    return {"best": times[0], "median": times[len(times) // 2],
            "times": times}


# ---------------------------------------------------------------------------
# configuration key
# ---------------------------------------------------------------------------

def device_kind(device=None) -> str:
    """``"cpu"``, or ``"cuda:"`` and the card's name (spaces as ``_``);
    None is the card where there is one."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return dev.type
    return "cuda:" + torch.cuda.get_device_name(dev).replace(" ", "_")


def bucket_n(N: int) -> int:
    """Next power of two: nearby ensemble sizes share one cache entry."""
    b = 1
    while b < N:
        b *= 2
    return b


def resolved_flags(spec: MethodSpec, prob, *, adaptive, w_reuse, error_est,
                   event) -> Tuple[bool, bool, bool, str]:
    """The front door's None-means-family-default knobs as the values
    dispatch runs with, so the key does not split on spellings of one
    configuration."""
    if spec.family == "rosenbrock":
        ad = True                      # the stiff engine is always adaptive
    elif adaptive is None:
        ad = spec.family == "erk" and spec.adaptive
    else:
        ad = bool(adaptive) and spec.adaptive
    wr = spec.w_reuse if w_reuse is None else bool(w_reuse)
    ee = "none"
    if spec.family == "sde" and ad:
        if error_est is not None:
            ee = str(error_est)
        else:
            diag = getattr(prob, "noise", None) == "diagonal"
            ee = ("embedded" if ("embedded" in spec.error_est and diag)
                  else "doubling")
    return ad, event is not None, wr, ee


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def config_key(spec: MethodSpec, *, n: int, N: int, dtype, adaptive: bool,
               events: bool, w_reuse: bool, error_est: str,
               device: Optional[str] = None,
               sensitivity: Optional[str] = None,
               data_sig: str = "none") -> str:
    """The cache key: a readable ``k=v|...`` string, fields in a fixed
    order.  ``data_sig`` is the dataset's shape signature
    (`repro_torch.core.interp.data_signature`): a data-driven solve does
    not reuse the data-free profile of the same method."""
    return "|".join((
        f"method={spec.name}",
        f"n={int(n)}",
        f"N={bucket_n(int(N))}",
        f"dtype={_dtype_name(dtype)}",
        f"adaptive={bool(adaptive)}",
        f"events={bool(events)}",
        f"w_reuse={bool(w_reuse)}",
        f"error_est={error_est}",
        f"sens={sensitivity or 'none'}",
        f"data={data_sig}",
        f"device={device_kind() if device is None else device}"))


# ---------------------------------------------------------------------------
# profile cache (JSON file + in-memory layer)
# ---------------------------------------------------------------------------

_MEM: Dict[str, Dict[str, Any]] = {}   # cache-file path -> entries
_MEM_LOCK = threading.Lock()


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(base, "repro", "autotune.json")


def clear_memory_cache() -> None:
    """Drop the in-process cache layer (the JSON file stays)."""
    with _MEM_LOCK:
        _MEM.clear()


def _read_file_entries(path: str) -> Dict[str, Any]:
    """The entries on disk, never the in-memory layer's."""
    entries: Dict[str, Any] = {}
    try:
        with open(path) as fh:
            data = json.load(fh)
        if isinstance(data, dict) and data.get("version") == CACHE_VERSION:
            entries = dict(data.get("entries", {}))
    except (OSError, ValueError):
        pass
    return entries


def _load_entries(path: str) -> Dict[str, Any]:
    with _MEM_LOCK:
        if path in _MEM:
            return _MEM[path]
    entries = _read_file_entries(path)
    with _MEM_LOCK:
        return _MEM.setdefault(path, entries)


def _save_entries(path: str, entries: Dict[str, Any]) -> None:
    """Persist `entries`, merged with concurrent writers: under an
    `fcntl.flock` on a sidecar lock file the file is read again, its
    entries taken under ours (ours win a tie) and the union replaces it
    atomically, so no writer's key is lost; the merged view also refreshes
    the in-memory layer."""
    merged = dict(entries)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        lock_fh = open(path + ".lock", "a+") if fcntl is not None else None
    except OSError:
        lock_fh = None
    try:
        if lock_fh is not None:
            try:
                fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
            except OSError:
                pass
        merged = {**_read_file_entries(path), **entries}
        payload = {"version": CACHE_VERSION, "entries": merged}
        try:
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass   # a read-only file system: the in-memory layer serves
    finally:
        if lock_fh is not None:
            lock_fh.close()          # releases the flock
    with _MEM_LOCK:
        _MEM[path] = merged


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    strategy: str
    backend: str
    lane_tile: Optional[int]

    @property
    def label(self) -> str:
        t = "" if self.lane_tile is None else f"/t{self.lane_tile}"
        return f"{self.strategy}/{self.backend}{t}"


@dataclasses.dataclass(frozen=True)
class Decision:
    """What ``ensemble="auto"`` resolved to, and why.

    source: "cache" (a profile-cache hit), "tuned" (measured by this
    call), "default" (timing disabled or impossible: the static default)
    or "only" (the pruning left one candidate: nothing to time)."""
    strategy: str
    backend: str
    lane_tile: Optional[int]
    source: str
    key: str = ""
    timings: Tuple[Tuple[str, float], ...] = ()


def lane_tile_ladder(N: int) -> Tuple[int, ...]:
    """The torch kernel strategy's tiles: `LANE_TILE_LADDER` clamped to
    N, ascending, without repeats."""
    return tuple(sorted({min(int(t), max(1, int(N)))
                         for t in LANE_TILE_LADDER}))


def _timed_path(spec: MethodSpec, c: Candidate, *, N: int, adaptive: bool,
                events: bool, linsolve: str) -> tuple:
    """The code a tuning run of `c` executes (`solve_ensemble_local`'s
    dispatch at N lanes, no saveat): candidates with one path time the same
    code.  erk: vmap, array and the torch kernel's tiles differ, save that
    fixed dt without an event runs one fixed-step loop whatever the tile;
    rosenbrock: every torch strategy is the lanes engine, vmap with the
    library LU, array one tile of N; fixed-dt sde: array and the torch
    kernel are one lanes loop over the whole ensemble; adaptive sde: vmap
    and array are one tile of N."""
    if c.backend == "cuda":
        return ("cuda",)
    tile = N if c.strategy != "kernel" else min(int(c.lane_tile or N), N)
    if spec.family == "erk":
        if c.strategy == "kernel" and not adaptive and not events:
            return ("kernel_fixed",)
        return (c.strategy, tile)
    if spec.family == "rosenbrock":
        return ("lanes", tile, "torch" if c.strategy == "vmap" else linsolve)
    if not adaptive:
        return ("vmap",) if c.strategy == "vmap" else ("lanes",)
    return ("lanes", tile)


def candidates(spec: MethodSpec, *, N: int, adaptive: bool, events: bool,
               w_reuse: bool, error_est: str, sensitivity=None,
               data: bool = False, linsolve: str = "torch"):
    """The capability-pruned candidates, each a distinct code path: each is
    accepted by `solve_ensemble_local` (a combination that raises is never
    timed), and of the candidates that run the same code at N lanes
    (`_timed_path`) only the first is kept.  ``array_eager`` is never a
    candidate: it exists to reproduce dispatch overhead, not to win.
    `sensitivity` prunes what the AD rules refuse, `data` the methods that
    declare ``data_rhs=False``; N clamps the torch kernel strategy's
    ladder.  (The reference's candidates also take the state, parameter and
    save sizes, the dtype and the dataset's words, which size its VMEM
    ladder: the port's ladder does not depend on them.)"""
    ee = error_est if error_est != "none" else None
    out = []

    def ok(strategy, backend):
        valid, _ = valid_dispatch(spec, strategy, backend, adaptive=adaptive,
                                  events=events, w_reuse=w_reuse,
                                  error_est=ee, sensitivity=sensitivity,
                                  data=data)
        return valid

    for strategy in ("vmap", "array"):
        if ok(strategy, "torch"):
            out.append(Candidate(strategy, "torch", None))
    if ok("kernel", "torch"):
        out.extend(Candidate("kernel", "torch", t)
                   for t in lane_tile_ladder(N))
    if ok("kernel", "cuda"):
        out.append(Candidate("kernel", "cuda", None))
    seen, distinct = set(), []
    for c in out:
        path = _timed_path(spec, c, N=N, adaptive=adaptive, events=events,
                           linsolve=linsolve)
        if path not in seen:
            seen.add(path)
            distinct.append(c)
    return distinct


# ---------------------------------------------------------------------------
# resolve
# ---------------------------------------------------------------------------

def _disabled() -> bool:
    return os.environ.get(DISABLE_ENV, "1").lower() in ("0", "off", "false",
                                                        "disabled")


def _tuning_slice(u0s, ps, N: int):
    """An evenly strided subsample of the ensemble (parameter sweeps are
    usually ordered: a head slice would tune on a corner)."""
    full = u0s.shape[0]
    if N >= full:
        return u0s, ps
    idx = torch.as_tensor(np.linspace(0, full - 1, N).round().astype(int),
                          device=u0s.device)
    return u0s[idx], ps[idx]


def _seed_of(seed, key) -> int:
    if seed is not None:
        return int(seed)
    if key is None:
        return 0
    return int(np.asarray(key).reshape(-1)[-1])


def resolve_auto(eprob: EnsembleProblem, spec: MethodSpec, *, t0=None,
                 tf=None, dt0=1e-2, saveat=None, rtol=1e-6, atol=1e-6,
                 adaptive=None, n_steps=None, save_every=1, max_iters=100_000,
                 event=None, key=None, seed=None, noise_table=None,
                 error_est=None, w_reuse=None, linsolve="torch",
                 sensitivity=None, device=None,
                 cache_path: Optional[str] = None,
                 repeats: Optional[int] = None) -> Decision:
    """Resolve ``ensemble="auto"`` to a (strategy, backend, lane_tile)
    `Decision`: a cache hit, a fresh measurement or the static default.
    Takes the front door's keywords (``device`` is where the solve runs,
    None the card)."""
    from .ensemble import resolve_device, solve_ensemble_local
    dev = resolve_device(device)
    prob = eprob.prob
    u0s, ps = eprob.materialize()
    t0 = prob.tspan[0] if t0 is None else t0
    tf = prob.tspan[1] if tf is None else tf
    N, n = u0s.shape
    ad, ev, wr, ee = resolved_flags(spec, prob, adaptive=adaptive,
                                    w_reuse=w_reuse, error_est=error_est,
                                    event=event)
    pdata = getattr(prob, "data", None)
    ckey = config_key(spec, n=n, N=N, dtype=u0s.dtype, adaptive=ad,
                      events=ev, w_reuse=wr, error_est=ee,
                      sensitivity=sensitivity, device=device_kind(dev),
                      data_sig=data_signature(pdata))
    path = cache_path or default_cache_path()

    # 1. the cache; a cached winner that predates an AD request is checked
    # against the sensitivity rules and re-tuned where they refuse it
    hit = _load_entries(path).get(ckey)
    if hit is not None and hit.get("torch") == torch.__version__:
        sens_ok, _ = valid_dispatch(spec, hit["strategy"], hit["backend"],
                                    adaptive=ad, events=ev, w_reuse=wr,
                                    error_est=ee if ee != "none" else None,
                                    sensitivity=sensitivity)
        if sens_ok:
            return Decision(hit["strategy"], hit["backend"], hit["lane_tile"],
                            source="cache", key=ckey)

    # 2. timing off -> the static default
    if _disabled() or dt0 is None:
        return Decision(*DEFAULT_STRATEGY, source="default", key=ckey)

    # 3. the candidates
    N_t = min(N, TUNE_MAX_N)
    cands = candidates(spec, N=N_t, adaptive=ad, events=ev, w_reuse=wr,
                       error_est=ee, sensitivity=sensitivity,
                       data=pdata is not None, linsolve=linsolve)
    if not cands:
        return Decision(*DEFAULT_STRATEGY, source="default", key=ckey)
    if len(cands) == 1:
        c = cands[0]
        return Decision(c.strategy, c.backend, c.lane_tile, source="only",
                        key=ckey)

    # 4. the reduced problem: the real RHS and parameters, a strided
    # subsample of N, a short horizon
    u0s_t, ps_t = _tuning_slice(u0s, ps, N_t)
    sub = EnsembleProblem(prob, N_t, u0s=u0s_t, ps=ps_t)
    span = float(tf) - float(t0)
    fixed_dt = spec.family in ("sde", "erk") and not ad
    tune_kw = dict(t0=t0, rtol=rtol, atol=atol, adaptive=adaptive,
                   max_iters=min(max_iters, 20_000), event=event,
                   seed=_seed_of(seed, key), error_est=error_est,
                   w_reuse=w_reuse, linsolve=linsolve, device=dev)
    if fixed_dt:
        ns_full = n_steps if n_steps is not None else max(
            1, int(round(span / float(dt0))))
        ns = max(1, int(round(ns_full * TUNE_HORIZON_FRAC)))
        tune_kw.update(dt0=dt0, n_steps=ns, save_every=ns, saveat=None,
                       tf=float(t0) + ns * float(dt0))
    else:
        tf_t = float(t0) + max(span * TUNE_HORIZON_FRAC,
                               min(span, 16.0 * float(dt0)))
        tune_kw.update(dt0=dt0, saveat=None, tf=tf_t, n_steps=None)

    # 5. time each candidate: the median of k, the card synchronized.  A
    # candidate that fails raises: every candidate is a valid dispatch, so a
    # failure (a kernel that does not build or launch) is a fault, never a
    # reason to tune another path
    k = TUNE_REPEATS if repeats is None else repeats
    timings = []
    for c in cands:
        def run(_c=c):
            return solve_ensemble_local(sub, alg=spec, ensemble=_c.strategy,
                                        backend=_c.backend,
                                        lane_tile=_c.lane_tile,
                                        **tune_kw).u_final
        timings.append((c, measure(run, repeats=k)["median"]))
    winner, _ = min(timings, key=lambda ct: ct[1])

    # 6. persist
    entry = {"strategy": winner.strategy, "backend": winner.backend,
             "lane_tile": winner.lane_tile, "torch": torch.__version__,
             "tuned_at_N": int(N_t),
             "timings": {c.label: t for c, t in timings}}
    entries = dict(_load_entries(path))
    entries[ckey] = entry
    _save_entries(path, entries)
    return Decision(winner.strategy, winner.backend, winner.lane_tile,
                    source="tuned", key=ckey,
                    timings=tuple((c.label, t) for c, t in timings))


def broadcast_decision(dec: Decision, group=None) -> Decision:
    """Agreement across the ranks of a `torch.distributed` process group:
    rank 0's decision wins everywhere, so every rank of a sharded solve
    dispatches one program whatever its own timings said.  Without an
    initialized group (or with one rank) the decision is returned as it
    is."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized() or \
            dist.get_world_size(group) == 1:
        return dec
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    payload = torch.tensor([STRATEGIES.index(dec.strategy),
                            BACKENDS.index(dec.backend),
                            -1 if dec.lane_tile is None
                            else int(dec.lane_tile)], dtype=torch.int64,
                           device=dev)
    src = 0 if group is None or group is dist.group.WORLD \
        else dist.get_global_rank(group, 0)
    dist.broadcast(payload, src=src, group=group)
    got = payload.tolist()
    return Decision(STRATEGIES[got[0]], BACKENDS[got[1]],
                    None if got[2] < 0 else got[2], source=dec.source,
                    key=dec.key)
