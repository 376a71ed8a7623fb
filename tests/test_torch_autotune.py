"""Autotuned dispatch, ``ensemble="auto"`` (`repro_torch.core.autotune`),
on the CPU: the ported counterpart of each case of tests/test_autotune.py.

The key's schema, the flags' normalization, tuning then pure cache hits
(no `measure` call on the second solve, in memory or from the JSON file),
a stale ``torch.__version__`` invalidating its entry, ``"auto"`` bitwise
the explicit winner on every family (erk, rosenbrock, fixed-dt and adaptive
sde), every candidate dispatchable and the impossible combinations pruned,
the ladder, the disabled environment giving the static default
(kernel/cuda, its plain version on the CPU), and two concurrent writers
merging.  Every case tunes into a pytest tmpdir cache.  The reference's two
jit cases (a warm cache dispatching inside `jax.jit`, a cold cache under
jit falling back) have no eager-PyTorch counterpart (ROADMAP queue 3).
The sharded solve's ``"auto"`` is held in
tests/test_torch_api_distributed.py, the key's data component in
tests/test_torch_texture_data.py."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.de_problems import (gbm_problem, lorenz_ensemble,
                                             rober_ensemble)
from repro_torch.core import autotune as at
from repro_torch.core.ensemble import solve_ensemble_local
from repro_torch.core.methods import get_method, valid_dispatch
from repro_torch.core.problem import EnsembleProblem

F32, F64 = torch.float32, torch.float64
SOLVE_KW = dict(t0=0.0, tf=0.5, dt0=1e-2, adaptive=True, rtol=1e-5,
                atol=1e-5, device="cpu")


@pytest.fixture
def cache(tmp_path):
    at.clear_memory_cache()
    yield str(tmp_path / "autotune.json")
    at.clear_memory_cache()


@pytest.fixture
def counted_measure(monkeypatch):
    calls = {"n": 0}
    real = at.measure

    def counting(fn, *a, **k):
        calls["n"] += 1
        return real(fn, *a, **k)

    monkeypatch.setattr(at, "measure", counting)
    return calls


def test_config_key_deterministic_and_bucketed():
    spec = get_method("tsit5")
    kw = dict(n=3, dtype=F32, adaptive=True, events=False, w_reuse=False,
              error_est="none", device="cpu:x")
    k1 = at.config_key(spec, N=1000, **kw)
    assert k1 == at.config_key(spec, N=1000, **kw)   # deterministic
    assert k1 == at.config_key(spec, N=600, **kw)    # same power-of-2 bucket
    assert k1 != at.config_key(spec, N=5000, **kw)   # another bucket
    assert k1 != at.config_key(spec, N=1000, **dict(kw, dtype=F64))
    assert "method=tsit5" in k1 and "device=cpu:x" in k1
    assert "dtype=float32" in k1
    assert at.device_kind("cpu") == "cpu"


def test_resolved_flags_normalize_family_defaults():
    erk, rb, sde = (get_method(a) for a in ("tsit5", "rodas4", "em"))
    prob = lorenz_ensemble(4).prob
    flags = dict(adaptive=None, w_reuse=None, error_est=None, event=None)
    assert at.resolved_flags(erk, prob, **flags)[0] is True
    assert at.resolved_flags(get_method("rk4"), prob, **flags)[0] is False
    assert at.resolved_flags(rb, prob, **flags)[0] is True
    assert at.resolved_flags(sde, prob, **flags)[0] is False
    gbm = gbm_problem()
    assert at.resolved_flags(sde, gbm, **dict(flags, adaptive=True)) == (
        True, False, False, "embedded")


def test_tune_then_pure_cache_hits(cache, counted_measure):
    ep = lorenz_ensemble(32)
    spec = get_method("tsit5")
    dec = at.resolve_auto(ep, spec, cache_path=cache, repeats=1, **SOLVE_KW)
    assert dec.source == "tuned"
    assert counted_measure["n"] > 1          # several candidates were timed
    n_timed = counted_measure["n"]
    dec2 = at.resolve_auto(ep, spec, cache_path=cache, **SOLVE_KW)
    assert dec2.source == "cache" and counted_measure["n"] == n_timed
    at.clear_memory_cache()                  # a cold process: the file
    dec3 = at.resolve_auto(ep, spec, cache_path=cache, **SOLVE_KW)
    assert dec3.source == "cache" and counted_measure["n"] == n_timed
    assert (dec3.strategy, dec3.backend, dec3.lane_tile) == (
        dec.strategy, dec.backend, dec.lane_tile)
    with open(cache) as fh:
        data = json.load(fh)
    assert data["version"] == at.CACHE_VERSION
    entry = data["entries"][dec.key]
    assert entry["torch"] == torch.__version__
    assert set(entry["timings"]) == {label for label, _ in dec.timings}


def test_stale_torch_version_invalidates(cache, monkeypatch):
    ep = lorenz_ensemble(32)
    spec = get_method("tsit5")
    dec = at.resolve_auto(ep, spec, cache_path=cache, repeats=1, **SOLVE_KW)
    with open(cache) as fh:
        data = json.load(fh)
    data["entries"][dec.key]["torch"] = "0.0.stale"
    with open(cache, "w") as fh:
        json.dump(data, fh)
    at.clear_memory_cache()
    monkeypatch.setenv(at.DISABLE_ENV, "0")   # timing off: a stale entry
    dec2 = at.resolve_auto(ep, spec, cache_path=cache, **SOLVE_KW)
    assert dec2.source == "default"           # is not served as a hit


def _family_cases():
    lor = lorenz_ensemble(24)
    rob = rober_ensemble(8, tspan=(0.0, 1.0))
    gbm = EnsembleProblem(gbm_problem(), 16)
    return {
        "tsit5": (lor, dict(alg="tsit5", t0=0.0, tf=0.5, dt0=1e-2,
                            saveat=[0.25, 0.5], rtol=1e-5, atol=1e-5)),
        "rodas5p": (rob, dict(alg="rodas5p", dt0=1e-6, rtol=1e-6,
                              atol=1e-8, saveat=[0.5, 1.0])),
        "em-fixed": (gbm, dict(alg="em", t0=0.0, tf=1.0, dt0=0.05,
                               n_steps=20, save_every=10, seed=3)),
        "em-adaptive": (gbm, dict(alg="em", t0=0.0, tf=1.0, dt0=0.05,
                                  adaptive=True, rtol=1e-3, atol=1e-5,
                                  seed=3)),
    }


@pytest.mark.parametrize("family", sorted(_family_cases()))
def test_auto_bitwise_equals_explicit_winner(cache, monkeypatch, family):
    monkeypatch.setenv(at.CACHE_ENV, cache)
    ep, kw = _family_cases()[family]
    kw = dict(kw, device="cpu")
    r_auto = solve_ensemble_local(ep, ensemble="auto", **kw)
    alg = kw.pop("alg")
    dec = at.resolve_auto(ep, get_method(alg), cache_path=cache, **kw)
    assert dec.source == "cache"              # the solve above tuned it
    r_exp = solve_ensemble_local(ep, alg=alg, ensemble=dec.strategy,
                                 backend=dec.backend,
                                 lane_tile=dec.lane_tile, **kw)
    for k in ("us", "u_final", "t_final", "naccept", "nreject"):
        assert torch.equal(getattr(r_auto, k), getattr(r_exp, k)), k


def test_candidates_are_all_dispatchable():
    cases = [
        (get_method("tsit5"), dict(adaptive=True, events=False,
                                   w_reuse=False, error_est="none")),
        (get_method("rodas4"), dict(adaptive=True, events=False,
                                    w_reuse=True, error_est="none")),
        (get_method("em"), dict(adaptive=False, events=False,
                                w_reuse=False, error_est="none")),
        (get_method("em"), dict(adaptive=True, events=True,
                                w_reuse=False, error_est="embedded")),
    ]
    for spec, flags in cases:
        cands = at.candidates(spec, N=64, **flags)
        assert cands, f"no candidates for {spec.name} {flags}"
        assert sum(c.backend == "cuda" for c in cands) == 1
        for c in cands:
            assert c.strategy != "array_eager"   # never a candidate
            ok, why = valid_dispatch(
                spec, c.strategy, c.backend, adaptive=flags["adaptive"],
                events=flags["events"], w_reuse=flags["w_reuse"],
                error_est=None if flags["error_est"] == "none"
                else flags["error_est"])
            assert ok, f"{spec.name}: {c.label} invalid: {why}"
            if c.backend == "cuda":
                assert c.strategy == "kernel" and c.lane_tile is None
    # forward sensitivities ride jvp: no cuda candidate
    fwd = at.candidates(get_method("tsit5"), N=64, adaptive=True,
                        events=False, w_reuse=False, error_est="none",
                        sensitivity="forward")
    assert fwd and all(c.backend == "torch" for c in fwd)


def test_pruning_rejects_impossible_combos():
    assert at.candidates(get_method("tsit5"), N=64, adaptive=True,
                         events=False, w_reuse=True, error_est="none") == []
    assert at.candidates(get_method("heun_strat"), N=64, adaptive=True,
                         events=False, w_reuse=False,
                         error_est="embedded") == []
    assert not valid_dispatch(get_method("tsit5"), "array", "cuda")[0]
    assert not valid_dispatch(get_method("rodas4"), "array_eager")[0]
    # the erk array strategy steps with one dt: no events there
    ev = at.candidates(get_method("tsit5"), N=64, adaptive=True,
                       events=True, w_reuse=False, error_est="none")
    assert ev and all(c.strategy != "array" for c in ev)


def test_lane_tile_ladder_clamped_to_the_ensemble():
    assert at.lane_tile_ladder(1 << 20) == at.LANE_TILE_LADDER
    assert at.lane_tile_ladder(at.TUNE_MAX_N) == at.LANE_TILE_LADDER
    assert at.lane_tile_ladder(3000) == (1024, 3000)
    assert at.lane_tile_ladder(1000) == (1000,)
    assert at.lane_tile_ladder(64) == (64,)
    cands = at.candidates(get_method("tsit5"), N=64, adaptive=True,
                          events=False, w_reuse=False, error_est="none")
    assert [c.lane_tile for c in cands if c.label.startswith(
        "kernel/torch")] == [64]


_DISTINCT = {
    # (method, flags): the labels kept at 4096 lanes, one a code path
    "tsit5 adaptive": ("tsit5", dict(adaptive=True, events=False),
                       ["vmap/torch", "array/torch", "kernel/torch/t1024",
                        "kernel/torch/t4096", "kernel/cuda"]),
    # fixed dt without an event: one fixed-step loop whatever the tile
    "rk4 fixed": ("rk4", dict(adaptive=False, events=False),
                  ["vmap/torch", "array/torch", "kernel/torch/t1024",
                   "kernel/cuda"]),
    # every torch strategy is the lanes engine: vmap with the library LU
    # is array's one tile of N, as is the tile of 4096
    "rodas5p": ("rodas5p", dict(adaptive=True, events=False),
                ["vmap/torch", "kernel/torch/t1024", "kernel/cuda"]),
    # array and the torch kernel: one lanes loop over the whole ensemble
    "em fixed": ("em", dict(adaptive=False, events=False),
                 ["vmap/torch", "array/torch", "kernel/cuda"]),
    # vmap and array: one tile of N
    "em adaptive": ("em", dict(adaptive=True, events=False,
                               error_est="embedded"),
                    ["vmap/torch", "kernel/torch/t1024", "kernel/cuda"]),
}


@pytest.mark.parametrize("case", sorted(_DISTINCT))
def test_candidates_time_each_code_path_once(case):
    alg, flags, want = _DISTINCT[case]
    spec = get_method(alg)
    kw = dict(dict(w_reuse=False, error_est="none"), **flags)
    cands = at.candidates(spec, N=4096, **kw)
    assert [c.label for c in cands] == want
    paths = [at._timed_path(spec, c, N=4096, adaptive=kw["adaptive"],
                            events=kw["events"], linsolve="torch")
             for c in cands]
    assert len(set(paths)) == len(paths)


def test_a_failing_candidate_raises_and_caches_nothing(cache, monkeypatch):
    """A kernel/cuda candidate that fails (a build or launch error) is a
    fault: `resolve_auto` raises it rather than tuning a plain-PyTorch
    winner, and writes no entry."""
    from repro_torch.core import ensemble
    real = ensemble.solve_ensemble_local

    def failing(*a, **k):
        if k.get("backend") == "cuda":
            raise RuntimeError("kernel/cuda: nvcc failed")
        return real(*a, **k)

    monkeypatch.setattr(ensemble, "solve_ensemble_local", failing)
    ep = lorenz_ensemble(32)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        at.resolve_auto(ep, get_method("tsit5"), cache_path=cache,
                        repeats=1, **SOLVE_KW)
    assert not os.path.exists(cache)


def test_disabled_env_falls_back_to_static_default(cache, monkeypatch,
                                                   counted_measure):
    monkeypatch.setenv(at.DISABLE_ENV, "0")
    monkeypatch.setenv(at.CACHE_ENV, cache)
    ep = lorenz_ensemble(32)
    dec = at.resolve_auto(ep, get_method("tsit5"), cache_path=cache,
                          **SOLVE_KW)
    assert (dec.strategy, dec.backend, dec.lane_tile) == at.DEFAULT_STRATEGY
    assert dec.source == "default" and counted_measure["n"] == 0
    # the front door works end to end: kernel/cuda, its plain version on
    # the CPU, bitwise the explicit call
    r = solve_ensemble_local(ep, alg="tsit5", ensemble="auto", **SOLVE_KW)
    want = solve_ensemble_local(ep, alg="tsit5", ensemble="kernel",
                                backend="cuda", **SOLVE_KW)
    assert int(r.status) == 0 and torch.equal(r.u_final, want.u_final)
    assert not os.path.exists(cache)          # nothing was tuned


_WRITER_SCRIPT = r"""
import os, sys, time
from repro_torch.core import autotune as at

path, key, order = sys.argv[1], sys.argv[2], sys.argv[3]
sdir = os.path.dirname(path)

def wait_for(*names, timeout=60.0):
    t0 = time.monotonic()
    while not all(os.path.exists(os.path.join(sdir, n)) for n in names):
        if time.monotonic() - t0 > timeout:
            sys.exit(3)
        time.sleep(0.01)

# the lost-update shape: both processes read the (empty) file, then each
# adds its own key and replaces it; the barrier files order the saves
entries = dict(at._load_entries(path))
entries[key] = {"strategy": "kernel", "backend": "cuda", "lane_tile": None,
                "torch": "test", "tuned_at_N": 1, "timings": {}}
open(os.path.join(sdir, "ready_" + key), "w").close()
wait_for("ready_cfgA", "ready_cfgB")
if order == "second":
    wait_for("saved_first")
at._save_entries(path, entries)
if order == "first":
    open(os.path.join(sdir, "saved_first"), "w").close()
"""


def test_concurrent_writers_merge_not_last_wins(tmp_path):
    """Two processes tune different configurations: the later writer
    merges, and both entries survive in the JSON."""
    path = str(tmp_path / "autotune.json")
    src = os.path.join(os.path.dirname(at.__file__), "..", "..")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER_SCRIPT, path, key, order], env=env)
        for key, order in (("cfgA", "first"), ("cfgB", "second"))]
    for p in procs:
        assert p.wait(timeout=120) == 0
    with open(path) as fh:
        data = json.load(fh)
    assert set(data["entries"]) == {"cfgA", "cfgB"}
    at.clear_memory_cache()
    assert set(at._load_entries(path)) == {"cfgA", "cfgB"}


def test_measure_takes_the_median_after_a_warm_up():
    calls = []
    got = at.measure(lambda x: calls.append(x), 1, repeats=3)
    assert len(calls) == 4 and len(got["times"]) == 3
    assert got["best"] <= got["median"] == sorted(got["times"])[1]
    assert np.isfinite(got["median"])
