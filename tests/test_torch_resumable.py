"""The resumable segment engine (`repro_torch.core.ensemble.ResumableEngine`,
`core.solvers.erk_resume_*`, `core.sde.sde_resume_*`) against the
reference's (`repro.core.ensemble.make_resumable_engine`) on the same numpy
inputs, and its own contracts, on the CPU in float64 unless marked.

Bars (ROADMAP): adaptive erk lanes have equal per-lane naccept/nreject and
states within 1e-10; the counter-stream SDE within 3e-7 (the float32
Box–Muller normals of XLA and PyTorch differ by a few ulps), its Threefry
words bitwise.  Inside the port, bitwise: a lane stepped in segments (and
refilled mid-stream) equals a fresh `solve_ensemble_local(...,
ensemble="kernel", backend="torch")`, and a resume from an exported carry
equals a run that was never exported.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import de_problems as jdp
from repro.core.ensemble import make_resumable_engine as jengine
from repro.core.events import Event as JEvent
from repro.core.methods import get_method as jget_method
from repro.kernels import rng as jrng
from repro_torch.configs import de_problems as tdp
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import (export_resume_carry,
                                       import_resume_carry,
                                       make_resumable_engine,
                                       solve_ensemble_local)
from repro_torch.core.events import Event
from repro_torch.core.methods import get_method
from repro_torch.kernels import rng as trng

F64 = torch.float64
ADAPTIVE_TOL = 1e-10
RNG_TOL = 3e-7
CPU = dict(device="cpu")


def lorenz_arrays(N, seed=0):
    rng = np.random.default_rng(seed)
    u0s = np.array([1.0, 0.0, 0.0]) + 0.1 * rng.random((N, 3))
    ps = np.stack([np.full(N, 10.0), 21.0 * rng.random(N),
                   np.full(N, 8.0 / 3.0)], 1)
    return u0s, ps


def gbm_arrays(N, seed=1):
    rng = np.random.default_rng(seed)
    return (0.1 + 0.01 * rng.random((N, 3)),
            np.array([1.5, 0.2]) + 0.01 * rng.random((N, 2)))


def run_port(engine, carry):
    B = carry["u"].shape[-1]
    nofill = np.zeros(B, bool)
    segments = 0
    while not bool(carry["done"].all()):
        carry = engine.step_segment(carry, nofill, carry)
        segments += 1
    return carry, segments


def run_ref(engine, carry):
    B = carry["u"].shape[-1]
    nofill = np.zeros(B, bool)
    while not bool(np.all(np.asarray(carry["done"]))):
        carry = engine.step_segment(carry, nofill, carry)
    return {k: np.asarray(v) for k, v in carry.items()}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


# ---------------------------------------------------------------------------
# against the reference's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg,adaptive", [("tsit5", True), ("dopri5", True),
                                          ("rk4", False)])
def test_erk_engine_matches_reference(alg, adaptive):
    """Per-lane tf and dt0 ride in the carry: each lane's counts equal the
    reference engine's and its state agrees within 1e-10."""
    N = 16
    u0s, ps = lorenz_arrays(N)
    tf = np.linspace(0.5, 1.0, N)
    dt0 = np.full(N, 1e-2)
    kw = dict(adaptive=adaptive, rtol=1e-8, atol=1e-8, segment_steps=32)
    je = jengine(jget_method(alg), jdp.lorenz_problem(jnp.float64), **kw)
    te = make_resumable_engine(get_method(alg), tdp.lorenz_problem(F64),
                               **kw, **CPU)
    want = run_ref(je, je.fresh(jnp.asarray(u0s.T), jnp.asarray(ps.T), 0.0,
                                jnp.asarray(tf), jnp.asarray(dt0)))
    got, _ = run_port(te, te.fresh(u0s.T.copy(), ps.T.copy(), 0.0, tf, dt0))
    got = export_resume_carry(got)
    assert set(got) == set(want)
    for k in ("naccept", "nreject", "nf", "status", "done"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert rel(got["u"], want["u"]) <= ADAPTIVE_TOL
    assert rel(got["t"], want["t"]) <= ADAPTIVE_TOL


def test_erk_event_engine_matches_reference():
    """The terminal half event on linear decay: located times within the
    adaptive bar, counts equal."""
    N = 8
    lam = np.linspace(0.5, 2.0, N)
    jev = JEvent(condition=lambda u, p, t: u[0] - 0.5, terminal=True,
                 direction=-1)
    tev = Event(condition=lambda u, p, t: u[0] - 0.5, terminal=True,
                direction=-1)
    kw = dict(rtol=1e-8, atol=1e-8, segment_steps=16)
    je = jengine(jget_method("tsit5"),
                 jdp.linear_decay_problem(dtype=jnp.float64), event=jev, **kw)
    te = make_resumable_engine(get_method("tsit5"),
                               tdp.linear_decay_problem(dtype=F64),
                               event=tev, **kw, **CPU)
    u0 = np.ones((1, N))
    want = run_ref(je, je.fresh(jnp.asarray(u0), jnp.asarray(lam[None]),
                                0.0, 3.0, 1e-3))
    got, _ = run_port(te, te.fresh(u0.copy(), lam[None].copy(), 0.0, 3.0,
                                   1e-3))
    got = export_resume_carry(got)
    for k in ("naccept", "nreject", "event_count"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert rel(got["event_t"], want["event_t"]) <= ADAPTIVE_TOL
    np.testing.assert_allclose(got["event_t"], np.log(2.0) / lam, rtol=1e-6)


@pytest.mark.parametrize("alg", ["em", "platen_w2"])
def test_sde_engine_matches_reference(alg):
    """Per-lane n_steps and GLOBAL lane indices in the carry: the
    counter-stream paths agree within 3e-7, and the Threefry words a lane
    draws at its steps are the reference's bit for bit."""
    N, seed = 12, 7
    u0s, ps = gbm_arrays(N)
    n_steps = np.arange(N) % 4 * 16 + 40
    lane = np.arange(N) + 2 ** 32 - 6          # wraps past 2^32
    lane = lane % 2 ** 32
    kw = dict(seed=seed, segment_steps=24)
    je = jengine(jget_method(alg), jdp.gbm_problem(r=1.5, v=0.2,
                                                   dtype=jnp.float64), **kw)
    te = make_resumable_engine(get_method(alg),
                               tdp.gbm_problem(r=1.5, v=0.2, dtype=F64),
                               **kw, **CPU)
    want = run_ref(je, je.fresh(jnp.asarray(u0s.T), jnp.asarray(ps.T), 0.0,
                                1.0 / 64, jnp.asarray(n_steps, jnp.int32),
                                jnp.asarray(lane, jnp.uint32)))
    got, _ = run_port(te, te.fresh(u0s.T.copy(), ps.T.copy(), 0.0, 1.0 / 64,
                                   n_steps.astype(np.int32), lane))
    got = export_resume_carry(got)
    for k in ("k", "naccept", "nf", "n_steps", "done"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["lane"], want["lane"].astype(np.int64))
    assert rel(got["u"], want["u"]) <= RNG_TOL
    np.testing.assert_array_equal(got["t_out"], want["t_out"])
    steps = np.array([0, 17, 39])[:, None]
    jw = jrng.threefry2x32(seed, trng.STREAM_KEY,
                           jnp.asarray((steps * trng.STEP_STRIDE) % 2 ** 32,
                                       jnp.uint32),
                           jnp.asarray(lane[None], jnp.uint32))
    row = torch.zeros((1, 1), dtype=torch.int64)
    tw = trng.counter_words(seed, torch.tensor(steps),
                            torch.tensor(lane[None]), row)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


def test_refusals_match_reference():
    for get, make, prob, extra in (
            (jget_method, jengine, jdp.gbm_problem(), {}),
            (get_method, make_resumable_engine, tdp.gbm_problem(), CPU)):
        with pytest.raises(ValueError, match="resumable=False"):
            make(get("rodas5p"), prob, **extra)
        with pytest.raises(ValueError, match="fixed-dt only"):
            make(get("em"), prob, adaptive=True, **extra)


# ---------------------------------------------------------------------------
# inside the port, bitwise
# ---------------------------------------------------------------------------

def test_segments_and_refill_equal_fresh_solves():
    """Lanes of two requests share a 6-wide tile: the first request's lanes
    retire, the second's refill their slots through the masked merge
    mid-stream, and every lane equals a fresh kernel/torch solve of its own
    request, bit for bit."""
    u0s, ps = lorenz_arrays(10, seed=3)
    prob = tdp.lorenz_problem(F64)
    te = make_resumable_engine(get_method("tsit5"), prob, rtol=1e-7,
                               atol=1e-7, segment_steps=8, **CPU)
    B = 6
    first = te.fresh(u0s[:B].T.copy(), ps[:B].T.copy(), 0.0, 0.3, 1e-2)
    c = te.step_segment(first, np.zeros(B, bool), first)
    while not bool(c["done"].all()):
        c = te.step_segment(c, np.zeros(B, bool), c)
    done_a = export_resume_carry(c)
    # refill four of the six slots with the second request (tf 0.6)
    mask = np.array([True, False, True, True, False, True])
    stage_u = np.ones((3, B))
    stage_p = np.ones((3, B))
    stage_u[:, mask] = u0s[B:].T
    stage_p[:, mask] = ps[B:].T
    c = te.step_segment(c, mask, te.fresh(stage_u, stage_p, 0.0, 0.6, 1e-2))
    while not bool(c["done"].all()):
        c = te.step_segment(c, np.zeros(B, bool), c)
    got = export_resume_carry(c)
    for sl, tf, cols, h in ((slice(0, B), 0.3, np.arange(B), done_a),
                            (slice(B, 10), 0.6, np.flatnonzero(mask), got)):
        ref = solve_ensemble_local(
            ensemble_problem(prob, u0s[sl], ps[sl]), alg="tsit5",
            ensemble="kernel", backend="torch", t0=0.0, tf=tf, dt0=1e-2,
            rtol=1e-7, atol=1e-7, **CPU)
        np.testing.assert_array_equal(h["u"][:, cols].T, ref.u_final.numpy())
        np.testing.assert_array_equal(h["naccept"][cols], ref.naccept.numpy())
        np.testing.assert_array_equal(h["nreject"][cols], ref.nreject.numpy())
        np.testing.assert_array_equal(h["t"][cols], ref.t_final.numpy())
    # the two slots that did not refill kept the first request's lanes
    np.testing.assert_array_equal(got["u"][:, ~mask], done_a["u"][:, ~mask])


@pytest.mark.parametrize("family", ["erk", "sde"])
def test_export_import_resume_is_bitwise(family):
    """Stop after two segments, export the carry to numpy, import it back
    and finish: the result equals a run that was never exported, and the
    imported carry keeps every dtype."""
    N = 8
    if family == "erk":
        u0s, ps = lorenz_arrays(N)
        te = make_resumable_engine(get_method("tsit5"),
                                   tdp.lorenz_problem(F64), segment_steps=8,
                                   **CPU)
        args = (u0s.T.copy(), ps.T.copy(), 0.0, 1.0, 1e-2)
    else:
        u0s, ps = gbm_arrays(N)
        te = make_resumable_engine(get_method("em"),
                                   tdp.gbm_problem(r=1.5, v=0.2, dtype=F64),
                                   seed=5, segment_steps=8, **CPU)
        args = (u0s.T.copy(), ps.T.copy(), 0.0, 1.0 / 64, 40,
                np.arange(N) + 100)
    whole, _ = run_port(te, te.fresh(*args))
    c = te.fresh(*args)
    for _ in range(2):
        c = te.step_segment(c, np.zeros(N, bool), c)
    assert not bool(c["done"].all())
    host = te.export_carry(c)
    back = import_resume_carry(host, device="cpu")
    assert {k: v.dtype for k, v in back.items()} == \
        {k: v.dtype for k, v in c.items()}
    resumed, _ = run_port(te, back)
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), k


def test_done_lane_is_an_exact_noop():
    """The body on a finished carry changes none of its lanes' results.
    (Its step-size controller still runs on them, in the reference's body
    too: dt and the controller memory of a done lane are never read again
    for it, and a refill replaces them.)"""
    u0s, ps = lorenz_arrays(4)
    te = make_resumable_engine(get_method("tsit5"), tdp.lorenz_problem(F64),
                               segment_steps=64, **CPU)
    c, _ = run_port(te, te.fresh(u0s.T.copy(), ps.T.copy(), 0.0, 0.2, 1e-2))
    body = te._body
    again = body(c)
    for k in c:
        if k not in ("iters", "dt", "enorm_prev"):
            assert torch.equal(again[k], c[k]), k


def test_import_defaults_to_the_card():
    """`import_resume_carry` goes through `resolve_device`: without CUDA and
    without device='cpu' it raises instead of falling back to the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_resume_carry({"u": np.zeros((3, 2))})
