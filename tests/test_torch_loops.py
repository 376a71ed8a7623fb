"""The bounded, checkpointed loops (`repro_torch.core.loops`) and the
engines' bounded forms, on the CPU in float64.

Contracts held here (the reference's, `repro.core.loops`):
  * `solver_loop` with a bound that covers the iteration count, and
    `checkpointed_fori` at any segment length, equal the plain loops bit
    for bit (same body calls, same order);
  * every engine's bounded form (the erk lanes and array loops, the
    Rosenbrock lanes loop eager and lazy, the adaptive SDE loop, the
    fixed-dt remat paths) equals its while form bit for bit, and a bound
    too small reports ``status == 1``;
  * the memory proxy of `tests/test_grad_parity.py::
    test_checkpointing_bounds_reverse_memory`: on a 4096-step fixed-dt
    Lorenz solve, the bytes autograd keeps at the backward pass's peak
    (the segment carries plus the largest segment's saved tensors, counted
    with `torch.autograd.graph.saved_tensors_hooks`) under the default
    ``checkpoint_every`` are under a quarter of one segment of
    ``n_steps + 1``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import de_problems as tdp
from repro_torch.core import loops
from repro_torch.core.controller import STATUS_MAX_ITERS
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.problem import EnsembleProblem
from repro_torch.core.rosenbrock import solve_rosenbrock
from repro_torch.core.sde import (SDE_EMBEDDED, SDE_STEPPERS,
                                  sde_solve_adaptive, sde_solve_fixed)
from repro_torch.core.solvers import AdaptiveOptions, solve_adaptive
from repro_torch.core.tableaus import get_rosenbrock_tableau, get_tableau
from repro_torch.kernels.em.ref import ref_solve



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The inputs are a few lanes: one intra-op thread a process keeps the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def _lorenz_lanes(B=4, seed=0):
    rng = np.random.default_rng(seed)
    u0 = torch.tensor(np.array([-8.0, 7.0, 27.0])
                      + 0.1 * rng.standard_normal((B, 3))).T.contiguous()
    p = torch.tensor(np.array([10.0, 28.0, 8.0 / 3.0])
                     + 0.05 * rng.standard_normal((B, 3))).T.contiguous()
    return u0, p


# ---------------------------------------------------------------------------
# the loop primitives
# ---------------------------------------------------------------------------

def _toy():
    """A lanes body whose finished lanes are exact no-ops: each lane halves
    until it drops below its own threshold."""
    x0 = torch.tensor([5.0, 40.0, 0.3, 1000.0], dtype=torch.float64)
    thr = torch.tensor([1.0, 0.5, 1.0, 2.0], dtype=torch.float64)

    def body(c):
        active = ~c["done"]
        x = torch.where(active, c["x"] * 0.5 + 0.01, c["x"])
        return dict(x=x, done=c["done"] | (x < thr),
                    n=c["n"] + active.to(torch.int32), iters=c["iters"] + 1)

    c0 = dict(x=x0, done=x0 < thr, n=torch.zeros(4, dtype=torch.int32),
              iters=0)
    return body, c0


def test_solver_loop_bounded_equals_while_bitwise():
    body, c0 = _toy()
    ref = loops.solver_loop(lambda c: not bool(c["done"].all()), body, c0)
    iters = ref["iters"]
    for K, every in ((iters, None), (iters + 5, None), (3 * iters, 2),
                     (iters, iters), (iters + 1, 1)):
        out = loops.solver_loop(None, body, c0, bounded_steps=K,
                                checkpoint_every=every)
        assert torch.equal(out["x"], ref["x"])
        assert torch.equal(out["n"], ref["n"]) and bool(out["done"].all())
        # at least K applications, in whole segments
        e = loops._every(K, every)
        assert out["iters"] == e * -(-K // e)


def test_solver_loop_too_small_bound_leaves_lanes_running():
    body, c0 = _toy()
    out = loops.solver_loop(None, body, c0, bounded_steps=2)
    assert not bool(out["done"].all())
    with pytest.raises(ValueError, match="positive"):
        loops.solver_loop(None, body, c0, bounded_steps=0)


@pytest.mark.parametrize("lo,hi,every", [(0, 10, None), (3, 20, 4),
                                         (0, 7, 7), (2, 9, 100), (5, 5, 2)])
def test_checkpointed_fori_same_indices_same_order(lo, hi, every):
    seen = []

    def body(i, c):
        seen.append(i)
        return c * 1.5 + i

    x = torch.tensor([0.25], dtype=torch.float64, requires_grad=True)
    out = loops.checkpointed_fori(lo, hi, body, x, checkpoint_every=every)
    want = x
    for i in range(lo, hi):
        want = want * 1.5 + i
    assert seen == list(range(lo, hi))
    assert torch.equal(out, want)
    if hi > lo:
        g, = torch.autograd.grad(out.sum(), x)
        assert float(g) == 1.5 ** (hi - lo)


def test_default_checkpoint_every_is_sqrt():
    assert loops.default_checkpoint_every(4096) == 64
    assert loops.default_checkpoint_every(10) == 3
    assert loops.default_checkpoint_every(0) == 1


# ---------------------------------------------------------------------------
# the engines' bounded forms equal their while forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg,lanes,event", [("tsit5", True, False),
                                              ("dopri5", True, False),
                                              ("tsit5", False, False),
                                              ("tsit5", True, True)])
def test_erk_bounded_equals_while_bitwise(alg, lanes, event):
    tab = get_tableau(alg)
    if event:
        prob = tdp.bouncing_ball_problem()
        u0 = prob.u0[:, None].repeat(1, 3) * torch.tensor([1.0, 0.9, 1.1])
        p = prob.p[:, None].repeat(1, 3)
        f, ev, tf, sv = prob.f, tdp.bouncing_ball_event(), 3.0, [1.0, 3.0]
    else:
        u0, p = _lorenz_lanes()
        f, ev, tf, sv = tdp.lorenz_rhs, None, 1.0, [0.5, 1.0]
    sv = torch.tensor(sv, dtype=torch.float64)
    kw = dict(rtol=1e-8, atol=1e-8)
    ref = solve_adaptive(f, tab, u0, p, 0.0, tf, 1e-2, saveat=sv,
                         opts=AdaptiveOptions(**kw), event=ev, lanes=lanes)
    r0 = ref[0] if ev is not None else ref
    K = int((r0.naccept + r0.nreject).max()) + 3
    out = solve_adaptive(f, tab, u0, p, 0.0, tf, 1e-2, saveat=sv,
                         opts=AdaptiveOptions(bounded_steps=K, **kw),
                         event=ev, lanes=lanes)
    assert _same(tuple(ref), tuple(out))
    small = solve_adaptive(f, tab, u0, p, 0.0, tf, 1e-2, saveat=sv,
                           opts=AdaptiveOptions(bounded_steps=K // 2, **kw),
                           event=ev, lanes=lanes)
    s0 = small[0] if ev is not None else small
    assert int(s0.status.max()) == STATUS_MAX_ITERS


@pytest.mark.parametrize("alg,w_reuse,linsolve", [
    ("rosenbrock23", None, "torch"), ("rodas5p", None, "lanes"),
    ("rodas4", True, "torch"), ("rodas5p", True, "lanes")])
def test_rosenbrock_bounded_equals_while_bitwise(alg, w_reuse, linsolve):
    rtab = get_rosenbrock_tableau(alg)
    prob = tdp.rober_problem()
    B = 3
    u0 = prob.u0[:, None].repeat(1, B)
    p = prob.p[:, None].repeat(1, B) * torch.tensor([1.0, 0.8, 1.3])
    kw = dict(rtol=1e-6, atol=1e-8, saveat=torch.tensor([1.0, 10.0],
                                                         dtype=torch.float64),
              jac=prob.jac, w_reuse=w_reuse, linsolve=linsolve)
    ref = solve_rosenbrock(prob.f, rtab, u0, p, 0.0, 10.0, 1e-6, **kw)
    K = int((ref.naccept + ref.nreject).max()) + 2
    out = solve_rosenbrock(prob.f, rtab, u0, p, 0.0, 10.0, 1e-6,
                           bounded_steps=K, **kw)
    assert _same(tuple(ref), tuple(out))
    small = solve_rosenbrock(prob.f, rtab, u0, p, 0.0, 10.0, 1e-6,
                             bounded_steps=4, **kw)
    assert int(small.status.max()) == STATUS_MAX_ITERS


@pytest.mark.parametrize("est", ["embedded", "doubling"])
def test_adaptive_sde_bounded_equals_while_bitwise(est):
    prob = tdp.gbm_problem(r=0.05, v=0.2, dtype=torch.float64)
    B = 5
    u0 = torch.ones((3, B), dtype=torch.float64)
    p = prob.p[:, None].repeat(1, B)
    kw = dict(seed=3, lane_idx=torch.arange(B), m_noise=3,
              saveat=torch.tensor([0.5, 1.0], dtype=torch.float64),
              rtol=1e-3, atol=1e-5, lanes=True, depth=10, order=0.5,
              error_est=est,
              embedded=SDE_EMBEDDED["em"].fn if est == "embedded" else None)
    ref = sde_solve_adaptive(prob.f, prob.g, SDE_STEPPERS["em"], "diagonal",
                             u0, p, 0.0, 1.0, 0.05, **kw)
    K = int((ref.naccept + ref.nreject).max()) + 2
    out = sde_solve_adaptive(prob.f, prob.g, SDE_STEPPERS["em"], "diagonal",
                             u0, p, 0.0, 1.0, 0.05, bounded_steps=K,
                             checkpoint_every=3, **kw)
    assert _same(tuple(ref), tuple(out))
    small = sde_solve_adaptive(prob.f, prob.g, SDE_STEPPERS["em"],
                               "diagonal", u0, p, 0.0, 1.0, 0.05,
                               bounded_steps=3, **kw)
    assert int(small.status.max()) == STATUS_MAX_ITERS


@pytest.mark.parametrize("event", [False, True])
def test_sde_fixed_remat_paths_equal_plain_bitwise(event):
    prob = tdp.gbm_problem(r=0.05, v=0.2, dtype=torch.float64)
    N = 6
    u0s = torch.full((N, 3), 1.0, dtype=torch.float64)
    ps = prob.p[None].repeat(N, 1)
    kw = dict(t0=0.0, dt=1.0 / 24, n_steps=24, method="em", save_every=6,
              seed=5, lane_offset=2,
              event=tdp.gbm_barrier_event() if event else None)
    ref = ref_solve(prob, u0s, ps, **kw)
    for every in (None, 5, 24):
        out = ref_solve(prob, u0s, ps, remat=True, checkpoint_every=every,
                        **kw)
        assert _same(ref, out)
    ep = EnsembleProblem(prob, N, u0s=u0s, ps=ps)
    fkw = dict(alg="em", t0=0.0, dt0=1.0 / 24, n_steps=24, save_every=6,
               seed=5, device="cpu", event=kw["event"])
    plain = tsolve(ep, ensemble="vmap", **fkw)
    adj = tsolve(ep, ensemble="vmap", sensitivity="adjoint", **fkw)
    assert _same(tuple(plain), tuple(adj))


def test_fixed_rk_and_key_sde_remat_equal_plain_bitwise():
    u0, p = _lorenz_lanes()
    from repro_torch.core.solvers import solve_fixed
    tab = get_tableau("tsit5")
    ref = solve_fixed(tdp.lorenz_rhs, tab, u0, p, 0.0, 0.01, 40, 10)
    for every in (None, 3, 41):
        out = solve_fixed(tdp.lorenz_rhs, tab, u0, p, 0.0, 0.01, 40, 10,
                          remat=True, checkpoint_every=every)
        assert _same(tuple(ref), tuple(out))
    prob = tdp.gbm_problem(r=0.05, v=0.2, dtype=torch.float64)
    a = sde_solve_fixed(prob, prob.u0, prob.p, 0.0, 0.05, 20, 7,
                        save_every=5)
    b = sde_solve_fixed(prob, prob.u0, prob.p, 0.0, 0.05, 20, 7,
                        save_every=5, remat=True)
    assert _same(tuple(a), tuple(b))


# ---------------------------------------------------------------------------
# the reverse-memory proxy
# ---------------------------------------------------------------------------

def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _peak_saved_bytes(monkeypatch, run):
    """Run `run()` (forward and backward) with every checkpointed segment
    executed eagerly under its own `saved_tensors_hooks` frame: a
    non-reentrant checkpoint keeps its inputs through the forward pass and,
    in the backward pass, one segment's recomputed saves at a time, so its
    peak is the sum of all segments' input carries plus the largest
    segment's saves."""
    carries, frames = [], []

    def counting_remat(fn, *args):
        carries.append(sum(t.numel() * t.element_size()
                           for t in _tensors(args)))
        frame = [0]

        def pack(t):
            frame[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(*args)
        frames.append(frame[0])
        return out

    monkeypatch.setattr(loops, "_remat", counting_remat)
    run()
    return sum(carries) + max(frames)


def test_checkpointing_bounds_reverse_memory(monkeypatch):
    """The counterpart of the reference's compiled-memory proxy: the
    sqrt-checkpointed adjoint keeps under a quarter of what one segment of
    n_steps + 1 keeps, on a 4096-step fixed-dt Lorenz solve."""
    ep = tdp.lorenz_ensemble(4, dtype=torch.float64)
    u0s, ps = ep.materialize()
    n_steps = 4096

    def make(every):
        def run():
            p = ps.clone().requires_grad_(True)
            res = tsolve(EnsembleProblem(ep.prob, 4, u0s=u0s, ps=p),
                         alg="tsit5", ensemble="kernel", backend="torch",
                         t0=0.0, tf=1.0, adaptive=False, n_steps=n_steps,
                         save_every=n_steps, sensitivity="adjoint",
                         checkpoint_every=every, device="cpu")
            torch.autograd.grad((res.u_final ** 2).sum(), p)
        return run

    sqrt_ck = _peak_saved_bytes(monkeypatch, make(None))
    one_seg = _peak_saved_bytes(monkeypatch, make(n_steps + 1))
    assert sqrt_ck * 4 < one_seg, (sqrt_ck, one_seg)
