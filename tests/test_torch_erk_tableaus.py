"""K1 on the six tableaus of the reference besides tsit5 and dopri5
(rkck54, bs3, rkf45, rk4, vern7, gbs10), and K2's staged driver, on the
CPU.

The kernel route's plain version (``backend="cuda"`` on CPU tensors) is
held against the reference's kernel route, its Pallas kernel run in
interpret mode: Lorenz in float64, N = 5 with a ragged lane tile, per-lane
counts identical and states within 1e-10 (rk4, fixed dt: 1e-12).  The .cu
tableau dispatch is parsed against the wrapper's ids, and the staged
driver, which now transposes once, threads u_final as it is, writes each
segment into its slice of one output and sums the counters on the device,
is held bit for bit to the assembly it replaced.  The kernel itself needs
the card: tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.de_problems import lorenz_problem as j_lorenz_problem
from repro.core import tableaus as jtab
from repro.core.ensemble import solve_ensemble_local as jsolve
from repro.core.problem import EnsembleProblem as JEnsembleProblem
from repro_torch.configs.de_problems import lorenz_problem
from repro_torch.convert import ensemble_problem
from repro_torch.core.ensemble import solve_ensemble_local as tsolve
from repro_torch.core.tableaus import get_tableau
from repro_torch.kernels.tsit5 import kernel as erk_kernel
from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
NEW = ("rkck54", "bs3", "rkf45", "rk4", "vern7", "gbs10")


def lorenz_arrays(N, seed=0):
    rng = np.random.default_rng(seed)
    u0s = np.stack([1.0 + 0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N)], axis=1)
    ps = np.stack([np.full(N, 10.0), rng.uniform(0.0, 21.0, N),
                   np.full(N, 8.0 / 3.0)], axis=1)
    return u0s, ps


def both(alg, dt0, fixed=False):
    u0s, ps = lorenz_arrays(5)
    kw = dict(ensemble="kernel", t0=0.0, tf=0.3, dt0=dt0,
              saveat=np.linspace(0.0, 0.3, 4),
              **({} if fixed else dict(rtol=1e-8, atol=1e-8)))
    want = jsolve(JEnsembleProblem(j_lorenz_problem(jnp.float64), 5,
                                   u0s=jnp.asarray(u0s), ps=jnp.asarray(ps)),
                  alg=alg, backend="pallas", lane_tile=4, **kw)
    got = tsolve(ensemble_problem(lorenz_problem(torch.float64), u0s, ps),
                 alg=alg, backend="cuda", device="cpu", **kw)
    np.testing.assert_array_equal(got.naccept.numpy(),
                                  np.asarray(want.naccept))
    np.testing.assert_array_equal(got.nreject.numpy(),
                                  np.asarray(want.nreject))
    assert int(got.nf) == int(want.nf) and int(got.status) == 0
    return got, want


@pytest.mark.parametrize("alg", NEW)
def test_kernel_route_matches_reference_on_every_tableau(alg):
    """rk4 runs at fixed dt 1e-2 (it has no error estimate); the others
    adaptive from dt0 = 2e-2, where the first steps' error estimates sit
    above the rounding level (see the next test).  Non-FSAL pairs evaluate
    f(u_new) for Hermite's dense output and count every stage an attempt,
    on both sides."""
    fixed = alg == "rk4"
    got, want = both(alg, 1e-2 if fixed else 2e-2, fixed)
    tol = 1e-12 if fixed else 1e-10
    for field in ("us", "u_final", "t_final"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=tol, atol=tol, err_msg=field)


@pytest.mark.parametrize("alg", ["vern7", "gbs10"])
def test_high_order_pairs_from_a_small_first_step(alg):
    """From dt0 = 1e-3 the first steps' error estimates of vern7 and gbs10
    sit at the rounding level, so their sizes, and the Hermite saves
    between them, follow each package's rounding (XLA fuses, the port
    rounds each operation alone): the saves differ by up to ~1e-6 (ROADMAP
    queue 3), while the counts and the end state still agree."""
    got, want = both(alg, 1e-3)
    for field in ("u_final", "t_final"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-10, atol=1e-10, err_msg=field)


def test_tableau_dispatch_matches_wrapper_ids():
    """The C dispatches' tableau ids (`by_tableau` in erk_ensemble.cu,
    `by_tableau_no_event` in erk_tableaus.cu) are the wrapper's
    TABLEAU_IDS, and those are every tableau of the reference."""
    ids = {}
    for cu, pattern in (
            ("erk_ensemble.cu",
             r"case (\d+): return event_id \? by_event<T, (\w+)>"),
            ("erk_tableaus.cu", r"case (\d+): return by_rhs<T, (\w+)>")):
        for tab_id, struct in re.findall(pattern, (CSRC / cu).read_text()):
            ids[struct.lower()] = int(tab_id)
            assert erk_kernel.source_of(struct.lower()) == cu
    assert ids == erk_kernel.TABLEAU_IDS
    assert set(erk_kernel.TABLEAU_IDS) == set(jtab.TABLEAUS)


def test_user_tableau_is_not_the_compiled_one():
    """A user tableau named like a compiled one, with other coefficients,
    is not taken for it."""
    from repro_torch.convert import tableau_from_arrays
    ref = get_tableau("bs3")
    same = tableau_from_arrays("bs3", ref.a, ref.b, ref.btilde, ref.c,
                               order=ref.order,
                               embedded_order=ref.embedded_order,
                               fsal=ref.fsal)
    other = tableau_from_arrays("bs3", ref.a, ref.b, 0.5 * ref.btilde,
                                ref.c, order=ref.order,
                                embedded_order=ref.embedded_order,
                                fsal=ref.fsal)
    assert erk_kernel._compiled(ref) and erk_kernel._compiled(same)
    assert not erk_kernel._compiled(other)


def earlier_staged(prob, u0s, ps, tab, saveat, chunks, *, t0, tf, dt0,
                   rtol, atol, adaptive, max_iters=100_000):
    """K2 as it was assembled before: a fresh grid a segment, both
    transposes each launch, the parts concatenated, each launch's counters
    reduced and then summed, the status maxed."""
    ts = saveat.numpy()
    segs = [idx for idx in np.array_split(np.arange(len(ts)), chunks)
            if idx.size]
    u, parts, acc = u0s, [], None
    for k, idx in enumerate(segs):
        seg_t0 = float(ts[idx[0] - 1]) if k else t0
        seg_tf = tf if k == len(segs) - 1 else float(ts[idx][-1])
        sv = torch.as_tensor(ts[idx], dtype=u0s.dtype)
        us, uf, t_fin, st = erk_kernel._plain(
            prob.f, tab, u.T.contiguous(), ps.T.contiguous(), sv, seg_t0,
            seg_tf, dt0, rtol, atol, adaptive, max_iters)
        u = uf.T
        parts.append(us.permute(2, 0, 1))
        now = dict(naccept=st[0], nreject=st[1], nf=st[3].sum(),
                   status=st[2].max(), t_final=t_fin)
        if acc is None:
            acc = now
        else:
            acc = dict(naccept=acc["naccept"] + now["naccept"],
                       nreject=acc["nreject"] + now["nreject"],
                       nf=acc["nf"] + now["nf"],
                       status=torch.maximum(acc["status"], now["status"]),
                       t_final=t_fin)
    return dict(acc, us=torch.cat(parts, dim=1), u_final=u)


@pytest.mark.parametrize("alg", ["tsit5", "rkck54"], ids=["fsal",
                                                          "no-fsal"])
@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_staged_driver_bitwise_to_earlier_assembly(chunks, adaptive, alg):
    """save_chunks 1 (one launch), 2 and S = 4 (a save a segment), the
    grid given as a CPU tensor; float64 Lorenz, N = 6."""
    u0s, ps = (torch.from_numpy(x) for x in lorenz_arrays(6, seed=3))
    prob = lorenz_problem(torch.float64)
    tab = get_tableau(alg)
    saveat = torch.tensor([0.25, 0.5, 0.75, 1.0], dtype=torch.float64)
    kw = dict(t0=0.0, tf=1.0, dt0=2.0 ** -6, rtol=1e-8, atol=1e-8,
              adaptive=adaptive)
    got = solve_ensemble_cuda(prob, u0s, ps, tab, saveat=saveat,
                              save_chunks=chunks, **kw)
    want = earlier_staged(prob, u0s, ps, tab, saveat, chunks, **kw)
    for field, value in want.items():
        assert torch.equal(getattr(got, field), value), field


@pytest.mark.parametrize("source,name,kind", [
    ("erk_ensemble.cu", "erk_ensemble_launch", {}),
    ("erk_ensemble.cu", "erk_ensemble_event_launch", dict(event=True)),
    ("erk_ensemble.cu", "erk_ensemble_data_launch", dict(data=True)),
    ("erk_ensemble.cu", "erk_ensemble_staged_launch", dict(staged=True)),
    ("erk_ensemble.cu", "erk_ensemble_data_staged_launch",
     dict(data=True, staged=True)),
    ("erk_tableaus.cu", "erk_tableaus_launch", {}),
    ("erk_tableaus.cu", "erk_tableaus_staged_launch", dict(staged=True)),
])
def test_c_entries_take_what_the_wrapper_passes(source, name, kind):
    """Every C entry of K1's two sources, parsed, against the ctypes types
    its binding gives it (`kernels/tsit5/kernel.py::argtypes`)."""
    import ctypes
    c_types = {"int": ctypes.c_int, "double": ctypes.c_double,
               "long long": ctypes.c_longlong}
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"{name} not found in {source}"
    args = [re.sub(r"\s+", " ", a.strip()).rsplit(" ", 1)[0]
            for a in m.group(1).split(",")]
    got = [ctypes.c_void_p if "*" in a else c_types[a] for a in args]
    assert got == erk_kernel.argtypes(**kind)
