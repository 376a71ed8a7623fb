#!/usr/bin/env python3
"""Holds the four ensemble kernels bit for bit to an earlier build of them,
on one NVIDIA H100.

    python3 tools/parent_check.py --parent DIR [--n N] [--moved-ok SOURCES]

DIR holds another checkout's `src/repro_torch/csrc` (for example the parent
commit's, unpacked with `git archive <commit> src/repro_torch/csrc`).  The
tool builds the explicit-RK (K1), Rosenbrock (K3), fixed-dt SDE (K4) and
adaptive SDE (K5) kernels from DIR and from this checkout, runs both builds
through the kernels' wrappers on the same inputs and prints per case
whether us, u_final, t_final and the stats are bitwise equal, and whether
every instantiation of the earlier build compiles to the same registers
and spills (nvcc's -Xptxas=-v report, keyed by `chip_smoke.ptxas_summary`'s
tags), then the card's name and power limit and one JSON object.  The
inputs are `chip_smoke.py`'s parity inputs: without events, Lorenz with
tsit5 and dopri5, adaptive and fixed dt, f64 and f32; ROBER with every
Rosenbrock method, eager and lazy W, OREGO and Van der Pol; GBM with every
stepper and the CRN sweep with em and heun_strat, f32 and f64, the counter
stream and a noise table; the adaptive SDE cases; and the event and data
forms of K3 and K5 (the f64 event and data parity cases of those two
kernels, through the front door).  A parent whose adaptive SDE entries
take no work-queue word (earlier than the queue) is called without it.
K1's f64 event and data parity cases run through the front door as K3's
and K5's do.  K2 (`run_ensemble_kernel_staged`, Python as well as K1's
build): where DIR is a checkout's `src/repro_torch/csrc`, its staged cases
(`K2_SCRIPT`) run under that checkout's `repro_torch` and under this
one's, each in a process of its own, and are compared the same way.
K6 (`lu_solve.cu`): on `chip_smoke.lu_batch`'s systems (n = 3 and 8, f64,
singular ones included) x and pivmin of the factor and resolve entries,
or of the one-shot entry where the build has no split; and the `array`
stiff path with ``linsolve="cuda"`` (ROBER, rodas4, eager and lazy W),
its us, u_final, t_final and counts, with a parent build without the
split run through the one-shot solve per stage as that parent's
Rosenbrock engine ran it.

`--moved-ok` names sources (comma-separated, with or without `.cu`) whose
registers a change moves on purpose: their moved instantiations are
reported and do not fail the check; outputs that differ still do.  Exits
non-zero where CUDA is absent, any case differs or an instantiation of
another source moved.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def k1_cases(cs, dev, n):
    import torch
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5 import kernel as K1
    out = {}
    for dtype in (torch.float64, torch.float32):
        ep = cs.lorenz_inputs(n, dtype, dev)
        u0s, ps = ep.materialize()
        u0, p = u0s.T.contiguous(), ps.T.contiguous()
        sv = torch.linspace(0.0, 1.0, 11, dtype=dtype, device=dev)
        tol = 1e-8 if dtype == torch.float64 else 1e-6
        for alg, adaptive in (("tsit5", True), ("tsit5", False),
                              ("dopri5", True)):
            out[(str(dtype)[6:], "lorenz", alg, str(adaptive))] = \
                lambda u0=u0, p=p, sv=sv, alg=alg, adaptive=adaptive, \
                tol=tol, f=ep.prob.f: K1.erk_ensemble(
                    f, get_tableau(alg), u0, p, sv, t0=0.0, tf=1.0,
                    dt0=1e-3, rtol=tol, atol=tol, adaptive=adaptive,
                    max_iters=100_000)
    return out


def k3_cases(cs, dev, n):
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels.rosenbrock import kernel as K3
    out = {}
    for name, ep, kw, _ in cs.stiff_parity_cases(dev, n):
        kw = dict(kw)
        alg, wr = kw.pop("alg"), kw.pop("w_reuse", False)
        u0s, ps = ep.materialize()
        sv = kw.pop("saveat").to(dev)
        out[("float64",) + tuple(name.split())] = \
            lambda u0=u0s.T.contiguous(), p=ps.T.contiguous(), sv=sv, \
            alg=alg, wr=wr, kw=kw, prob=ep.prob: K3.rosenbrock_ensemble(
                prob.f, get_rosenbrock_tableau(alg), u0, p, sv, jac=prob.jac,
                max_iters=100_000, w_reuse=wr, **kw)
    return out


def k4_cases(cs, dev, n):
    import torch
    from repro_torch.kernels.em import kernel as K4
    cases = [("gbm", alg, 200, 200) for alg in ("em", "heun_strat",
                                                 "platen_w2", "milstein")]
    cases += [("crn", alg, 1000, 100) for alg in ("em", "heun_strat")]
    out = {}
    for dtype in (torch.float32, torch.float64):
        for name, alg, n_steps, save_every in cases:
            ep = cs.sde_inputs(name, n, dtype, dev)
            prob, m = ep.prob, ep.prob.noise_dim()
            u0s, ps = ep.materialize()
            dt = 1.0 / 200 if name == "gbm" else 0.1
            gen = torch.Generator().manual_seed(cs.SEED)
            table = torch.randn((n_steps, m, n), generator=gen,
                                dtype=dtype).to(dev)
            for src in ("rng", "table"):
                out[(str(dtype)[6:], name, alg, src)] = \
                    lambda prob=prob, alg=alg, u0=u0s.T.contiguous(), \
                    p=ps.T.contiguous(), m=m, dt=dt, n_steps=n_steps, \
                    save_every=save_every, \
                    table=table if src == "table" else None: K4.sde_ensemble(
                        prob.f, prob.g, alg, u0, p, noise=prob.noise,
                        m_noise=m, t0=0.0, dt=dt, n_steps=n_steps,
                        save_every=save_every, seed=cs.SDE_SEED, table=table)
    return out


def k5_cases(cs, dev, n):
    import torch
    from repro_torch.kernels.em import adaptive as K5
    cases = [("gbm", "em", "embedded"), ("gbm", "em", "doubling"),
             ("gbm", "milstein", "embedded"), ("gbm", "milstein", "doubling"),
             ("gbm", "heun_strat", "doubling"),
             ("gbm", "platen_w2", "doubling"), ("crn", "em", "doubling")]
    out = {}
    for dtype in (torch.float64, torch.float32):
        for name, alg, est in cases:
            ep = cs.sde_inputs(name, n, dtype, dev)
            st = dict(cs.ADAPTIVE_SETTINGS[name])
            sv = torch.tensor(st.pop("saveat"), dtype=dtype, device=dev)
            args = cs.adaptive_args(alg, est, ep.prob.noise,
                                    ep.prob.noise_dim(), seed=cs.SDE_SEED,
                                    lane_offset=2 ** 32 - 20
                                    if name == "crn" else 0, **st)
            u0s, ps = ep.materialize()
            out[(str(dtype)[6:], name, alg, est)] = \
                lambda prob=ep.prob, alg=alg, u0=u0s.T.contiguous(), \
                p=ps.T.contiguous(), sv=sv, args=args: \
                K5.sde_adaptive_ensemble(prob.f, prob.g, alg, u0, p, sv,
                                         **args)
    return out


def event_data_cases(cs, dev, n):
    """The f64 event and data parity cases of K1, K3 and K5, through the
    front door."""
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.em import adaptive as K5
    from repro_torch.kernels.rosenbrock import kernel as K3
    from repro_torch.kernels.tsit5 import kernel as K1
    out = {}
    labels = {"erk": "K1", "rosenbrock": "K3", "sde_adaptive": "K5",
              K1: "K1", K3: "K3", K5: "K5"}
    for name, family, ep, kw in cs.event_parity_cases(dev, n):
        if family in labels:
            out[(labels[family], "float64", "event") + tuple(name.split())] \
                = lambda ep=ep, kw=kw: _front(solve_ensemble_local, ep, kw,
                                              dev)
    for name, mod, ep, kw, _, _ in cs.data_parity_cases(dev, n):
        if mod in labels:
            out[(labels[mod], "float64", "data") + tuple(name.split())] = \
                lambda ep=ep, kw=kw: _front(solve_ensemble_local, ep, kw, dev)
    return out


# K2's staged cases, each run by the `repro_torch` of a checkout's src in a
# process of its own (K2 is Python as well as K1's build): tsit5 on
# `chip_smoke.lorenz_inputs`, save grid arange(1, 9) / 8 given on the
# host, three launches, fixed dt 2^-10 and adaptive, f64 and f32, and
# dopri5 adaptive in f64.
K2_SCRIPT = r"""
import sys
import torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chip_smoke as cs
from repro_torch.core.tableaus import get_tableau
from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
dev = torch.device("cuda", 0)
out = {}
for dtype in (torch.float64, torch.float32):
    ep = cs.lorenz_inputs(int(sys.argv[4]), dtype, dev)
    u0s, ps = ep.materialize()
    grid = torch.arange(1, 9, dtype=torch.float64) / 8.0
    for alg, adaptive in (("tsit5", False), ("tsit5", True),
                          ("dopri5", True)):
        if alg == "dopri5" and dtype == torch.float32:
            continue
        r = solve_ensemble_cuda(ep.prob, u0s, ps, get_tableau(alg), 0.0,
                                1.0, 2.0 ** -10, grid, 1e-8, 1e-8, adaptive,
                                save_chunks=3)
        out["/".join(("K2", str(dtype)[6:], alg, str(adaptive)))] = [
            x.cpu() for x in (r.us, r.u_final, r.t_final, r.naccept,
                              r.nreject, r.nf, r.status)]
torch.save(out, sys.argv[3])
"""


def k2_cases(src: Path, n: int) -> dict:
    """{case: outputs} of K2's staged cases under `src`'s repro_torch."""
    import subprocess
    import torch
    path = ROOT / "build" / f"parent_check_k2_{abs(hash(str(src)))}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, "-c", K2_SCRIPT, str(ROOT), str(src),
                    str(path), str(n)], check=True)
    out = torch.load(path)
    path.unlink()
    return out


def _has_split():
    from repro_torch.kernels import build
    from repro_torch.kernels.lu.kernel import SOURCE
    return "lu_factor_launch" in (build.CSRC / SOURCE).read_text()


def _one_shot_linsolve():
    """The lu ops patched to solve each stage with the one-shot kernel, as
    a Rosenbrock engine without the split did: the factorization is W
    itself, each resolve `batched_solve`, the lazy-W select a where on W."""
    import contextlib
    import torch
    from repro_torch.kernels.lu import ops
    patches = {"factor": lambda W, pivot=True: W,
               "resolve": lambda W, b: ops.batched_solve(W, b.T).T,
               "select": lambda mask, new, old: torch.where(
                   mask[:, None, None], new, old)}

    @contextlib.contextmanager
    def patched():
        saved = {k: getattr(ops, k) for k in patches}
        for k, v in patches.items():
            setattr(ops, k, v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(ops, k, v)
    return patched()


def k6_cases(cs, dev, n):
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.lu import kernel as K6
    out = {}
    for size in (3, 8):
        Wn, bn = cs.lu_batch(size, cs.FULL_N)
        W = torch.from_numpy(Wn).to(dev)
        bl = torch.from_numpy(bn).to(dev).T.contiguous()

        def solve(W=W, bl=bl):
            if _has_split():
                lu, piv, pm = K6.lu_factor(W)
                return K6.lu_resolve(lu, piv, bl), pm
            return K6.lu_solve(W.permute(1, 2, 0).contiguous(), bl)
        out[("float64", f"n={size}", "lu")] = solve
    ep = cs.rober_inputs(n, dev)
    for wr in (False, True):
        kw = dict(cs.ROBER_SETTINGS, alg="rodas4", ensemble="array",
                  device=dev, linsolve="cuda", w_reuse=wr,
                  saveat=torch.tensor(cs.ROBER_SAVEAT, dtype=torch.float64))

        def path(kw=kw):
            import contextlib
            with (contextlib.nullcontext() if _has_split()
                  else _one_shot_linsolve()):
                r = solve_ensemble_local(ep, **kw)
            return (r.us, r.u_final, r.t_final, r.naccept, r.nreject, r.njac,
                    r.nfact)
        out[("float64", "array", "rodas4", "lazyW" if wr else "eager")] = path
    return out


def _front(solve, ep, kw, dev):
    res = solve(ep, ensemble="kernel", backend="cuda", device=dev, **kw)
    return (res.us, res.u_final, res.t_final, res.naccept, res.nreject,
            res.status)


def _without_queue(binder):
    """A binder whose entry drops the work-queue word (the second-to-last
    argument) for a build whose C entries do not take it."""
    import functools

    @functools.lru_cache(maxsize=None)
    def bind(*a):
        fn = binder(*a)
        fn.argtypes = list(fn.argtypes[:-2]) + list(fn.argtypes[-1:])
        return lambda *args: fn(*args[:-2], args[-1])
    return bind


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the earlier checkout's src/repro_torch/csrc")
    ap.add_argument("--n", type=int, default=4096,
                    help="trajectories per case (default 4096)")
    ap.add_argument("--moved-ok", default="",
                    help="sources whose registers may move (comma-separated)")
    args = ap.parse_args()
    moved_ok = {x if x.endswith(".cu") else f"{x}.cu"
                for x in args.moved_ok.split(",") if x}
    import torch
    if not torch.cuda.is_available():
        print("parent_check: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.em import adaptive as K5
    from repro_torch.kernels.em import kernel as K4
    from repro_torch.kernels.lu import kernel as K6
    from repro_torch.kernels.rosenbrock import kernel as K3
    from repro_torch.kernels.tsit5 import kernel as K1

    dev = torch.device("cuda", 0)
    cases = {}
    for label, make in (("K1", k1_cases), ("K3", k3_cases), ("K4", k4_cases),
                        ("K5", k5_cases), ("K6", k6_cases)):
        cases.update({(label,) + k: v for k, v in make(cs, dev,
                                                       args.n).items()})
    cases.update(event_data_cases(cs, dev, args.n))
    here = build.CSRC
    results, regs = {}, {}
    sources = ["erk_ensemble.cu", "rosenbrock_ensemble.cu", "sde_ensemble.cu",
               "sde_adaptive_ensemble.cu", "lu_solve.cu"]
    k5_bind = K5._bind
    for label, csrc in (("parent", args.parent.resolve()), ("this", here)):
        build.CSRC = csrc
        build.load.cache_clear()
        for binder in (K1._bind, K1._bind_data, K1._bind_staged, K3._bind,
                       K4._bind, K4._bind_event, K4._bind_data, k5_bind,
                       K6._bind, K6._bind_split):
            binder.cache_clear()
        # a parent from before the work queue takes no queue word
        K5._bind = (k5_bind if "void* queue" in (csrc / K5.SOURCE).read_text()
                    else _without_queue(k5_bind))
        for src in sources:
            # rebuild, so that the register report is this build's
            build.library_path(src).unlink(missing_ok=True)
        logs = build.build(sources)
        regs[label] = {src: sorted(cs.ptxas_summary(logs[src], src))
                       for src in sources}
        results[label] = {k: run() for k, run in cases.items()}
        torch.cuda.synchronize(dev)
    build.CSRC = here
    K5._bind = k5_bind
    # K2: the parent checkout's Python and build against this checkout's
    parent_src = args.parent.resolve().parents[1]
    if (parent_src / "repro_torch" / "__init__.py").exists():
        for label, src in (("parent", parent_src), ("this", ROOT / "src")):
            results[label].update({tuple(k.split("/")): v for k, v in
                                   k2_cases(src, args.n).items()})
    else:
        print(f"K2: {parent_src} holds no repro_torch; its staged cases "
              "are not compared")
    moved, allowed, n_inst = [], [], 0
    for src in sources:
        new = list(regs["this"][src])
        for entry in regs["parent"][src]:
            n_inst += 1
            if entry in new:
                new.remove(entry)
            else:
                (allowed if src in moved_ok else moved).append(
                    f"{src} {entry}")
    print(f"registers: {n_inst - len(moved) - len(allowed)} of {n_inst} "
          "instantiations of the parent build unchanged"
          + "".join(f"\n  moved: {m}" for m in moved)
          + "".join(f"\n  moved (allowed by --moved-ok): {m}"
                    for m in allowed))
    for src in sorted(moved_ok):
        if src in regs["this"]:
            print(f"registers of {src} in this build: "
                  + "; ".join(regs["this"][src]))
    report, ok = {}, True
    for key, new in results["this"].items():
        old = results["parent"][key]
        same = all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                   and torch.equal(a.isnan(), b.isnan())
                   for a, b in zip(new, old))
        ok &= same
        report["/".join(key)] = same
        print(f"{'/'.join(key)}: N={args.n} bitwise equal to the parent "
              f"build: {same}")
    print(f"{sum(report.values())} of {len(report)} cases bitwise equal")
    ok &= not moved
    print(cs.gpu_line())
    print(json.dumps({"n": args.n, "bitwise_equal": report,
                      "registers_moved": moved,
                      "registers_moved_allowed": allowed, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
