#!/usr/bin/env python3
"""Counts the explicit-RK ensemble kernel (K1) as the card runs it, on its
million-trajectory rows, on one NVIDIA H100, from this checkout's sources
or another checkout's.

    python3 tools/k1_probe.py [--csrc DIR] [--src DIR] [--what W,...]
                              [--n N] [--reps R] [--rows A,B]

`--csrc DIR` builds another checkout's `src/repro_torch/csrc` (for
example the parent commit's, unpacked with `git archive <commit>
src/repro_torch/csrc`) under this checkout's Python wrappers; `--src DIR`
runs another checkout's `src` (its `repro_torch`, wrappers and csrc), for
`--what k2` on an earlier K2.

`--what rows` (the default):

The rows are `chip_smoke.K1_ROWS`, on `chip_smoke.py`'s inputs and
settings: lorenz-1M-f32-adaptive and -fixed, ball-1M-tsit5-events in f64
and f32, osc-1M-f32-fixed-gather, -onehot and -cubic, osc-1M-f64-adaptive,
osc-1M-tsit5-data-event and, where DIR compiles vern7,
lorenz-1M-f32-vern7-adaptive.  Each row calls the wrapper
(`kernels/tsit5/kernel.py::erk_ensemble`) directly and prints its kernel
ms (CUDA events, median of `--reps` after a warm-up), its bound in the
card's instructions (`chip_smoke.k1_work` on the run's own attempts,
accepted steps, saves and hits; `chip_smoke.k1_bound_instr` at the fast
paths of this build's SASS) and by what, the warp SIMT efficiency of its
attempts, its registers and spills and, in the event rows, the share of
accepted steps that hit.

`--what k2`: K2's staged front door (three launches) and the one-launch
front door on the smoke's parity case, with the grid given on the host
and on the card: each one's ms (CUDA events), its device ms
(`torch.profiler`) and its host ms (`chip_smoke.k2_times`).

`--what k2-profile`: where the host's time goes in K2's staged driver
(`cProfile` over 200 runs, the grid on the host).

`--what parity`: `chip_smoke.k1_parity` (every tableau against its plain
version, f64, N = 4096), reporting without failing;
`parity-contracted` the same on a copy of the csrc with every tableau
compiled `Contracting`.

Then the card's name and power limit and one JSON object.  Exits non-zero
where CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def k1_rows(cs, dev, N):
    """{row: (kernel(), saveat, t0, tf, adaptive, f64, bytes, hits,
    re-anchors)}: the wrapper on the smoke's inputs of each K1 row; `hits`
    and `re-anchors` are counts, or a function of the run's outputs."""
    import numpy as np
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.configs.de_problems import lorenz_ensemble
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels import build
    from repro_torch.kernels.tsit5 import kernel as K1
    f32, f64 = torch.float32, torch.float64
    rows = {}
    host = lorenz_ensemble(N, dtype=f32)
    u0s, ps = (x.to(dev).T.contiguous() for x in host.materialize())
    f = host.prob.f
    nbytes = lambda item, n, m, S: (item * (n * N + m * N + S + S * n * N
                                            + n * N + N) + 4 * 6 * N)
    forms = [("lorenz-1M-f32-adaptive", "tsit5", True,
              torch.linspace(0.0, 1.0, 5, dtype=f32, device=dev)),
             ("lorenz-1M-f32-fixed", "tsit5", False,
              torch.tensor([0.25, 0.5, 0.75, 1.0], dtype=f32, device=dev))]
    if (build.CSRC / K1.source_of("vern7")).exists():
        forms.append(("lorenz-1M-f32-vern7-adaptive", "vern7", True,
                      forms[0][3]))
    for row, alg, adaptive, sv in forms:
        kargs = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6,
                     adaptive=adaptive, max_iters=100_000)
        rows[row] = (lambda alg=alg, sv=sv, kargs=kargs: K1.erk_ensemble(
            f, get_tableau(alg), u0s, ps, sv, **kargs), sv, 0.0, 1.0,
            adaptive, False, nbytes(4, 3, 3, sv.numel()), 0, 0)
    # the bouncing ball (phase_event_ball)
    e64 = torch.linspace(0.75, 0.95, N, dtype=f64, device=dev)
    ts = np.linspace(0.0, 8.0, 81)
    _, impacts, _ = cs.ball_closed_form(ts, e64)
    nhits = int(impacts.sum())
    ev = dp.bouncing_ball_event()
    for label, dtype in (("f64", f64), ("f32", f32)):
        row = "ball-1M-tsit5-events" + ("-f32" if label == "f32" else "")
        tol = cs.BALL_TOL[label][0]
        e = e64.to(dtype)
        u0 = torch.stack([torch.full_like(e, 10.0), torch.zeros_like(e)])
        p = torch.stack([torch.full_like(e, 9.8), e])
        sv = torch.tensor(ts, dtype=dtype, device=dev)
        kargs = dict(t0=0.0, tf=8.0, dt0=1e-3, rtol=tol, atol=tol,
                     adaptive=True, max_iters=100_000, event=ev)
        fb = dp.bouncing_ball_problem(dtype=dtype).f
        rows[row] = (lambda fb=fb, u0=u0.contiguous(), p=p.contiguous(),
                     sv=sv, kargs=kargs: K1.erk_ensemble(
                         fb, get_tableau("tsit5"), u0, p, sv, **kargs),
                     sv, 0.0, 8.0, True, label == "f64",
                     nbytes(8 if label == "f64" else 4, 2, 2, 81), nhits,
                     nhits)
    # the data rows (phase_data_full_size)
    big = dp.forced_oscillator_problem()
    data_forms = [(f"osc-1M-f32-fixed-{mode}",
                   cs.osc_inputs(N, dev, f32, mode=mode),
                   dict(cs.TEXTURE_FIXED, alg="tsit5")) for mode in
                  ("gather", "onehot", "cubic")]
    data_forms += [
        ("osc-1M-f64-adaptive", cs.osc_inputs(N, dev, f64, prob=big,
                                              p=(2.0, 0.1)),
         dict(cs.OSC_ADAPTIVE, alg="tsit5")),
        ("osc-1M-tsit5-data-event",
         cs.osc_inputs(N, dev, f64, prob=big, p=(1.0, 0.0), u0=(0.0, 2.0),
                       scale=(0.8, 1.2)),
         dict(cs.OSC_EVENT, alg="tsit5", event=dp.osc_level_event()))]
    for row, ep, kw in data_forms:
        kernel, _ = cs._data_kernel_fns(row, ep, kw, 1)
        dtype = ep.u0s.dtype
        sv = cs.sv_of(kw, dtype, dev)
        K = int(ep.prob.data[next(iter(ep.prob.data))].values.numel())
        item = 8 if dtype == f64 else 4
        tf = kw["tf"]
        hits = ((lambda out, tf=tf: int((out[2] < tf - 1e-9).sum()))
                if "event" in kw else 0)
        rows[row] = (kernel, sv, kw["t0"], tf, kw.get("adaptive", True),
                     dtype == f64, nbytes(item, 2, 2, sv.numel())
                     + item * K, hits, 0)
    return rows


def k2_probe(cs, dev, reps):
    """K2 on `chip_smoke.phase_parity`'s staged case (Lorenz, f64, N =
    4096, fixed dt 2^-10, 8 saves, three launches), the grid given on the
    host and on the card: `chip_smoke.k2_times`."""
    import torch
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
    ep = cs.lorenz_inputs(cs.PARITY_N, torch.float64, dev)
    u0s, ps = ep.materialize()
    tab = get_tableau("tsit5")
    out = {}
    for where in ("host", "card"):
        grid = torch.arange(1, 9, dtype=torch.float64) / 8.0
        kw = dict(t0=0.0, tf=1.0, dt0=2.0 ** -10, rtol=1e-8, atol=1e-8,
                  adaptive=False,
                  saveat=grid.to(dev) if where == "card" else grid)
        out[where] = cs.k2_times(
            lambda: solve_ensemble_cuda(ep.prob, u0s, ps, tab,
                                        save_chunks=3, **kw),
            lambda: solve_ensemble_cuda(ep.prob, u0s, ps, tab,
                                        save_chunks=1, **kw), reps)
        print(f"K2, grid on the {where}: " + json.dumps(out[where]),
              flush=True)
    # the marginal launch: the staged driver at 1 to 8 segments, grid on
    # the host (CUDA events, median of `reps`, the counts in turns)
    grid = torch.arange(1, 9, dtype=torch.float64) / 8.0
    sweep = {c: [] for c in (1, 2, 3, 4, 8)}
    for _ in range(reps):
        for c in sweep:
            sweep[c].append(cs.cuda_ms(lambda: solve_ensemble_cuda(
                ep.prob, u0s, ps, tab, 0.0, 1.0, 2.0 ** -10, grid, 1e-8,
                1e-8, False, save_chunks=c), 1))
    out["segments_ms"] = {c: statistics.median(v) for c, v in sweep.items()}
    print("K2, ms by segments (grid on the host): "
          + json.dumps(out["segments_ms"]), flush=True)
    return out


def k2_profile(cs, dev, calls: int = 200):
    """The host's time in K2's staged driver, by function: `cProfile`
    over `calls` staged runs of `k2_probe`'s case, grid on the host."""
    import cProfile
    import io
    import pstats
    import torch
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
    ep = cs.lorenz_inputs(cs.PARITY_N, torch.float64, dev)
    u0s, ps = ep.materialize()
    grid = torch.arange(1, 9, dtype=torch.float64) / 8.0
    run = lambda: solve_ensemble_cuda(ep.prob, u0s, ps, get_tableau("tsit5"),
                                      0.0, 1.0, 2.0 ** -10, grid, 1e-8, 1e-8,
                                      False, save_chunks=3)
    run()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(25)
    print(f"K2 staged driver, host profile over {calls} runs:\n"
          + text.getvalue(), flush=True)


def contracted_copy(csrc: Path) -> Path:
    """A copy of `csrc` with every tableau of K1 compiled `Contracting`
    (`rounded = false`)."""
    import re
    import shutil
    from repro_torch.kernels import build
    d = build.BUILD_DIR.parent / "k1_probe" / "contract"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    p = d / "erk_tableaus.cu"
    p.write_text(re.sub(r"static constexpr bool rounded = true;",
                        "static constexpr bool rounded = false;",
                        p.read_text()))
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="the csrc to build (default the package's own)")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory whose repro_torch runs (default "
                         "this checkout's src; another's for --what k2)")
    ap.add_argument("--what", default="rows",
                    help="comma-separated: rows, k2, k2-profile, parity, "
                         "parity-contracted")
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows", default="",
                    help="comma-separated rows (default every K1 row)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(args.src.resolve())]
    import chip_smoke as cs
    from repro_torch.kernels import build
    if args.csrc is not None:
        build.CSRC = args.csrc.resolve()
        build.load.cache_clear()
    csrc = build.CSRC
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    what = args.what.split(",")
    report = {"csrc": str(csrc), "src": str(args.src), "n": args.n}
    if "k2" in what:
        report["k2"] = k2_probe(cs, dev, args.reps)
    if "k2-profile" in what:
        k2_profile(cs, dev)
    if "rows" in what:
        report["rows"] = rows_probe(cs, dev, csrc, args)
    for mode in ("parity", "parity-contracted"):
        if mode in what:
            if mode == "parity-contracted":
                from repro_torch.kernels.tsit5 import kernel as K1
                build.CSRC = contracted_copy(csrc)
                build.load.cache_clear()
                K1._bind.cache_clear()
            report[mode] = cs.k1_parity(dev, cs.PARITY_N,
                                        raise_on_fail=False)
            build.CSRC = csrc
    print(cs.gpu_line())
    print(json.dumps(report))
    return 0


def rows_probe(cs, dev, csrc: Path, args) -> dict:
    """Every K1 row of `k1_rows`: kernel ms, bound in instructions, SIMT
    efficiency, registers (`chip_smoke.k1_row_extra`)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tsit5 import kernel as K1
    sources = sorted({K1.source_of(t) for t in K1.TABLEAU_IDS
                      if (csrc / K1.source_of(t)).exists()})
    cs.BUILD_LOGS.update(build.build(sources))
    cs.FP64_FAST.update(cs.fp64_fast_paths())
    cs.F32_FAST.update(cs.f32_fast_paths())
    out = {}
    wanted = [r for r in args.rows.split(",") if r]
    for row, (kernel, sv, t0, tf, adaptive, f64, nbytes, hits,
              reanchors) in k1_rows(cs, dev, args.n).items():
        if wanted and row not in wanted:
            continue
        res = kernel()
        cs.sync(dev)
        ms = cs.cuda_ms(kernel, args.reps)
        st = res[3].long()
        hits = hits(res) if callable(hits) else hits
        saves, stores = cs.k1_saves(sv, t0, res[2])
        work = cs.k1_work(row, attempts=int((st[0] + st[1]).sum()),
                          accepted=int(st[0].sum()), saves=saves,
                          stores=stores, adaptive=adaptive, hits=hits,
                          reanchors=reanchors)
        print(f"{row}: kernel {ms:.3f} ms (median of {args.reps}), "
              f"attempts {int((st[0] + st[1]).sum())}", flush=True)
        extra = cs.k1_row_extra(row, ms, res[3], work, f64,
                                nbytes / cs.HBM_BYTES_PER_S * 1e3, hits)
        out[row] = dict(extra, ms=ms)
        del res
    return out


if __name__ == "__main__":
    sys.exit(main())
