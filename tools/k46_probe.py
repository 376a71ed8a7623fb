#!/usr/bin/env python3
"""Measures the batched LU kernel (K6) on the `array` stiff path's shapes
and the fixed-dt SDE kernel (K4) on its million-trajectory rows, on one
NVIDIA H100, from this checkout's sources or another checkout's.

    python3 tools/k46_probe.py [--csrc DIR] [--blocks 64,128,256]
                               [--dump DIR] [--skip k4]

DIR holds a checkout's `src/repro_torch/csrc` (default this checkout's;
for example the parent commit's, unpacked with `git archive <commit>
src/repro_torch/csrc`).  The Python wrappers are this checkout's.

K6, at 2^16 systems of n = 3 (the `array` path's launches) and at 2^20
of n = 3 and n = 8 (`chip_smoke.lu_batch`), f64:
- the one-shot entry's device time: CUDA events around 50 back-to-back
  launches of the C entry on buffers made once, over 50, and the same 50
  launches in a CUDA graph;
- `lu_solve`'s host time (`perf_counter` around the wrapper, no sync);
- what `batched_solve` adds around it: the two copies into the lane-major
  layout, the `pivmin` compare (device ms each) and the host read of the
  singular count (host ms, its sync included); and one whole call (CUDA
  events around it);
- where DIR's `lu_solve.cu` has them, the factor and resolve entries
  (`chip_smoke.k6_split_times`) and one whole `ops.resolve` call.

K4, on crn-1M-em, gbm-1M-em, gbm-1M-platen_w2, gbm-1M-em-barrier and
gbm-rate-1M-em (`chip_smoke.K4_ROWS`), f32: for each block size B of
`--blocks` a copy of DIR with `constexpr int kBlock = B` in
`sde_ensemble.cu` is built (every nvcc started together); per row the
instantiation's registers and spills, its step loop's pipe mix in the
SASS (`chip_smoke.loop_mix`, at the first block size), the kernel's ms at
each B (CUDA events, median of `--reps`) and its bound in the card's
instructions (`chip_smoke.k4_bound_instr`, from the fast paths of
`chip_smoke.f32_fast_paths`).  `--dump DIR` writes each probe's and each
row's SASS there.

`--array R` times the `array` stiff path's front door on its three
W-solve routes in turns, R rounds (`array_routes`).

`--ab DIR,DIR,...` compares builds instead: `sde_ensemble.cu` of each
csrc directory, on the K4 rows' inputs, timed in turns (each round runs
the builds in order, then in reverse; median of `--reps` rounds a
build) and held bitwise to the first build's outputs.  Then the card's
name and power limit and one JSON object.  Exits non-zero where CUDA is
absent or, with `--ab`, where outputs differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def k6_probe(cs, dev, csrc: Path) -> dict:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.lu import kernel as lu_kernel
    from repro_torch.kernels.lu import ops as lu_ops
    lib = build.load(lu_kernel.SOURCE)
    entry = lib.lu_solve_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    entry.argtypes = [i32, i32, i32, vp, vp, i32, vp, vp, vp]
    split = "lu_factor_launch" in (csrc / lu_kernel.SOURCE).read_text()
    out = {}
    for n, N in ((3, 2 ** 16), (3, 2 ** 20), (8, 2 ** 20)):
        Wn, bn = cs.lu_batch(n, N)
        W = torch.from_numpy(Wn).to(dev)
        b = torch.from_numpy(bn).to(dev)
        Wl, bl = W.permute(1, 2, 0).contiguous(), b.T.contiguous()
        x = torch.empty((n, N), dtype=W.dtype, device=dev)
        pm = torch.empty((N,), dtype=W.dtype, device=dev)

        def raw():
            rc = entry(1, n, 1, Wl.data_ptr(), bl.data_ptr(), N, x.data_ptr(),
                       pm.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"lu_solve_launch: CUDA error {rc}")

        host = []
        for _ in range(20):
            t = time.perf_counter()
            lu_kernel.lu_solve(Wl, bl)
            host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize(dev)
        sing_host = []
        for _ in range(20):
            t = time.perf_counter()
            int((~(pm > 0.0)).sum())
            sing_host.append((time.perf_counter() - t) * 1e3)
        nbytes = 8 * (n * n * N + 2 * n * N + N)
        row = {
            "one_shot_device_ms": cs.launches_ms(raw),
            "one_shot_graph_ms": cs.graph_ms(raw),
            "lu_solve_host_ms": statistics.median(host),
            "copy_W_ms": cs.launches_ms(
                lambda: W.permute(1, 2, 0).contiguous()),
            "copy_b_ms": cs.launches_ms(lambda: b.T.contiguous()),
            "pivmin_compare_ms": cs.launches_ms(lambda: ~(pm > 0.0)),
            "singular_count_host_ms": statistics.median(sing_host),
            "batched_solve_ms": cs.cuda_ms(
                lambda: lu_ops.batched_solve(W, b), 20),
            "one_shot_bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        if split:
            row["split"] = cs.k6_split_times(W, bl)
            fac = lu_ops.factor(W)
            row["ops_resolve_ms"] = cs.cuda_ms(
                lambda: lu_ops.resolve(fac, bl), 20)
        out[f"n={n},N={N}"] = row
        print(f"K6 n={n} N={N}: " + json.dumps(row), flush=True)
    return out


def variant_dir(csrc: Path, block: int) -> Path:
    from repro_torch.kernels import build
    d = build.BUILD_DIR.parent / "k46_probe" / f"b{block}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    p = d / "sde_ensemble.cu"
    text, k = re.subn(r"constexpr int kBlock = \d+;",
                      f"constexpr int kBlock = {block};", p.read_text())
    if k != 1:
        raise AssertionError(f"sde_ensemble.cu: {k} kBlock definitions")
    p.write_text(text)
    return d


def build_variants(csrc: Path, blocks):
    """{block: (csrc copy, library, ptxas report)}, every nvcc started
    together."""
    return build_dirs({bl: variant_dir(csrc, bl) for bl in blocks})


def build_dirs(dirs: dict):
    """{key: (csrc, library, ptxas report)} of `sde_ensemble.cu` in each
    csrc directory of `dirs`, every nvcc started together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.em.kernel import SOURCE
    procs = {}
    for bl, d in dirs.items():
        build.CSRC = d
        lib = build.library_path(SOURCE)
        lib.parent.mkdir(parents=True, exist_ok=True)
        lib.unlink(missing_ok=True)
        procs[bl] = (build.CSRC, lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(build.CSRC / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for bl, (d, lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed at block {bl}:\n{log}")
        out[bl] = (d, lib, log)
    return out


def k4_rows(cs, dev, N):
    """{row: (kernel(), its steps)}: the wrapper called on the smoke's
    inputs of each K4 row."""
    import numpy as np
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.kernels.em import kernel as K4
    f32 = torch.float32
    prob = dp.gbm_problem(r=1.5, v=0.2, dtype=f32)
    gbm = EnsembleProblem(
        prob, N, u0s=torch.full((N, 3), 0.1, dtype=f32, device=dev),
        ps=torch.tensor([1.5, 0.2], dtype=f32,
                        device=dev).expand(N, 2).contiguous())
    crn = cs.sde_inputs("crn", N, f32, dev)
    out = {}
    for row, ep, alg, dt, n_steps, save_every, ev in (
            ("gbm-1M-em", gbm, "em", 1 / 200, 200, 200, None),
            ("gbm-1M-platen_w2", gbm, "platen_w2", 1 / 200, 200, 200, None),
            ("crn-1M-em", crn, "em", 0.1, 1000, 100, None),
            ("gbm-1M-em-barrier", gbm, "em", 1 / 200, 200, 200,
             dp.gbm_barrier_event())):
        p = ep.prob
        u0s, ps = ep.materialize()
        u0, pp = u0s.T.contiguous(), ps.T.contiguous()
        kw = dict(noise=p.noise, m_noise=p.noise_dim(), t0=0.0, dt=dt,
                  n_steps=n_steps, save_every=save_every, seed=cs.SDE_SEED,
                  event=ev)
        out[row] = (lambda p=p, alg=alg, u0=u0, pp=pp, kw=kw:
                    K4.sde_ensemble(p.f, p.g, alg, u0, pp, **kw), n_steps)
    rate = ensemble_problem(dp.gbm_rate_problem(dtype=f32), np.ones((N, 1)),
                            np.full((N, 1), 0.2), device=dev, dtype=f32)
    out["gbm-rate-1M-em"] = (cs._data_kernel_fns(
        "gbm-rate-1M-em", rate, dict(cs.RATE_FIXED, alg="em"), 1)[0],
        cs.RATE_FIXED["n_steps"])
    return out


def k4_probe(cs, dev, csrc: Path, blocks, N, reps, dump) -> dict:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.em import kernel as K4
    build.CSRC = csrc
    fast = cs.f32_fast_paths()
    print("f32 fast paths: " + json.dumps(fast), flush=True)
    if dump:
        lib = next(build.BUILD_DIR.glob("f32_probe-*.so"))
        for name, rows in cs.sass_listings(lib).items():
            (dump / f"sass_{name}.txt").write_text(
                "\n".join(f"{a:05x} {t}" for a, _, _, t in rows))
    variants = build_variants(csrc, blocks)
    listings = cs.sass_listings(variants[blocks[0]][1])
    fns = k4_rows(cs, dev, N)
    report = {"f32_fast_paths": fast, "rows": {}}
    for row, (keys, m, _) in cs.K4_ROWS.items():
        names = [f for f in listings if all(k in f for k in keys)]
        if len(names) != 1:
            raise AssertionError(f"{len(names)} kernels match {keys}")
        loop = cs.loop_mix(listings[names[0]])
        if dump:
            (dump / f"sass_{row}.txt").write_text("\n".join(
                f"{a:05x} {t}" for a, _, _, t in listings[names[0]]))
        entry = {"loop": loop, "blocks": {}}
        fn, n_steps = fns[row]
        for bl in blocks:
            d, _, log = variants[bl]
            build.CSRC = d
            build.load.cache_clear()
            for b in (K4._bind, K4._bind_event, K4._bind_data):
                b.cache_clear()
            res = fn()
            torch.cuda.synchronize(dev)
            steps = int(res[3][0].long().sum())
            entry["blocks"][bl] = {"ptxas": cs.ptxas_entry(log, keys),
                                   "ms": cs.cuda_ms(fn, reps)}
            del res
        extra = 0
        if row == "gbm-1M-em-barrier":
            hits = int((fns[row][0]()[2] < 1.0 - 1e-6).sum())
            extra = cs.event_ops(steps=steps, reanchors=0, hits=hits,
                                 interp=3 * 3, cond=1, affect=0)
        b, pipe, times = cs.k4_bound_instr(row, steps, fast, extra)
        entry.update(active_steps=steps, bound_instr_ms=b,
                     bound_instr_pipe=pipe, bound_instr_times=times)
        ms = entry["blocks"].get(128, entry["blocks"][blocks[0]])["ms"]
        print(f"K4 {row}: " + ", ".join(
            f"block {bl}: {v['ms']:.3f} ms, {v['ptxas']}"
            for bl, v in entry["blocks"].items())
            + f"; bound in instructions {b:.4f} ms by {pipe} ("
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f"), kernel / it {ms / b:.2f}x; step loop "
            + json.dumps({k: loop[k] for k in cs.MIX_KEYS})
            + " opcodes " + json.dumps(dict(list(loop["opcodes"].items())
                                            [:24])), flush=True)
        report["rows"][row] = entry
    build.CSRC = csrc
    return report


def ab(cs, dev, dirs, N, reps) -> dict:
    """Each K4 row on the builds of `dirs` in turns; (report, all equal)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.em import kernel as K4
    fns = k4_rows(cs, dev, N)
    regs = {}
    for d, (_, _, log) in build_dirs({d: d for d in dirs}).items():
        regs[d.name] = {row: cs.ptxas_entry(log, keys)
                        for row, (keys, _, _) in cs.K4_ROWS.items()}
        spills = [e for e in cs.ptxas_summary(log, K4.SOURCE)
                  if " 0 bytes spill stores" not in e]
        print(f"A/B {d.name}: registers " + json.dumps(regs[d.name])
              + f"; instantiations that spill: {spills}", flush=True)

    def use(d):
        build.CSRC = d
        build.load.cache_clear()
        for b in (K4._bind, K4._bind_event, K4._bind_data):
            b.cache_clear()

    report, ok = {}, True
    for row, (fn, _) in fns.items():
        times = {d.name: [] for d in dirs}
        outs = {}
        for d in dirs:
            use(d)
            outs[d.name] = fn()
        ref = outs[dirs[0].name]
        same = {k: all(cs.same_bits(a, b) for a, b in zip(v, ref))
                for k, v in outs.items()}
        ok &= all(same.values())
        del outs, ref
        for _ in range(reps):
            for d in list(dirs) + list(reversed(dirs)):
                use(d)
                times[d.name].append(cs.cuda_ms(fn, 1))
        med = {k: statistics.median(v) for k, v in times.items()}
        report[row] = {"ms": med, "bitwise_to_first": same,
                       "registers": {k: v[row] for k, v in regs.items()}}
        print(f"A/B {row}: " + ", ".join(
            f"{k} {v:.3f} ms{'' if same[k] else ' (DIFFERS)'}"
            for k, v in med.items()), flush=True)
    return report, ok


def array_routes(cs, dev, rounds: int) -> dict:
    """The `array` path of `chip_smoke.phase_array_linsolve_cuda` (ROBER,
    rodas4, 2^16 lanes) through its front door on three W-solve routes,
    in turns (each round in order, then in reverse): ``linsolve="cuda"``
    as it is (one factor a W build, one resolve a stage), the same with
    every stage solved by the one-shot kernel as the engine did before
    the split (`parent_check._one_shot_linsolve`), and ``"torch"``."""
    import contextlib
    import torch
    from parent_check import _one_shot_linsolve
    from repro_torch.core.ensemble import solve_ensemble_local
    ep = cs.rober_inputs(2 ** 16, dev)
    kw = dict(cs.ROBER_SETTINGS, alg="rodas4", ensemble="array", device=dev,
              saveat=torch.tensor(cs.ROBER_SAVEAT, dtype=torch.float64))
    routes = {"cuda": ("cuda", contextlib.nullcontext),
              "cuda one-shot a stage": ("cuda", _one_shot_linsolve),
              "torch": ("torch", contextlib.nullcontext)}
    secs = {k: [] for k in routes}
    outs = {}
    for r in range(rounds + 1):
        order = list(routes) if r % 2 == 0 else list(reversed(routes))
        for name in order:
            linsolve, ctx = routes[name]
            with ctx():
                t = time.perf_counter()
                res = solve_ensemble_local(ep, linsolve=linsolve, **kw)
                cs.sync(dev)
                if r:            # the first round warms up
                    secs[name].append(time.perf_counter() - t)
            outs[name] = res
    same = all(cs.same_bits(a, b) for a, b in zip(
        (outs["cuda"].us, outs["cuda"].u_final, outs["cuda"].naccept.double()),
        (outs["cuda one-shot a stage"].us,
         outs["cuda one-shot a stage"].u_final,
         outs["cuda one-shot a stage"].naccept.double())))
    med = {k: statistics.median(v) for k, v in secs.items()}
    print("array rodas4 front door, median of "
          f"{rounds}: " + ", ".join(f"{k} {v:.3f} s" for k, v in med.items())
          + f"; the two cuda routes bitwise equal: {same}; runs "
          + json.dumps({k: [round(x, 3) for x in v] for k, v in secs.items()}),
          flush=True)
    return {"median_s": med, "runs_s": secs, "cuda_routes_bitwise": same}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path,
                    default=ROOT / "src" / "repro_torch" / "csrc")
    ap.add_argument("--blocks", default="128,64,256")
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dump", type=Path, default=None)
    ap.add_argument("--skip", default="", help="k4 or k6")
    ap.add_argument("--ab", default="",
                    help="comma-separated csrc directories to compare")
    ap.add_argument("--array", type=int, default=0,
                    help="rounds of the array path's three W-solve routes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k46_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    csrc = args.csrc.resolve()
    build.CSRC = csrc
    build.load.cache_clear()
    if args.dump:
        args.dump.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    report = {"csrc": str(csrc)}
    if args.array:
        report["array"] = array_routes(cs, dev, args.array)
    if args.ab:
        dirs = [Path(d).resolve() for d in args.ab.split(",")]
        report["ab"], ok = ab(cs, dev, dirs, args.n, args.reps)
        print(cs.gpu_line())
        print(json.dumps(report))
        return 0 if ok else 1
    if "k6" not in args.skip:
        report["k6"] = k6_probe(cs, dev, csrc)
    if "k4" not in args.skip:
        blocks = [int(b) for b in args.blocks.split(",")]
        report["k4"] = k4_probe(cs, dev, csrc, blocks, args.n, args.reps,
                                args.dump)
    print(cs.gpu_line())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
