#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/` (the explicit-RK
ensemble kernel, the fixed-dt SDE kernel, the batched LU kernel and the
fused Rosenbrock stiff kernel, all nvcc processes started together), holds
each against its plain PyTorch twin on the card, drives the port's paths
through the front door (`solve_ensemble_local(ensemble="kernel",
backend="cuda")`): the paper's million-trajectory Lorenz ensemble, the
million-trajectory geometric Brownian motion (Fig. 9) and
chemical-reaction-network sweep (Figs. 10/11) SDE ensembles, and the
million-trajectory ROBER stiff ensembles (rodas5p, and rodas4 with lazy W),
plus the `array` strategy with the batched LU kernel as its linear solver,
and times each beside the twin and, except for the rodas4 stiff forms, the
`vmap` and `array` strategies.  Every phase raises on failure, so the
script exits non-zero; it also exits non-zero, printing no result, where
CUDA is absent or the port's sources are not beside it.  The last line is one JSON object naming
the device; the line before it lists every kernel with its launches on its
path, its error against the plain version, its time and its bound.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and the
# non-tensor-core FP32 and FP64 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
# The FP64 peak counts a fused multiply-add as two operations.  An add or
# multiply rounded on its own (the `_rn` intrinsics of the stiff and LU
# kernels) is one instruction at the same issue rate, so such operations
# run at half the peak at most.
PEAK_FP64_UNFUSED_OPS = PEAK_FP64_FLOPS / 2
# Integer issue limits of one H100 SXM (132 SMs, 1.98 GHz maximum boost
# clock), from the CUDA C++ Programming Guide's throughput table for compute
# capability 9.0: 32-bit funnel shifts and bitwise operations run on the ALU
# pipe only, 64 lanes per SM per clock; a 32-bit add may also issue on the
# FMA pipe (IMAD), and each SM issues at most one warp instruction per
# sub-partition per clock, 128 lanes.
SM_LANE_CLOCKS_PER_S = 132 * 1.98e9
ALU_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128

FULL_N = 2 ** 20
PARITY_N = 4096
SAMPLE_N = 4096
SEED = 0
# f32 kernel vs f64 twin, and vs the f32 twin, at rtol = atol = 1e-6, per
# element, relative to 1 + |u|: each run carries the solver's global error
# (~1e-5 here), the f32 runs add ~2^-24 per step over ~60 adaptive steps and
# decide some accepts differently, and the fixed-dt run takes 1000 f32 steps
# whose rounding of t and u the dynamics amplify.  A CPU run at N = 256 gave
# 7.8e-6 and 1.7e-4 against the f64 twin; the bars leave about 10x room.
F32_TOL = {"adaptive": 2e-4, "fixed": 2e-3}

SDE_SEED = 1234
# Normals of the kernel against the plain stream on the card: the words are
# bitwise equal; both compute Box-Muller in float32, so the normals may
# differ by a few float32 ulps where the math library's log or cos does
# (XLA-CPU and PyTorch-CPU differ by up to 4.77e-7 on 1.6e6 draws).
NORMAL_TOL = 2e-6
# f32 SDE kernel vs the f32 twin at full size, per lane: the largest
# |a - b| / (1 + |b|) over its saves, on lanes finite in both.
# gbm: every lane within 1e-5 (a CPU run at N = 4096 put the f32 twin 7.9e-7
# from the f64 twin on the same stream).
# crn: lanes near the Hill switch (exponent up to 4) amplify rounding-order
# differences over 1000 steps.  A CPU run at N = 16384 that only regrouped
# the EM update, u + (f dt + g dW), moved the median lane by 4.1e-7, the
# 99.9th percentile by 2.6e-5 and the worst lane by 1.1e-3, so the 99.9th
# percentile is held to 2.5e-4, and at most 1e-4 N lanes may exceed
# SDE_OUTLIER or be finite in one run only.  (quantile, bar) per problem.
SDE_F32_TOL = {"gbm": (1.0, 1e-5), "crn": (0.999, 2.5e-4)}
SDE_OUTLIER = 1e-2
# Threefry-2x32-20 integer instructions per normal that any compiled form
# executes on every lane: 20 rotations (funnel shifts) and 20 xors, on the
# ALU pipe only; and 26 adds (the 20 of the rounds, the 5 key injections
# into x1, and the last into x0: the other four into x0 fold into the
# following round's add as one three-input IADD3).  The counter
# step * 0x9E3779B9 + row and its key add are the same on every lane of a
# warp, and the lane's key add does not change over the steps, so none of
# them is counted.
THREEFRY_ALU_OPS = 40
THREEFRY_ADD_OPS = 26
# Float operations per normal: twice (convert, add, multiply) onto (0, 1],
# then log, multiply, sqrt, multiply, cos, multiply, and z * sqrt(dt).
NORMAL_FLOPS = 13
# Float operations per step as the kernel writes them (multiply, add,
# divide, max, sqrt and pow one each), 3 of them for t = t0 + k dt:
# gbm/em 18 + 3; gbm/platen_w2 91 + 3; crn/em 81 + 3 (drift 15 with the Hill
# term, g.dW 54 recomputing it, the update 12).
SDE_STEP_FLOPS = {("gbm", "em"): 21, ("gbm", "platen_w2"): 94,
                  ("crn", "em"): 84}

# The stiff phases.  ROBER's bar is the reference's (tests/test_stiff.py):
# rtol 1e-6, atol 1e-14 per element, and y1 + y2 + y3 = 1 within 1e-7.  The
# f64 kernel against its twin: where a lane's step counts equal the twin's,
# its states within STIFF_SAME_COUNTS_TOL of the lane's largest value.
ROBER_RTOL, ROBER_ATOL, ROBER_SUM_TOL = 1e-6, 1e-14, 1e-7
STIFF_SAME_COUNTS_TOL = 1e-10
ROBER_SAVEAT = (1e-2, 1.0, 1e2, 1e4)
ROBER_SETTINGS = dict(t0=0.0, tf=1e4, dt0=1e-6, rtol=1e-6, atol=1e-8)
# LU kernel against its plain version on non-singular systems (both round
# every product and difference on their own, so they should agree exactly)
LU_TOL = 1e-12
# Float operations of the device right-hand sides and Jacobians as
# csrc/rosenbrock_ensemble.cu writes them (each add, multiply, divide one).
STIFF_RHS_OPS = {"rober": (13, 9)}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1):
    """Median wall time of fn() on the card, by CUDA events, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over all elements."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def lorenz_inputs(N: int, dtype, device, seed: int = SEED):
    """Lorenz ensemble from a seed: u0 near (1, 0, 0), rho in (0, 21)."""
    from repro_torch.configs.de_problems import lorenz_problem
    from repro_torch.convert import ensemble_problem
    rng = np.random.default_rng(seed)
    u0s = np.stack([1.0 + 0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N),
                    0.1 * rng.standard_normal(N)], axis=1)
    ps = np.stack([np.full(N, 10.0), rng.uniform(0.0, 21.0, N),
                   np.full(N, 8.0 / 3.0)], axis=1)
    return ensemble_problem(lorenz_problem(dtype), u0s, ps, device=device,
                            dtype=dtype)


# mangled-name fragment -> tag, per source, for the ptxas report
PTXAS_TAGS = {
    "erk_ensemble.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                        ("Tsit5", "tsit5"), ("Dopri5", "dopri5"),
                        ("Lorenz", "lorenz"), ("Sho", "sho")),
    "sde_ensemble.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                        ("Gbm", "gbm"), ("Crn", "crn"), ("2EmE", "em"),
                        ("HeunStrat", "heun_strat"),
                        ("PlatenW2", "platen_w2"), ("Milstein", "milstein"),
                        ("Lb0E", "rng"), ("Lb1E", "table"),
                        ("sde_normals", "normals")),
    "lu_solve.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                    *((f"Li{k}E", f"n={k}") for k in range(1, 9)),
                    ("Lb0E", "nopivot"), ("Lb1E", "pivot")),
    "rosenbrock_ensemble.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                               ("Ros23w", "rosenbrock23"),
                               ("Rodas4", "rodas4"), ("Rodas5p", "rodas5p"),
                               ("Rober", "rober"), ("Orego", "orego"),
                               ("Vdp", "vdp"), ("Lb0E", "eager"),
                               ("Lb1E", "lazyW")),
}


def ptxas_summary(log: str, source: str):
    """One 'instantiation: registers, spills' entry per kernel in nvcc's
    -Xptxas=-v report."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1] if "'" in ln else ln
            name = ",".join([tag for key, tag in PTXAS_TAGS[source]
                             if key in mangled]) or mangled[:40]
            spill = ""
        elif "spill stores" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spill}")
            name = None
    return out


def sass_mix(lib: Path, *keys: str) -> dict:
    """Opcode counts (without modifiers or predicates) of the one kernel in
    `lib` whose mangled name holds every key, read with cuobjdump."""
    from repro_torch.kernels.build import nvcc
    tool = Path(nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, found, inside = {}, 0, False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = all(k in ln for k in keys)
            found += inside
        elif inside and ln.lstrip().startswith("/*") and ";" in ln:
            ops = ln.split("*/", 1)[1].split(";")[0].split()
            if ops and ops[0].startswith("@"):
                ops = ops[1:]
            if ops:
                op = ops[0].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    if found != 1:
        raise AssertionError(f"sass: {found} kernels in {lib.name} match "
                             f"{keys}")
    return counts


def phase_build() -> float:
    from repro_torch.kernels.build import build, library_path
    from repro_torch.kernels.em.kernel import SOURCE as SDE_SOURCE
    from repro_torch.kernels.lu.kernel import SOURCE as LU_SOURCE
    from repro_torch.kernels.rosenbrock.kernel import SOURCE as RB_SOURCE
    from repro_torch.kernels.tsit5.kernel import SOURCE
    t = time.perf_counter()
    logs = build([SOURCE, SDE_SOURCE, LU_SOURCE, RB_SOURCE])
    secs = time.perf_counter() - t
    for src, log in logs.items():
        print(f"build {src}: " + "; ".join(ptxas_summary(log, src)))
    print(f"build: {secs:.1f} s ({'compiled' if logs else 'cached'})")
    # the integer instruction mix behind the SDE kernel's bound: one normal
    # per thread in the normals kernel; 3 normals per step in f32 em/gbm
    lib = library_path(SDE_SOURCE)
    for what, keys in (("normals", ("sde_normals_kernel",)),
                       ("f32 em/gbm rng", ("sde_ensemble_kernelIf", "3Gbm",
                                           "2EmE", "Lb0E"))):
        mix = sass_mix(lib, *keys)
        ints = {op: mix.get(op, 0) for op in ("SHF", "LOP3", "PRMT", "IADD3",
                                              "IMAD")}
        print(f"sass {what}: {sum(mix.values())} instructions, integer "
              + json.dumps(ints))
    return secs


def phase_parity(device, N: int = PARITY_N):
    """f64 Lorenz, kernel against twin on the same device."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
    from repro_torch.core.tableaus import get_tableau

    ep = lorenz_inputs(N, torch.float64, device)
    saveat = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
    common = dict(t0=0.0, tf=1.0, rtol=1e-8, atol=1e-8, saveat=saveat,
                  device=device, ensemble="kernel")
    cases = [("tsit5 adaptive", dict(alg="tsit5", dt0=1e-3), 1e-10),
             ("tsit5 fixed dt=1e-3", dict(alg="tsit5", dt0=1e-3,
                                          adaptive=False), 1e-12),
             ("dopri5 adaptive", dict(alg="dopri5", dt0=1e-3), 1e-10)]
    worst = {}
    for name, kw, tol in cases:
        before = erk_kernel.launches
        rk = solve_ensemble_local(ep, backend="cuda", **common, **kw)
        rt = solve_ensemble_local(ep, backend="torch", **common, **kw)
        if device.type == "cuda" and erk_kernel.launches != before + 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        if not (torch.equal(rk.naccept, rt.naccept)
                and torch.equal(rk.nreject, rt.nreject)):
            bad = int((rk.naccept != rt.naccept).sum()
                      + (rk.nreject != rt.nreject).sum())
            raise AssertionError(f"{name}: per-lane naccept/nreject differ "
                                 f"on {bad} lanes")
        errs = (rel_err(rk.us, rt.us), rel_err(rk.u_final, rt.u_final))
        if max(errs) > tol or int(rk.status) != int(rt.status):
            raise AssertionError(f"{name}: us/u_final rel err {errs} > {tol}"
                                 f" or status {int(rk.status)} != "
                                 f"{int(rt.status)}")
        worst[name] = max(errs)
        print(f"parity {name}: N={N} f64 counts equal, rel err "
              f"us {errs[0]:.3e} u_final {errs[1]:.3e} (bar {tol:g}), "
              f"attempts {int((rk.naccept + rk.nreject).sum())}")

    # staged fixed-dt: chunk-aligned dyadic grid -> bitwise one launch
    u0s, ps = ep.materialize()
    tab = get_tableau("tsit5")
    grid = torch.arange(1, 9, dtype=torch.float64, device=device) / 8.0
    kw = dict(t0=0.0, tf=1.0, dt0=2.0 ** -10, saveat=grid, rtol=1e-8,
              atol=1e-8, adaptive=False)
    before = erk_kernel.launches
    one = solve_ensemble_cuda(ep.prob, u0s, ps, tab, save_chunks=1, **kw)
    three = solve_ensemble_cuda(ep.prob, u0s, ps, tab, save_chunks=3, **kw)
    if device.type == "cuda" and erk_kernel.launches != before + 4:
        raise AssertionError("staged run: expected 1 + 3 launches, got "
                             f"{erk_kernel.launches - before}")
    for field in ("us", "u_final", "naccept"):
        if not torch.equal(getattr(one, field), getattr(three, field)):
            raise AssertionError(f"staged fixed-dt {field} is not bitwise "
                                 "equal to the single launch")
    print(f"parity staged fixed-dt save_chunks=3: bitwise equal to one "
          f"launch (launches {erk_kernel.launches - before})")
    return worst


def attempt_flops(tab, n: int, rhs_flops: int, adaptive: bool) -> int:
    """Floating-point operations of one step attempt as the kernel writes it
    (a multiply and an add count one each, pow and sqrt one each)."""
    nz = lambda row: int(np.count_nonzero(row))
    ops = 0
    for i in range(1, tab.stages):
        ops += (2 * nz(tab.a[i, :i]) + 1) * n + 2 + rhs_flops
    ops += (2 * nz(tab.b) + 1) * n             # u + dt * sum(b k)
    if adaptive:
        ops += 2 * nz(tab.btilde) * n          # dt * sum(btilde k)
        ops += 8 * n + 2                       # scaled RMS norm
        ops += 10                              # PI controller, two pow
    return ops


def save_flops(tab, n: int) -> int:
    """Operations of one dense-output save (tsit5 interpolant)."""
    return 7 * 7 + 4 + (2 * tab.stages + 1) * n


def phase_full_size(device, N: int = FULL_N, reps: int = 5):
    """The main path at full size: Lorenz, float32, N trajectories."""
    import torch
    from repro_torch.configs.de_problems import lorenz_ensemble
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5 import kernel as erk_kernel

    host = lorenz_ensemble(N, dtype=torch.float32)
    u0s, ps = (x.to(device).contiguous() for x in host.materialize())
    ep = EnsembleProblem(host.prob, N, u0s=u0s, ps=ps)
    tab = get_tableau("tsit5")
    forms = {
        "adaptive": dict(dt0=1e-3, saveat=torch.linspace(0.0, 1.0, 5),
                         rtol=1e-6, atol=1e-6),
        "fixed": dict(dt0=1e-3, adaptive=False, n_steps=1000,
                      save_every=250, rtol=1e-6, atol=1e-6),
    }
    rows = []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for form, kw in forms.items():
        kw = dict(kw, t0=0.0, tf=1.0, device=device)
        # ---- the main path, with the launch count read around it --------
        erk_kernel.launches = 0
        res = solve_ensemble_local(ep, ensemble="kernel", backend="cuda", **kw)
        sync()
        launches = erk_kernel.launches
        if device.type == "cuda" and launches < 1:
            raise AssertionError(f"{form}: the main path launched no kernel")
        S = res.ts.shape[0]
        if int(res.status) != 0:
            raise AssertionError(f"{form}: status {int(res.status)} != 0")
        if tuple(res.us.shape) != (N, S, 3) or not bool(
                torch.isfinite(res.us).all() & torch.isfinite(res.u_final).all()):
            raise AssertionError(f"{form}: bad output shape {tuple(res.us.shape)}"
                                 " or non-finite values")
        attempts = int((res.naccept.long() + res.nreject.long()).sum())

        # ---- f32 kernel against the f64 twin on sampled lanes -----------
        sample = min(SAMPLE_N, N)
        idx = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
            N, sample, replace=False))).to(device)
        ep64 = EnsembleProblem(ep.prob, sample, u0s=u0s[idx].double(),
                               ps=ps[idx].double())
        r64 = solve_ensemble_local(ep64, ensemble="kernel", backend="torch",
                                   **dict(kw, saveat=res.ts.double()))
        d = ((res.us[idx].double() - r64.us).abs()
             / (1.0 + r64.us.abs())).max().item()
        if d > F32_TOL[form]:
            raise AssertionError(f"{form}: f32 kernel vs f64 twin {d:.3e} > "
                                 f"{F32_TOL[form]}")

        # ---- times: the kernel and its plain twin on the same inputs ----
        u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
        sv = res.ts.contiguous()
        kargs = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6,
                     adaptive=(form == "adaptive"), max_iters=100_000)
        f = ep.prob.f
        out_k = erk_kernel.erk_ensemble(f, tab, u0_l, p_l, sv, **kargs)
        out_p = erk_kernel._plain(f, tab, u0_l, p_l, sv, **kargs)
        max_abs = max(float((out_k[i] - out_p[i]).abs().max())
                      for i in (0, 1))
        rel = max(float(((out_k[i] - out_p[i]).abs()
                         / (1.0 + out_p[i].abs())).max()) for i in (0, 1))
        if rel > F32_TOL[form]:
            raise AssertionError(f"{form}: kernel vs f32 twin {rel:.3e} > "
                                 f"{F32_TOL[form]}")
        count_mismatch = int((out_k[3][:2] != out_p[3][:2]).any(0).sum())
        ms = cuda_ms(lambda: erk_kernel.erk_ensemble(
            f, tab, u0_l, p_l, sv, **kargs), reps)
        plain_ms = cuda_ms(lambda: erk_kernel._plain(
            f, tab, u0_l, p_l, sv, **kargs), 2, warmup=0)
        strategies = {}
        for name, (ens, be) in {"kernel_cuda": ("kernel", "cuda"),
                                "kernel_torch": ("kernel", "torch"),
                                "vmap": ("vmap", "torch"),
                                "array": ("array", "torch")}.items():
            strategies[name] = cuda_ms(lambda: solve_ensemble_local(
                ep, ensemble=ens, backend=be, **kw),
                reps if be == "cuda" else 1, warmup=1 if be == "cuda" else 0)

        # ---- bound: the larger of bytes / HBM rate and ops / FP32 peak ---
        item = 4
        bytes_moved = item * (3 * N + 3 * N + S) + item * (S * 3 * N + 3 * N
                                                           + N) + 4 * 6 * N
        flops = (attempts * attempt_flops(tab, 3, 9, form == "adaptive")
                 + N * S * save_flops(tab, 3))
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        print(f"full {form}: N={N} f32 status 0, attempts {attempts}, "
              f"launches {launches}, f32 vs f64 twin {d:.3e} "
              f"(bar {F32_TOL[form]}), kernel vs f32 twin max abs "
              f"{max_abs:.3e}, rel {rel:.3e} ({count_mismatch} lanes with "
              "other counts)")
        print(f"full {form}: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms ({flops:.3e} ops, "
              f"{bytes_moved:.3e} bytes); front door ms "
              + json.dumps({k: round(v, 3) for k, v in strategies.items()}))
        rows.append({
            "name": f"erk_ensemble[tsit5,lorenz,f32,{form}]",
            "route": "cuda", "source": "src/repro_torch/csrc/erk_ensemble.cu",
            "replaces": "src/repro/kernels/ensemble_kernel.py:184",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})
    return rows


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sde_inputs(name: str, N: int, dtype, device, seed: int = SEED):
    """An SDE ensemble from a seed: gbm with u0 near 0.1 and (r, v) near
    (1.5, 0.2); crn on the Table-4 parameter sweep."""
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    if name == "crn":
        u0s, ps = dp.crn_sweep_arrays(N, seed)
        prob = dp.crn_problem(dtype=dtype)
    else:
        rng = np.random.default_rng(seed)
        u0s = 0.1 + 0.01 * rng.random((N, 3))
        ps = np.array([1.5, 0.2]) + 0.01 * rng.random((N, 2))
        prob = dp.gbm_problem(r=1.5, v=0.2, dtype=dtype)
    return ensemble_problem(prob, u0s, ps, device=device, dtype=dtype)


def finite_compare(a, b):
    """(lanes finite in one and not the other, max |a - b| / max |b| over
    the lanes finite in both); a and b are (N, ...) trajectory-major."""
    fa, fb = torch_isfinite_lanes(a), torch_isfinite_lanes(b)
    both = fa & fb
    return int((fa != fb).sum()), rel_err(a[both], b[both])


def lane_errors(a, b):
    """(lanes finite in one and not the other, max |a - b|, per-lane max of
    |a - b| / (1 + |b|) on the lanes finite in both); a and b are (N, ...)
    trajectory-major."""
    fa, fb = torch_isfinite_lanes(a), torch_isfinite_lanes(b)
    both = fa & fb
    d = (a[both].double() - b[both].double()).abs()
    e = (d / (1.0 + b[both].double().abs())).reshape(d.shape[0], -1)
    return (int((fa != fb).sum()), float(d.max()) if d.numel() else 0.0,
            e.max(dim=1).values)


def lanes_first(out):
    """(N, S + 1, n): the saves and the final state of every lane of a
    wrapper's (us (S, n, N), u_final (n, N), ...)."""
    import torch
    return torch.cat([out[0].permute(2, 0, 1), out[1].T[:, None]], dim=1)


def torch_isfinite_lanes(x):
    """(N,) mask of trajectories whose every value is finite."""
    return x.isfinite().reshape(x.shape[0], -1).all(dim=1)


def phase_sde_rng(device):
    """The kernel's counter normals alone against the plain stream on the
    card: 2^20 draws at steps up to 2^31 - 1, lane indices wrapping."""
    import torch
    from repro_torch.kernels.em import kernel as sde_kernel
    steps, rows, lanes = 16, 8, 8192
    step0, off = 2 ** 31 - steps, 2 ** 32 - lanes // 2
    before = sde_kernel.normals_launches
    wk, zk = sde_kernel.sde_normals(SDE_SEED, step0, steps, rows, lanes,
                                    lane_offset=off, device=device)
    wp, zp = sde_kernel._plain_normals(SDE_SEED, step0, steps, rows, lanes,
                                       off, device)
    sync(device)
    if device.type == "cuda" and sde_kernel.normals_launches != before + 1:
        raise AssertionError("sde_normals did not launch its kernel")
    bad_words = int((wk != wp).sum())
    if bad_words:
        raise AssertionError(f"rng: {bad_words} Threefry words differ")
    dz = (zk - zp).abs()
    n_diff, max_dz = int((dz > 0).sum()), float(dz.max())
    if not bool(torch.isfinite(zk).all()) or max_dz > NORMAL_TOL:
        raise AssertionError(f"rng: normals differ by {max_dz:.3e} > "
                             f"{NORMAL_TOL}")
    print(f"rng: {zk.numel()} draws, words bitwise equal, normals differ on "
          f"{n_diff} (max {max_dz:.3e}, bar {NORMAL_TOL}), mean "
          f"{float(zk.double().mean()):.3e} var "
          f"{float(zk.double().var()):.4f}")
    return max_dz


def phase_sde_parity(device, max_dz: float, N: int = PARITY_N):
    """f64, the SDE kernel against its twin on the same card, every
    stepper, on a noise table and on the counter RNG."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.em import kernel as sde_kernel

    settings = {"gbm": dict(dt0=0.01, n_steps=100, save_every=25),
                "crn": dict(dt0=0.1, n_steps=100, save_every=25)}
    worst = {}
    cases = [(alg, name, src, 0) for alg, name in
             (("em", "gbm"), ("em", "crn"), ("heun_strat", "crn"),
              ("platen_w2", "gbm"), ("milstein", "gbm"))
             for src in ("table", "rng")]
    cases.append(("em", "gbm", "rng", 2 ** 32 - 100))
    eps = {name: sde_inputs(name, N, torch.float64, device)
           for name in settings}
    for alg, name, src, off in cases:
        ep, kw = eps[name], settings[name]
        m = ep.prob.noise_dim()
        table = None
        if src == "table":
            gen = torch.Generator().manual_seed(SEED)
            table = torch.randn((kw["n_steps"], m, N), generator=gen,
                                dtype=torch.float64).to(device)
        # same words on both sides; where the card's normals differ from
        # the plain stream's (phase_sde_rng), each step can move a state by
        # up to |g| sqrt(dt) max|dz|, relative to max|u|
        tol = 1e-12 if src == "table" or max_dz == 0 else \
            1e-12 + 10 * kw["n_steps"] * np.sqrt(kw["dt0"]) * max_dz
        args = dict(alg=alg, ensemble="kernel", t0=0.0, seed=SDE_SEED,
                    noise_table=table, lane_offset=off, device=device, **kw)
        before = sde_kernel.launches
        rk = solve_ensemble_local(ep, backend="cuda", **args)
        rt = solve_ensemble_local(ep, backend="torch", **args)
        sync(device)
        if device.type == "cuda" and sde_kernel.launches != before + 1:
            raise AssertionError(f"sde parity {alg}/{name}/{src}: the kernel "
                                 "was not launched")
        mism, err = finite_compare(rk.us, rt.us)
        mism_f, err_f = finite_compare(rk.u_final, rt.u_final)
        if mism or mism_f or max(err, err_f) > tol:
            raise AssertionError(
                f"sde parity {alg}/{name}/{src}: rel err {max(err, err_f):.3e}"
                f" > {tol:.3e} or {mism + mism_f} lanes finite in one only")
        if not (torch.equal(rk.naccept, rt.naccept)
                and torch.equal(rk.t_final, rt.t_final)
                and int(rk.nf) == int(rt.nf) and int(rk.status) == 0):
            raise AssertionError(f"sde parity {alg}/{name}/{src}: stats "
                                 "differ")
        finite = float(torch_isfinite_lanes(rt.us).double().mean())
        key = f"{alg}/{name}/{src}" + (f"/offset={off}" if off else "")
        worst[key] = max(err, err_f)
        print(f"sde parity {key}: N={N} f64 rel err {max(err, err_f):.3e} "
              f"(bar {tol:.1e}), finite lanes {finite:.4f}")
    return worst


def phase_sde_full_size(device, N: int = FULL_N, reps: int = 5):
    """The SDE path at full size, float32, through the front door."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel

    f32 = torch.float32
    gbm = EnsembleProblem(
        dp.gbm_problem(r=1.5, v=0.2, dtype=f32), N,
        u0s=torch.full((N, 3), 0.1, dtype=f32, device=device),
        ps=torch.tensor([1.5, 0.2], dtype=f32,
                        device=device).expand(N, 2).contiguous())
    crn = sde_inputs("crn", N, f32, device)
    fig9 = dict(dt0=1.0 / 200, n_steps=200, save_every=200)
    forms = [("gbm-1M-em", "gbm", "em", gbm, fig9),
             ("gbm-1M-platen_w2", "gbm", "platen_w2", gbm, fig9),
             ("crn-1M-em", "crn", "em", crn,
              dict(dt0=0.1, n_steps=1000, save_every=100))]
    rows, em_mean = [], None
    exact = 0.1 * np.exp(1.5)
    for form, name, alg, ep, spec in forms:
        kw = dict(alg=alg, t0=0.0, seed=SDE_SEED, device=device, **spec)
        # ---- the path, with the launch counts read around it ------------
        sde_kernel.launches = erk_kernel.launches = 0
        res = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                   **kw)
        sync(device)
        launches = sde_kernel.launches
        if device.type == "cuda" and launches < 1:
            raise AssertionError(f"{form}: the path launched no kernel")
        prob, n_steps = ep.prob, spec["n_steps"]
        n, m = prob.n_states, prob.noise_dim()
        S = n_steps // spec["save_every"]
        if tuple(res.us.shape) != (N, S, n) or int(res.status) != 0 or \
                not bool((res.naccept == n_steps).all()):
            raise AssertionError(f"{form}: shape {tuple(res.us.shape)}, "
                                 f"status {int(res.status)}")
        # ---- the form's own gate --------------------------------------
        X = res.u_final[:, 0].double()
        if name == "gbm":
            if not bool(torch.isfinite(res.us).all()):
                raise AssertionError(f"{form}: non-finite values")
            mean, se = float(X.mean()), float(X.std()) / np.sqrt(N)
            if alg == "em":
                want = 0.1 * (1 + 1.5 * spec["dt0"]) ** n_steps
                em_mean = mean
                if abs(mean - want) > 5 * se:
                    raise AssertionError(f"{form}: mean {mean:.6f} vs the EM "
                                         f"chain's {want:.6f}, > 5 SE {se:.2e}")
                gate = (f"mean X_T {mean:.6f} vs discrete closed form "
                        f"{want:.6f} ({abs(mean - want) / se:.2f} SE)")
            else:
                pl_bias, em_bias = abs(mean - exact), abs(em_mean - exact)
                if not pl_bias < 0.3 * em_bias:
                    raise AssertionError(f"{form}: bias {pl_bias:.3e} not "
                                         f"below 0.3 x EM's {em_bias:.3e}")
                gate = (f"bias vs 0.1 e^r {pl_bias:.3e} < 0.3 x EM's "
                        f"{em_bias:.3e}")
        else:
            finite = float(torch_isfinite_lanes(res.us).double().mean())
            gate = (f"finite lanes {finite:.4f} (the reference: 0.979 at "
                    "N = 1024)")

        # ---- the kernel and its plain twin on the same inputs -----------
        u0s, ps = ep.materialize()
        u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
        kargs = dict(t0=0.0, dt=spec["dt0"], n_steps=n_steps,
                     save_every=spec["save_every"], seed=SDE_SEED,
                     lane_offset=0)
        f, g = prob.f, prob.g

        def kernel():
            return sde_kernel.sde_ensemble(f, g, alg, u0_l, p_l,
                                           noise=prob.noise, m_noise=m,
                                           **kargs)

        def plain():
            return sde_kernel._plain(f, g, alg, prob.noise, m, u0_l, p_l,
                                     table=None, **kargs)

        out_k, out_p = kernel(), plain()
        mism, max_abs, e = lane_errors(lanes_first(out_k), lanes_first(out_p))
        q, bar = SDE_F32_TOL[name]
        rel = float(e.max())
        at_q = float(e.quantile(q)) if q < 1 else rel
        outliers = int((e > SDE_OUTLIER).sum())
        above = int((e > 1e-3).sum())
        if at_q > bar or mism + outliers > 1e-4 * N:
            raise AssertionError(
                f"{form}: kernel vs f32 twin {at_q:.3e} at quantile {q} > "
                f"{bar}, or {mism} lanes finite in one only and {outliers} "
                f"beyond {SDE_OUTLIER} (allowed {1e-4 * N:.0f})")
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, 1, warmup=0)
        strategies = {}
        for sname, (ens, be) in {"kernel_cuda": ("kernel", "cuda"),
                                 "kernel_torch": ("kernel", "torch"),
                                 "vmap": ("vmap", "torch"),
                                 "array": ("array", "torch")}.items():
            strategies[sname] = cuda_ms(lambda: solve_ensemble_local(
                ep, ensemble=ens, backend=be, **kw),
                reps if be == "cuda" else 1, warmup=1 if be == "cuda" else 0)

        # ---- bound: bytes / HBM, float ops / FP32, Threefry on the ALU
        # pipe, and every integer and float instruction / the issue rate --
        item = 4
        bytes_moved = (item * (n * N + prob.n_params * N)
                       + item * (S * n * N + n * N + N) + 4 * 6 * N)
        normals = N * n_steps * m
        flops = (N * n_steps * SDE_STEP_FLOPS[(name, alg)]
                 + normals * NORMAL_FLOPS)
        alu_ops = normals * THREEFRY_ALU_OPS
        # an fma does two of the counted float operations in one instruction
        issued = normals * (THREEFRY_ALU_OPS + THREEFRY_ADD_OPS) + flops / 2
        times = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
                 "fp32": flops / PEAK_FP32_FLOPS * 1e3,
                 "int32_alu": alu_ops / (ALU_LANES_PER_SM
                                         * SM_LANE_CLOCKS_PER_S) * 1e3,
                 "issue": issued / (ISSUE_LANES_PER_SM
                                    * SM_LANE_CLOCKS_PER_S) * 1e3}
        pipe = max(times, key=times.get)
        bound = times[pipe]
        print(f"sde {form}: N={N} f32 status 0, launches {launches}, {gate}; "
              f"kernel vs f32 twin per lane: quantile {q} {at_q:.3e} (bar "
              f"{bar}), max {rel:.3e}, median {float(e.median()):.3e}, "
              f"max abs {max_abs:.3e}; {above} lanes beyond 1e-3, "
              f"{outliers} beyond {SDE_OUTLIER}, {mism} finite in one only")
        print(f"sde {form}: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms by {pipe} (" + ", ".join(
                  f"{k} {v:.4f}" for k, v in times.items())
              + f" ms; {alu_ops:.3e} ALU ops, {issued:.3e} instructions, "
              f"{flops:.3e} float ops, {bytes_moved:.3e} bytes); front door "
              "ms " + json.dumps({k: round(v, 3)
                                  for k, v in strategies.items()}))
        rows.append({
            "name": f"sde_ensemble[{alg},{name},f32,rng]", "route": "cuda",
            "source": "src/repro_torch/csrc/sde_ensemble.cu",
            "replaces": "src/repro/kernels/ensemble_kernel.py:533",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if pipe == "bytes" else "operations",
            "bound_pipe": pipe, "library_ms": None})
    return rows


# ---------------------------------------------------------------------------
# the stiff family: the fused Rosenbrock kernel (K3) and the batched LU
# kernel (K6)
# ---------------------------------------------------------------------------

def lane_rel(a, b):
    """Per-lane max |a - b| over the lane's values, relative to the lane's
    largest |b|; a and b are (N, ...) trajectory-major."""
    d = (a.double() - b.double()).abs().reshape(a.shape[0], -1).max(dim=1)
    scale = b.double().abs().reshape(b.shape[0], -1).max(dim=1).values
    return d.values / scale.clamp_min(1e-300)


def within_rober_bar(a, b):
    """Lanes of a within rtol 1e-6, atol 1e-14 of b, every element."""
    ok = ((a.double() - b.double()).abs()
          <= ROBER_ATOL + ROBER_RTOL * b.double().abs())
    return ok.reshape(a.shape[0], -1).all(dim=1)


def rober_inputs(N: int, device):
    from repro_torch.configs.de_problems import rober_ensemble
    from repro_torch.core.problem import EnsembleProblem
    host = rober_ensemble(N, tspan=(0.0, 1e4))
    u0s, ps = (x.to(device).contiguous() for x in host.materialize())
    return EnsembleProblem(host.prob, N, u0s=u0s, ps=ps)


def stiff_metrics(rk, rt):
    """Kernel result against twin result through the front door: the share
    of lanes with equal step counts, the worst per-lane error on them and
    on all lanes, and the lanes within the ROBER bar."""
    import torch
    same = (rk.naccept == rt.naccept) & (rk.nreject == rt.nreject)
    rel = torch.maximum(lane_rel(rk.us, rt.us),
                        lane_rel(rk.u_final, rt.u_final))
    worst_same = float(rel[same].max()) if bool(same.any()) else 0.0
    bar = within_rober_bar(rk.us, rt.us) & within_rober_bar(rk.u_final,
                                                            rt.u_final)
    return float(same.double().mean()), worst_same, float(rel.max()), bar


def stiff_compare(name, rk, rt, *, rober: bool):
    """`stiff_metrics` with the gates: status 0, equal-count lanes within
    STIFF_SAME_COUNTS_TOL, every lane within the ROBER bar, and for ROBER
    the conserved sum."""
    if int(rk.status) != 0 or int(rt.status) != 0:
        raise AssertionError(f"{name}: status {int(rk.status)} (kernel), "
                             f"{int(rt.status)} (twin)")
    share, worst_same, worst, bar = stiff_metrics(rk, rt)
    if worst_same > STIFF_SAME_COUNTS_TOL or not bool(bar.all()):
        raise AssertionError(
            f"{name}: lanes with equal counts differ by {worst_same:.3e} > "
            f"{STIFF_SAME_COUNTS_TOL}, or {int((~bar).sum())} lanes beyond "
            f"the ROBER bar")
    if rober:
        total = (rk.u_final.sum(dim=1) - 1.0).abs().max()
        if float(total) > ROBER_SUM_TOL:
            raise AssertionError(f"{name}: y1 + y2 + y3 off 1 by "
                                 f"{float(total):.3e}")
    return share, worst_same, worst


def stiff_parity_cases(device, N: int):
    """(name, ensemble, front-door arguments, is ROBER) of the f64 stiff
    parity phase: ROBER with every method, eager and lazy W; OREGO with
    rodas5p; Van der Pol with rodas4."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.problem import EnsembleProblem

    rng = np.random.default_rng(SEED)
    rober = rober_inputs(N, device)
    orego = dp.orego_problem(tspan=(0.0, 5.0))
    orego_ep = ensemble_problem(
        orego, np.asarray([1.0, 2.0, 3.0]) * rng.uniform(0.9, 1.1, (N, 3)),
        np.tile(orego.p.numpy(), (N, 1)), device=device)
    vdp = dp.vdp_ensemble(N)
    vdp_ep = EnsembleProblem(vdp.prob, N, u0s=vdp.materialize()[0].to(device),
                             ps=vdp.ps.to(device))
    f64 = torch.float64
    rober_kw = dict(ROBER_SETTINGS, saveat=torch.tensor(ROBER_SAVEAT,
                                                        dtype=f64))
    cases = [(f"rober {alg} {'lazyW' if wr else 'eager'}", rober,
              dict(rober_kw, alg=alg, w_reuse=wr), True)
             for alg in ("rodas5p", "rodas4", "rosenbrock23")
             for wr in (False, True)]
    cases += [("orego rodas5p", orego_ep,
               dict(alg="rodas5p", t0=0.0, tf=5.0, dt0=1e-4, rtol=1e-7,
                    atol=1e-8, saveat=torch.linspace(0.0, 5.0, 6,
                                                     dtype=f64)), False),
              ("vdp rodas4", vdp_ep,
               dict(alg="rodas4", t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6,
                    atol=1e-6, saveat=torch.linspace(0.0, 1.0, 5,
                                                     dtype=f64)), False)]
    return cases


def phase_stiff_parity(device, N: int = PARITY_N):
    """f64, the fused Rosenbrock kernel against its twin (the same front
    door on `backend="torch"` with the lanes LU) on the same card."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel

    out, cases = {}, stiff_parity_cases(device, N)
    for name, ep, kw, is_rober in cases:
        before = rb_kernel.launches
        rk = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                  device=device, **kw)
        rt = solve_ensemble_local(ep, ensemble="kernel", backend="torch",
                                  linsolve="lanes", device=device, **kw)
        sync(device)
        if device.type == "cuda" and rb_kernel.launches != before + 1:
            raise AssertionError(f"stiff parity {name}: the kernel was not "
                                 "launched")
        share, worst_same, worst = stiff_compare(name, rk, rt,
                                                 rober=is_rober)
        attempts = int((rk.naccept.long() + rk.nreject.long()).sum())
        if not kw.get("w_reuse") and not (int(rk.njac) == int(rk.nfact)
                                          == attempts):
            raise AssertionError(f"stiff parity {name}: eager njac "
                                 f"{int(rk.njac)}, nfact {int(rk.nfact)} != "
                                 f"attempts {attempts}")
        out[name] = dict(same_counts=share, worst_same=worst_same,
                         worst=worst)
        print(f"stiff parity {name}: N={N} f64 status 0, lanes with equal "
              f"counts {share:.4f}, worst per-lane rel err on them "
              f"{worst_same:.3e} (bar {STIFF_SAME_COUNTS_TOL}), on all "
              f"{worst:.3e} (every lane within rtol {ROBER_RTOL}, atol "
              f"{ROBER_ATOL}); attempts {attempts}, njac {int(rk.njac)}, "
              f"nfact {int(rk.nfact)} (twin {int(rt.njac)}, "
              f"{int(rt.nfact)})")

    # float32: Van der Pol on the kernel, against the f64 twin
    vdp_ep = next(ep for name, ep, _, _ in cases if name == "vdp rodas4")
    f64 = torch.float64
    vdp32 = EnsembleProblem(dp.vdp_problem(dtype=torch.float32), N,
                            u0s=vdp_ep.u0s.float(), ps=vdp_ep.ps.float())
    kw = dict(alg="rodas4", t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-4, atol=1e-6)
    r32 = solve_ensemble_local(vdp32, ensemble="kernel", backend="cuda",
                               saveat=torch.linspace(0.0, 1.0, 5),
                               device=device, **kw)
    r64 = solve_ensemble_local(vdp_ep, ensemble="kernel", backend="torch",
                               linsolve="lanes", device=device,
                               saveat=torch.linspace(0.0, 1.0, 5, dtype=f64),
                               **kw)
    if int(r32.status) != 0 or not bool(torch.isfinite(r32.us).all()):
        raise AssertionError(f"vdp rodas4 f32: status {int(r32.status)} or "
                             "non-finite values")
    d32 = float(((r32.us.double() - r64.us).abs()
                 / (1.0 + r64.us.abs())).max())
    print(f"stiff parity vdp rodas4 f32 kernel: status 0, against the f64 "
          f"twin {d32:.3e} (rtol 1e-4)")
    out["vdp rodas4 f32 vs f64 twin"] = d32
    return out


def lu_batch(n: int, N: int, seed: int = SEED):
    """N random n x n f64 systems from a seed: one in 64 with a zero
    diagonal (it needs row swaps), eight exactly singular (a zero column,
    so a pivot is exactly zero) and eight zero matrices."""
    rng = np.random.default_rng(seed + n)
    W = rng.standard_normal((N, n, n))
    W[::64, np.arange(n), np.arange(n)] = 0.0
    sing = rng.choice(N, 16, replace=False)
    W[sing[:8], :, n // 2] = 0.0
    W[sing[8:]] = 0.0
    return W, rng.standard_normal((N, n))


def lu_ops(n: int) -> int:
    """Float operations of one system in csrc/lu_lanes.cuh as written: per
    step k a reciprocal, the multipliers and the row updates; the forward
    and back substitutions and the diagonal divides."""
    ops = 0
    for k in range(n):
        r = n - k - 1
        ops += 1 + r + 2 * r * r
    return ops + 2 * n * (n - 1) + n


def phase_lu(device, N: int = FULL_N, reps: int = 5):
    """The batched LU kernel against its plain version on 2^20 systems of
    n = 3 and n = 8, with singular ones, and its reroute; times the kernel,
    the plain version and the library's batched solves."""
    import torch
    from repro_torch.kernels.lu import kernel as lu_kernel
    from repro_torch.kernels.lu import ops as lu_ops_mod
    from repro_torch.kernels.lu.ref import ref_solve

    rows = []
    for n in (3, 8):
        Wn, bn = lu_batch(n, N)
        W = torch.from_numpy(Wn).to(device)
        b = torch.from_numpy(bn).to(device)
        Wl, bl = W.permute(1, 2, 0).contiguous(), b.T.contiguous()
        before = lu_kernel.launches
        x, pm = lu_kernel.lu_solve(Wl, bl)
        xp, pmp = lu_kernel.lu_solve_lanes(Wl, bl, with_pivmin=True)
        sync(device)
        if device.type == "cuda" and lu_kernel.launches != before + 1:
            raise AssertionError(f"lu n={n}: the kernel was not launched")
        ok, okp = pm > 0, pmp > 0
        if not torch.equal(ok, okp):
            raise AssertionError(f"lu n={n}: pivmin > 0 differs on "
                                 f"{int((ok != okp).sum())} systems")
        err = float(((x - xp).abs().max(dim=0).values
                     / xp.abs().max(dim=0).values)[ok].max())
        max_abs = float((x - xp)[:, ok].abs().max())
        bitwise = bool(torch.equal(x[:, ok], xp[:, ok])
                       and torch.equal(pm[ok], pmp[ok]))
        if err > LU_TOL:
            raise AssertionError(f"lu n={n}: x differs from the plain "
                                 f"version by {err:.3e} > {LU_TOL}")
        lu_ops_mod.rerouted = 0
        xb = lu_ops_mod.batched_solve(W, b)
        sing = ~ok
        want = ref_solve(W[sing], b[sing])
        if not (torch.equal(xb[sing].isnan(), want.isnan())
                and torch.equal(xb[sing].nan_to_num(), want.nan_to_num())
                and torch.equal(xb[ok], x.T[ok])):
            raise AssertionError(f"lu n={n}: the rerouted systems are not "
                                 "the reference solve's output")
        rerouted = lu_ops_mod.rerouted

        ms = cuda_ms(lambda: lu_kernel.lu_solve(Wl, bl), reps)
        plain_ms = cuda_ms(lambda: lu_kernel.lu_solve_lanes(
            Wl, bl, with_pivmin=True), reps)
        solve_ms = cuda_ms(lambda: torch.linalg.solve_ex(W, b), reps)
        lufs_ms = cuda_ms(lambda: ref_solve(W, b), reps)
        nbytes = 8 * (n * n * N + 2 * n * N + N)
        ops = lu_ops(n) * N
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FP64_FLOPS * 1e3
        print(f"lu n={n}: N={N} f64, pivmin > 0 flags equal "
              f"({int(sing.sum())} singular, {rerouted} rerouted to the "
              f"reference solve, equal to it), non-singular x against the "
              f"plain version {err:.3e} (bar {LU_TOL}), bitwise {bitwise}")
        print(f"lu n={n}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"library torch.linalg.solve_ex {solve_ms:.3f} ms, "
              f"lu_factor_ex + lu_solve {lufs_ms:.3f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({nbytes:.3e} bytes "
              f"{t_bytes:.4f} ms, {ops:.3e} f64 ops {t_ops:.4f} ms)")
        rows.append({
            "name": f"lu_solve[f64,n={n}]", "n": n, "route": "cuda",
            "source": "src/repro_torch/csrc/lu_solve.cu",
            "replaces": "src/repro/kernels/lu/kernel.py:115",
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": solve_ms, "library": "torch.linalg.solve_ex",
            "lu_factor_ex_lu_solve_ms": lufs_ms, "rerouted": rerouted})
    return rows


def phase_array_linsolve_cuda(device, N: int = 2 ** 16):
    """The `array` strategy with the batched LU kernel as its W solve:
    ROBER, rodas4, against the same strategy on the library's LU."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.lu import kernel as lu_kernel
    from repro_torch.kernels.lu import ops as lu_ops_mod

    ep = rober_inputs(N, device)
    kw = dict(ROBER_SETTINGS, alg="rodas4", ensemble="array", device=device,
              saveat=torch.tensor(ROBER_SAVEAT, dtype=torch.float64))
    lu_kernel.launches = lu_ops_mod.rerouted = 0
    t = time.perf_counter()
    rc = solve_ensemble_local(ep, linsolve="cuda", **kw)
    sync(device)
    secs_cuda = time.perf_counter() - t
    launches, rerouted = lu_kernel.launches, lu_ops_mod.rerouted
    t = time.perf_counter()
    rt = solve_ensemble_local(ep, linsolve="torch", **kw)
    sync(device)
    secs_torch = time.perf_counter() - t
    iters = int((rc.naccept + rc.nreject).max())
    stages = 6
    if device.type == "cuda" and launches != stages * iters:
        raise AssertionError(f"array linsolve=cuda: {launches} LU launches, "
                             f"not one per stage solve ({stages} x {iters})")
    if int(rc.status) != 0 or int(rt.status) != 0:
        raise AssertionError("array linsolve=cuda: status not 0")
    bar = within_rober_bar(rc.us, rt.us) & within_rober_bar(rc.u_final,
                                                            rt.u_final)
    if not bool(bar.all()):
        raise AssertionError(f"array linsolve=cuda: {int((~bar).sum())} "
                             "lanes beyond the ROBER bar of linsolve=torch")
    same = float(((rc.naccept == rt.naccept)
                  & (rc.nreject == rt.nreject)).double().mean())
    worst = float(torch.maximum(lane_rel(rc.us, rt.us),
                                lane_rel(rc.u_final, rt.u_final)).max())
    print(f"array rodas4 linsolve=cuda: N={N} f64 status 0, LU launches "
          f"{launches} (one per stage solve: {stages} x {iters} loop "
          f"iterations), {rerouted} systems rerouted; against "
          f"linsolve=torch every lane within the ROBER bar, worst {worst:.3e}"
          f", lanes with equal counts {same:.4f}; front door "
          f"{secs_cuda:.3f} s (cuda) and {secs_torch:.3f} s (torch)")
    return launches


def rosenbrock_attempt_ops(rtab, n: int, rhs: int, jac: int):
    """Float operations of the fused kernel as written (each add, multiply,
    divide, sqrt and pow one): (per attempt without the Jacobian and the
    factorization, per Jacobian, per W build and factorization, per save).
    Pivot compares, the secant touch-up and the lazy-W bookkeeping are not
    counted, so the bound stays a lower one."""
    nz = lambda row: int(np.count_nonzero(row))
    s = rtab.stages
    resolve = 2 * n * (n - 1) + n
    ops = rhs + 1                                  # F0, γ·dt
    for i in range(s):
        if i:
            ops += 2 * nz(rtab.a[i, :i]) * n + 2 + rhs   # g_i, t + c_i dt
        ops += n + 2 * nz(rtab.C[i, :i]) * n     # γdt F_i + Σ γC_ij U_j
        ops += 4 * n if rtab.d[i] != 0.0 else 0  # γd_i dt dt f_t
        ops += resolve
    ops += 2 * (nz(rtab.b) + nz(rtab.btilde)) * n
    ops += 5 * n + 2                               # scaled RMS norm
    ops += 7                                       # two pow, the PI update
    fact = 2 * n * n + 1 + lu_ops(n) - resolve
    save = 11 + 7 * n                              # Hermite at one point
    return ops, jac, fact, save


def phase_stiff_full_size(device, N: int = FULL_N, reps: int = 5):
    """The stiff path at full size, f64, through the front door: ROBER with
    rodas5p, and with rodas4 on lazy W beside eager rodas4."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel

    ep = rober_inputs(N, device)
    sv = torch.tensor(ROBER_SAVEAT, dtype=torch.float64, device=device)
    forms = [("rober-1M-rodas5p", "rodas5p", False),
             ("rober-1M-rodas4-eager", "rodas4", False),
             ("rober-1M-rodas4-lazyW", "rodas4", True)]
    rows, njac = [], {}
    for form, alg, wr in forms:
        kw = dict(ROBER_SETTINGS, alg=alg, w_reuse=wr, saveat=sv,
                  device=device)
        rb_kernel.launches = 0
        res = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                   **kw)
        sync(device)
        launches = rb_kernel.launches
        if device.type == "cuda" and launches < 1:
            raise AssertionError(f"{form}: the path launched no kernel")
        S = sv.shape[0]
        if tuple(res.us.shape) != (N, S, 3) or int(res.status) != 0 or \
                not bool(torch.isfinite(res.us).all()):
            raise AssertionError(f"{form}: shape {tuple(res.us.shape)}, "
                                 f"status {int(res.status)} or non-finite")
        total = float((res.u_final.sum(dim=1) - 1.0).abs().max())
        if total > ROBER_SUM_TOL:
            raise AssertionError(f"{form}: y1 + y2 + y3 off 1 by {total:.3e}")
        attempts = int((res.naccept.long() + res.nreject.long()).sum())
        njac[form] = int(res.njac)

        # ---- the kernel and its plain twin on the same inputs -----------
        rtab = get_rosenbrock_tableau(alg)
        u0s, ps = ep.materialize()
        u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
        kargs = dict(jac=ep.prob.jac, t0=0.0, tf=1e4, dt0=1e-6, rtol=1e-6,
                     atol=1e-8, max_iters=100_000, w_reuse=wr)
        f = ep.prob.f

        def kernel():
            return rb_kernel.rosenbrock_ensemble(f, rtab, u0_l, p_l, sv,
                                                 **kargs)

        def plain():
            return rb_kernel._plain(f, rtab, u0_l, p_l, sv, **kargs)

        out_k = kernel()
        t = time.perf_counter()
        out_p = plain()
        sync(device)
        plain_ms = (time.perf_counter() - t) * 1e3
        lk, lp = lanes_first(out_k), lanes_first(out_p)
        bar = within_rober_bar(lk, lp)
        same = float((out_k[3][:2] == out_p[3][:2]).all(0).double().mean())
        bitwise = int((lk == lp).reshape(N, -1).all(dim=1).sum())
        max_abs = float((lk - lp).abs().max())
        if not bool(bar.all()):
            raise AssertionError(
                f"{form}: {int((~bar).sum())} kernel lanes beyond the ROBER "
                f"bar of the twin (lanes with equal counts {same:.6f}, "
                f"{bitwise} lanes bitwise equal, max abs {max_abs:.3e})")
        ms = cuda_ms(kernel, reps)
        strategies = {"kernel_cuda": cuda_ms(lambda: solve_ensemble_local(
            ep, ensemble="kernel", backend="cuda", **kw), reps)}
        if form == "rober-1M-rodas5p":
            # the paper's comparison with the plain strategies, run once
            # each, on this form only: they take seconds a run
            for sname, ens in (("kernel_torch", "kernel"), ("vmap", "vmap"),
                               ("array", "array")):
                strategies[sname] = cuda_ms(lambda: solve_ensemble_local(
                    ep, ensemble=ens, backend="torch", **kw), 1, warmup=0)

        # ---- bound: f64 operations / FP64 peak, bytes / HBM ---------------
        per_attempt, per_jac, per_fact, per_save = rosenbrock_attempt_ops(
            rtab, 3, *STIFF_RHS_OPS["rober"])
        ops = (attempts * per_attempt + int(res.njac) * per_jac
               + int(res.nfact) * per_fact + N * S * per_save)
        nbytes = 8 * (6 * N + S + S * 3 * N + 3 * N + N) + 4 * 6 * N
        t_ops = ops / PEAK_FP64_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        bound_unfused = max(ops / PEAK_FP64_UNFUSED_OPS * 1e3, t_bytes)
        print(f"{form}: N={N} f64 status 0, launches {launches}, attempts "
              f"{attempts} ({attempts / N:.1f} a lane), njac "
              f"{int(res.njac)}, nfact {int(res.nfact)}, y-sum off 1 by "
              f"{total:.2e}; kernel against the f64 twin: every lane within "
              f"the ROBER bar, lanes with equal counts {same:.4f}, "
              f"{bitwise} of {N} lanes bitwise equal, max abs {max_abs:.3e}")
        print(f"{form}: kernel {ms:.3f} ms, twin {plain_ms:.1f} ms (one "
              f"run), bound {bound:.4f} ms by "
              f"{'f64 operations' if t_ops >= t_bytes else 'bytes'} "
              f"({bound_unfused:.4f} ms at the unfused rate, 17e12/s) "
              f"({ops:.3e} ops: {per_attempt} an attempt, {per_jac} a "
              f"Jacobian, {per_fact} a factorization; {nbytes:.3e} bytes "
              f"{t_bytes:.4f} ms); front door ms "
              + json.dumps({k: round(v, 3) for k, v in strategies.items()}))
        if form != "rober-1M-rodas4-eager":
            rows.append({
                "name": f"rosenbrock_ensemble[{alg},rober,f64,"
                        f"{'lazyW' if wr else 'eager'}]",
                "route": "cuda",
                "source": "src/repro_torch/csrc/rosenbrock_ensemble.cu",
                "replaces": "src/repro/kernels/ensemble_kernel.py:491",
                "launches": launches, "max_abs_err": max_abs, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "bound_unfused_ms": bound_unfused,
                "library_ms": None, "attempts": attempts,
                "njac": int(res.njac), "nfact": int(res.nfact)})
    lazy, eager = njac["rober-1M-rodas4-lazyW"], njac["rober-1M-rodas4-eager"]
    if not eager >= 2 * lazy:
        raise AssertionError(f"lazy W: njac {lazy} is not 2x below eager "
                             f"{eager}")
    print(f"rober-1M-rodas4: lazy-W njac {lazy} against eager {eager} "
          f"({eager / lazy:.2f}x fewer, bar 2x)")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    gpu = gpu_line()
    phase_build()
    worst = phase_parity(device)
    rows = phase_full_size(device)
    for r in rows:
        r["parity_f64_rel_err"] = worst
    max_dz = phase_sde_rng(device)
    sde_worst = phase_sde_parity(device, max_dz)
    sde_rows = phase_sde_full_size(device)
    for r in sde_rows:
        r["parity_f64_rel_err"] = sde_worst
    rows += sde_rows
    stiff = phase_stiff_parity(device)
    lu_rows = phase_lu(device)
    lu_launches = phase_array_linsolve_cuda(device)
    for r in lu_rows:
        # the stiff path solves ROBER's 3 x 3 systems: no path launches n = 8
        r["launches"] = lu_launches if r["n"] == 3 else 0
    stiff_rows = phase_stiff_full_size(device)
    for r in stiff_rows:
        r["parity_f64"] = stiff
    rows += stiff_rows + lu_rows
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
