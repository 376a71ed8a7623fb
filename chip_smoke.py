#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernel from `src/repro_torch/csrc/`, holds it
against its plain PyTorch twin on the card, drives the port's main path
(`solve_ensemble_local(ensemble="kernel", backend="cuda")`) on the paper's
million-trajectory Lorenz ensemble, and times it beside the twin and the
`vmap` and `array` strategies.  Every phase raises on failure, so the
script exits non-zero; it also exits non-zero, printing no result, where
CUDA is absent or the port's sources are not beside it.  The last line is
one JSON object naming the device; the line before it lists every kernel
with its launches on the main path, its error against the plain version,
its time and its bound.
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
# non-tensor-core FP32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

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


def ptxas_summary(log: str):
    """One 'instantiation: registers, spills' entry per kernel in nvcc's
    -Xptxas=-v report."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1] if "'" in ln else ln
            name = ",".join(
                [tag for key, tag in (("kernelIf", "f32"), ("kernelId", "f64"),
                                      ("Tsit5", "tsit5"),
                                      ("Dopri5", "dopri5"),
                                      ("Lorenz", "lorenz"), ("Sho", "sho"))
                 if key in mangled]) or mangled[:40]
            spill = ""
        elif "spill stores" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spill}")
            name = None
    return out


def phase_build() -> float:
    from repro_torch.kernels.build import build
    from repro_torch.kernels.tsit5.kernel import SOURCE
    t = time.perf_counter()
    logs = build([SOURCE])
    secs = time.perf_counter() - t
    for src, log in logs.items():
        print(f"build {src}: " + "; ".join(ptxas_summary(log)))
    print(f"build: {secs:.1f} s ({'compiled' if logs else 'cached'})")
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
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
