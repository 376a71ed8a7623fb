#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/` (the
explicit-RK ensemble kernel in its two translation units, every tableau
of the reference, the fixed-dt SDE kernel, the adaptive SDE
kernel on the virtual Brownian tree, the batched LU kernel, the fused
Rosenbrock stiff kernel, the dataset lookup entry and flash attention in
its two forms, CUDA cores and tensor cores, all nvcc processes started
together), holds each against its plain PyTorch twin on the card, runs the
automated translation (`phase_translate`: every generated unit built in
the build's one parallel call, a new RHS's first-use and second-use
compile seconds, and the generated functors of K1 on all eight tableaus
and a user tableau, K2, K3 with ROBER's Jacobian traced and with derived
Jacobians on ROBER, OREGO, Van der Pol and a time-dependent RHS, and K4 on
GBM and CRN, each against the hand-written functor and against its plain
version, plus one gradient; a user tableau's free interpolant, a copy of
tsit5's bitwise the hand-written tsit5 and dopri5 with Hairer's dense
output bitwise its plain version; `phase_translate_rows`: the generated
rows at 2^20 beside their hand-written rows, timed in turns), tunes
``ensemble="auto"`` on two million-trajectory rows (`phase_autotune`: the
candidates' medians, the winner, a cache hit, auto bitwise the winner),
runs the sharded solve over two gloo ranks on the one card
(`phase_distributed`: K1, K4, K5 and a dataset bitwise the local solve),
serves 92 mixed requests through one `EnsembleService` and runs the
elastic supervisor under injected faults (`phase_serve_elastic`: slot
pools on the lanes engine, K3 and K5 from one-shot batches and tiles,
every served request and elastic run bitwise its fresh or local solve),
drives the port's paths through the front door
(`solve_ensemble_local(ensemble="kernel", backend="cuda")`): the paper's
million-trajectory Lorenz ensemble (tsit5, and vern7 beside it; every
tableau held against its plain version in f64, the staged driver bitwise
one launch and reading nothing back from the card), the million-trajectory geometric
Brownian motion (Fig. 9) and chemical-reaction-network sweep (Figs. 10/11)
SDE ensembles, the million-trajectory adaptive GBM ensembles (the em
embedded pair and step doubling, against the closed form on the same
path), and the million-trajectory ROBER stiff ensembles (rodas5p, and
rodas4 with lazy W), plus the `array` strategy with the batched LU kernel
as its linear solver, and the event forms of the four ensemble kernels
(f64 parity on decay, the bouncing ball, ROBER, GBM and the ramp, then the
million-trajectory bouncing ball in f64 and f32, ROBER with its
half-conversion event and GBM with a knock-out barrier, fixed and
adaptive), the data forms of the four ensemble kernels (f64 parity on the
forced oscillator in every lookup mode, adaptive, stiff and with its level
event, and on the rate-table GBM, fixed and adaptive; the lookup entry on
2^20 queries of 1-D and 2-D tables; then the million-trajectory data
rows: the texture benchmark's configuration in three modes beside the
`vmap` strategy, the adaptive, stiff and event forms and the rate-table
GBM), the gradients across the kernel boundary (`kernel_adjoint`: f64
parity of every family's adjoint on the kernel route against the torch
route and central differences, the five full-width gradient rows with
their forward and backward times and the backward's peak memory, and the
population fit of examples/parameter_estimation_torch.py), flash
attention (K7, the LM scaffolding's kernel: parity of both forms against
the plain version and the dense oracle in float32, bfloat16 and float64,
then the dense-LM serving path at internlm2-1.8b's full width in bfloat16
with K7's tensor-core form as its attention core: four 4096-token
requests and one 32,768-token prompt, prefill then greedy decode through
`make_serve_plan`, held against `forward` and an f32 run, and K7 on the
model's own q, k, v against its plain version, the dense oracle, the
model's dense core and SDPA), the other five LM families served the same
way, LM training on the card (`phase_lm_train`: internlm2-1.8b at full
width and depth in bfloat16 for six steps through `make_train_step`,
no hand kernel on the path, the gradients through the int8 collectives,
accumulation, the card against the CPU, every family's step, a bitwise
resume), and times each kernel beside its twin, the `vmap` and `array`
strategies on lorenz-1M-f32-adaptive and `vmap` on gbm-1M-em,
rober-1M-rodas5p and osc-1M-f32-fixed-gather.  Every phase raises on
failure, so the script exits non-zero; it also exits non-zero, printing no
result, where CUDA is absent or the port's sources are not beside it.  The
explicit-RK rows print the kernel's bound in the card's instructions
(`k1_work`: the fast paths of a division, sqrt and pow in this build's
SASS, the lookups, the saves and the events' bisection), its warp SIMT
efficiency and registers; the staged driver's time is split into device
and host.  The stiff and adaptive SDE rows also print each kernel's warp
SIMT efficiency (from its own stats, one trajectory a thread), its
registers, and, for the
stiff kernel, its FP64 bound counted in the card's instructions (the fast
paths of a division, sqrt and pow in this build's SASS); the fixed-dt SDE
rows print theirs in f32 instructions a pipe (`k4_bound_instr`: the fast
paths of a counter normal, powf, a division and sqrtf), their registers
and their step loop's instruction mix.  The batched LU kernel's factor
and resolve entries are held bit for bit to its one-shot entry and timed
at 2^20 systems and at the `array` path's 2^16 (device time in a CUDA
graph of 50 launches, the wrapper's host time); the path launches one
factor a W build and one resolve a stage solve, its resolves run under
the sync check, and its front door is a median of 3 for both W-solve
routes.  The last line is one JSON object naming the device; the line
before it lists every kernel with its launches on its path, its error
against the plain version, its time and its bound.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
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
# FP64 instructions (DADD, DMUL, DFMA, ...) issue at 64 lanes per SM per
# clock on compute capability 9.0 (the same table): 16.7e12 a second.
FP64_INSTR_PER_S = 64 * SM_LANE_CLOCKS_PER_S

FULL_N = 2 ** 20
# timed runs of a kernel and its front door in the *_full_size phases,
# their median after a warm-up (5 before `phase_lm_train` came; cut to pay
# for it: the rows' times spread less between runs of one call than
# between calls)
FULL_REPS = 3
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
# K2's staged fixed-dt run (f64) against K1's plain version on the same
# inputs: max |a - b| within 1e-12, the parity phase's fixed-dt bar (there
# relative to the largest state, which stays below 50 here).
K2_TOL = 1e-12

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

# The adaptive SDE phases (the kernel on the virtual Brownian tree).  f64
# parity: kernel and plain version round every operation on their own, so
# per-lane counts and status must be identical on every lane and states
# within ADAPTIVE_TOL.  f32 at full size: f32 rounding may move an accept
# decision, so counts must be equal on ADAPTIVE_F32_SAME of the lanes,
# u_final within ADAPTIVE_F32_TOL relative on those and ADAPTIVE_ANY_TOL on
# every lane (nudging every bridge normal by 2 f32 ulps moved u_final by at
# most 9.6e-8 on the lanes whose counts held and 2.3e-3 on any lane, on
# 1024 f64 GBM lanes on the CPU).  The strong error against the closed
# form: the kernel's median within ADAPTIVE_MEDIAN_TOL of the f64 plain
# version's.
ADAPTIVE_TOL = 1e-12
ADAPTIVE_F32_SAME, ADAPTIVE_F32_TOL, ADAPTIVE_ANY_TOL = 0.999, 1e-5, 1e-2
ADAPTIVE_MEDIAN_TOL = 0.05
# The f64 plain version of the strong-error check runs on the first
# STRONG_N lanes (i.i.d. paths: the median of 3 * 2^16 errors has a
# standard error near 0.1% of itself), to keep the smoke's time down.
STRONG_N = 2 ** 16
ADAPTIVE_SETTINGS = {
    "gbm": dict(t0=0.0, tf=1.0, dt0=0.05, rtol=1e-3, atol=1e-5,
                saveat=(0.25, 0.5, 0.75, 1.0)),
    # CRN on [0, 2.5]: its doubling plain version, a host loop until the
    # last lane ends, was 45 s of the phase on [0, 10] and 22-29 s on
    # [0, 5] on an H100's host
    "crn": dict(t0=0.0, tf=2.5, dt0=0.1, rtol=1e-3, atol=1e-5,
                saveat=(0.625, 1.25, 1.875, 2.5))}
# benchmarks/bench_adaptive_sde.py's settings at the paper's 10^6 scale
ADAPTIVE_FULL = dict(t0=0.0, tf=1.0, dt0=0.02, rtol=1e-3, atol=1e-5,
                     depth=14, seed=7, saveat=(0.25, 0.5, 0.75, 1.0))
# Float operations as the adaptive kernel writes them (add, multiply,
# divide, max, abs, sqrt, pow one each).  A bridge normal: Box-Muller's 12
# (NORMAL_FLOPS without the z * sqrt(dt)) and the midpoint's 4.  An attempt
# on GBM besides the normals: the estimator (em pair 54: drift 3, diffusion
# 3, gdg 6, error and update 14 a state; doubling with em 57: three em
# steps of 15, the error 6, the 6 increments), the Hairer norm 26, the
# controller 10, the dt, t and cell arithmetic 8.
BRIDGE_FLOPS_PER_NORMAL = NORMAL_FLOPS - 1 + 4
ADAPTIVE_ATTEMPT_FLOPS = {"embedded": 54 + 44, "doubling": 57 + 44}

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
                        ("Lorenz", "lorenz"), ("Sho", "sho"),
                        ("Ball", "ball"), ("Decay", "decay"),
                        ("BallBounce", "bounce"), ("DecayHalf", "half"),
                        ("ForcedOscILi0E", "osc-gather"),
                        ("ForcedOscILi1E", "osc-onehot"),
                        ("ForcedOscILi2E", "osc-cubic"),
                        ("OscLevel", "level"), ("Tables", "data")),
    "erk_tableaus.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                        ("Rkck54", "rkck54"), ("Bs3", "bs3"),
                        ("Rkf45", "rkf45"), ("Rk4", "rk4"),
                        ("Vern7", "vern7"), ("Gbs10", "gbs10"),
                        ("Lorenz", "lorenz"), ("Sho", "sho"),
                        ("Ball", "ball"), ("Decay", "decay")),
    "sde_ensemble.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                        ("Gbm", "gbm"), ("Crn", "crn"), ("2EmE", "em"),
                        ("HeunStrat", "heun_strat"),
                        ("PlatenW2", "platen_w2"), ("Milstein", "milstein"),
                        ("Lb0E", "rng"), ("Lb1E", "table"),
                        ("sde_normals", "normals"), ("Ramp", "ramp"),
                        ("GbmBarrier", "barrier"),
                        ("RampSawtooth", "sawtooth"), ("GbmRate", "rate"),
                        ("Tables", "data")),
    "sde_adaptive_ensemble.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                                 ("Gbm", "gbm"), ("Crn", "crn"),
                                 ("2EmELb0E", "em"), ("HeunStrat", "heun_strat"),
                                 ("PlatenW2", "platen_w2"),
                                 ("8MilsteinELb0E", "milstein"),
                                 ("EmPair", "em pair"),
                                 ("MilsteinPair", "milstein pair"),
                                 ("Ramp", "ramp"), ("GbmBarrier", "barrier"),
                                 ("RampSawtooth", "sawtooth"),
                                 ("GbmRate", "rate"), ("Tables", "data")),
    "interp_lookup.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                         ("Li0E", "gather"), ("Li1E", "onehot"),
                         ("Li2E", "cubic"), ("Lb0E", "1d"), ("Lb1E", "2d")),
    "flash_attention_sm90.cu": (("sm90_kernel", "bf16"),
                                *((f"Li{d}E", f"hd={d}") for d in (64, 128)),
                                ("Lb0E", "noncausal"), ("Lb1E", "causal")),
    "flash_attention.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                           ("kernelI13__nv_bfloat16", "bf16"),
                           *((f"Li{d}E", f"hd={d}") for d in (16, 32, 64, 128,
                                                              256)),
                           ("Lb0E", "noncausal"), ("Lb1E", "causal")),
    "lu_solve.cu": (("lu_factor_kernel", "factor"),
                    ("lu_resolve_kernel", "resolve"),
                    ("kernelIf", "f32"), ("kernelId", "f64"),
                    *((f"Li{k}E", f"n={k}") for k in range(1, 9)),
                    ("Lb0E", "nopivot"), ("Lb1E", "pivot")),
    "rosenbrock_ensemble.cu": (("kernelIf", "f32"), ("kernelId", "f64"),
                               ("Ros23w", "rosenbrock23"),
                               ("Rodas4", "rodas4"), ("Rodas5p", "rodas5p"),
                               ("Rober", "rober"), ("Orego", "orego"),
                               ("Vdp", "vdp"), ("Lb0E", "eager"),
                               ("Lb1E", "lazyW"), ("Ball", "ball"),
                               ("Decay", "decay"), ("RoberHalf", "half"),
                               ("BallBounce", "bounce"),
                               ("DecayHalf", "half"), ("ForcedOsc", "osc"),
                               ("Tables", "data")),
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


def sass_listings(lib: Path) -> dict:
    """{mangled name: [(address, predicated, opcode, text)]} of every kernel
    in `lib` (opcodes without modifiers or predicates), read with
    cuobjdump."""
    from repro_torch.kernels.build import nvcc
    tool = Path(nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        t = ln.strip()
        if "Function :" in t:
            cur = funcs.setdefault(t.split("Function :", 1)[1].strip(), [])
        elif cur is not None and t.startswith("/*") and ";" in t:
            addr, body = t[2:].split("*/", 1)
            ops = body.split(";")[0].split()
            pred = bool(ops) and ops[0].startswith("@")
            ops = ops[1:] if pred else ops
            if ops:
                cur.append((int(addr, 16), pred, ops[0].split(".")[0],
                            " ".join(ops)))
    return funcs


def sass_mix(lib: Path, *keys: str) -> dict:
    """Opcode counts of the one kernel in `lib` whose mangled name holds
    every key."""
    hits = [rows for name, rows in sass_listings(lib).items()
            if all(k in name for k in keys)]
    if len(hits) != 1:
        raise AssertionError(f"sass: {len(hits)} kernels in {lib.name} match "
                             f"{keys}")
    counts = {}
    for _, _, op, _ in hits[0]:
        counts[op] = counts.get(op, 0) + 1
    return counts


# The FP64 pipe's opcodes on sm_90 (each one instruction at the FP64 rate).
FP64_PIPE = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
# One f64 division (`__ddiv_rn`), sqrt and pow, each alone in a kernel
# built with the port's nvcc flags, for `fp64_fast_paths`.
FP64_PROBE_CU = r"""
#include <cuda_runtime.h>
#include <cmath>
extern "C" __global__ void probe_div(const double* a, const double* b,
                                     double* o) {
  o[threadIdx.x] = __ddiv_rn(a[threadIdx.x], b[threadIdx.x]);
}
extern "C" __global__ void probe_sqrt(const double* a, const double* b,
                                      double* o) {
  o[threadIdx.x] = sqrt(a[threadIdx.x]);
}
extern "C" __global__ void probe_pow(const double* a, const double* b,
                                     double* o) {
  o[threadIdx.x] = pow(a[threadIdx.x], b[threadIdx.x]);
}
"""


# The pipe of each sm_90 opcode the f32 kernels issue (opcodes without
# modifiers), and each pipe's lanes per SM per clock, from the CUDA C++
# Programming Guide's throughput table for compute capability 9.0: FP32
# multiply-add 128 (with IMAD counted there, as the compiler moves integer
# adds onto it); integer add, logic, shifts, compares and min/max 64;
# conversions and the special functions (MUFU) 16.  An opcode of no pipe
# here (moves, branches, memory) counts only against the issue rate, one
# warp instruction per scheduler per clock (128 lanes an SM).
PIPE_OF = {**dict.fromkeys(("FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I",
                            "FMUL32I", "IMAD", "HFMA2", "HADD2", "HMUL2"),
                           "fma"),
           **dict.fromkeys(("IADD3", "LOP3", "SHF", "LEA", "ISETP", "FSETP",
                            "FMNMX", "IMNMX", "SEL", "FSEL", "PRMT", "IABS",
                            "SGXT", "BMSK", "PLOP3", "VIADD", "VIMNMX"),
                           "alu"),
           "MUFU": "mufu",
           **dict.fromkeys(("I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND",
                            "I2I"), "conv")}
PIPE_LANES_PER_SM = {"alu": 64, "fma": 128, "mufu": 16, "conv": 16,
                     "all": ISSUE_LANES_PER_SM}
MIX_KEYS = ("fp64", "mufu", "all", "alu", "fma", "conv")


def _path_mix(rows, start: int, stop_op: str, depth: int = 0) -> dict:
    """FP64-pipe, MUFU and all instructions from address `start` to the
    first unpredicated `stop_op`, with the routines that the CALLs on the
    way run to their RET, unless a predicated branch may jump over the CALL
    (a division's or sqrt's slow path: the fast one branches past it)."""
    index = {r[0]: i for i, r in enumerate(rows)}
    mix = {"fp64": 0, "mufu": 0, "all": 0}
    skip_to = -1   # the end of a block a predicated branch may jump over
    for addr, pred, op, text in rows[index[start]:]:
        if op == stop_op and not pred:
            break
        mix["all"] += 1
        mix["fp64"] += op in FP64_PIPE
        mix["mufu"] += op == "MUFU"
        if op == "BRA" and pred:
            skip_to = max(skip_to, int(text.split()[-1], 16))
        elif op == "CALL" and not pred and addr >= skip_to and depth < 4:
            target = int(text.split()[-1], 16)
            for key, v in _path_mix(rows, target, "RET", depth + 1).items():
                mix[key] += v
    return mix


def _target(text: str) -> int:
    """The address a BRA or CALL goes to (the last hex number of its
    text), or -1."""
    hits = re.findall(r"0x[0-9a-f]+", text)
    return int(hits[-1], 16) if hits else -1


def fast_path_mix(rows, start: int = 0, stop_op: str = "EXIT",
                  depth: int = 0) -> dict:
    """Instructions a pipe (`PIPE_OF`, "all" for every one) on a routine's
    fast path: from `start` to the first unpredicated `stop_op`, taking
    every forward branch (nvcc's libm routines branch forward past their
    slow paths: cosf past the Payne-Hanek reduction, a division or sqrt
    past the CALL of its slow routine, powf past its special cases),
    falling through backward ones, and running the routines of the CALLs
    on the way to their RET."""
    index = {r[0]: i for i, r in enumerate(rows)}
    mix = dict.fromkeys(MIX_KEYS, 0)
    i, seen = index[start], set()
    while i < len(rows) and i not in seen:
        seen.add(i)
        addr, pred, op, text = rows[i]
        if op == stop_op and not pred:
            break
        mix["all"] += 1
        mix["fp64"] += op in FP64_PIPE
        if op in PIPE_OF:
            mix[PIPE_OF[op]] += 1
        target = _target(text)
        if op == "BRA" and target > addr:
            i = index[target]
            continue
        if op == "CALL" and depth < 4:
            for key, v in fast_path_mix(rows, target, "RET",
                                        depth + 1).items():
                mix[key] += v
        i += 1
    return mix


def loop_mix(rows) -> dict:
    """The step loop of a kernel in its SASS: the backward branch that
    spans the most code and what it closes, with the inner loops (cosf's
    Payne-Hanek reduction, taken only for |x| >= 105615) left out.  Its
    instructions a pipe, counted once each as they stand (static, the
    special-value blocks of the libm routines included), and its
    opcodes."""
    back = [(_target(text), addr) for addr, _, op, text in rows
            if op == "BRA" and 0 <= _target(text) < addr]
    if not back:
        raise AssertionError("sass: no loop")
    head, end = max(back, key=lambda b: b[1] - b[0])
    inner = [(h, e) for h, e in back if head < h and e < end]
    mix = dict.fromkeys(MIX_KEYS, 0)
    ops = {}
    for addr, _, op, _ in rows:
        if head <= addr <= end and not any(h <= addr <= e for h, e in inner):
            mix["all"] += 1
            mix["fp64"] += op in FP64_PIPE
            if op in PIPE_OF:
                mix[PIPE_OF[op]] += 1
            ops[op] = ops.get(op, 0) + 1
    mix["inner_loops"] = len(inner)
    mix["opcodes"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return mix


def probe_unit(name: str, text: str):
    """A probe source as a unit of `kernels/build.py` (keyed by its text,
    every header and the flags)."""
    from repro_torch.translate.units import Unit
    return Unit(name, text)


def probe_library(name: str, text: str) -> Path:
    """The built library of a probe source (building it if needed)."""
    from repro_torch.kernels.build import build, library_path
    unit = probe_unit(name, text)
    build([unit])
    return library_path(unit)


def fp64_fast_paths() -> dict:
    """{"div" | "sqrt" | "pow": {"fp64": FP64-pipe instructions, "mufu":
    MUFU seeds, "all": instructions}} on the fast path of one operation,
    from the SASS of a probe compiled with the port's flags: the kernel's
    instructions up to its EXIT with the routines it calls unpredicated."""
    listings = sass_listings(probe_library("fp64_probe", FP64_PROBE_CU))
    return {op: _path_mix(listings[f"probe_{op}"], 0, "EXIT")
            for op in ("div", "sqrt", "pow")}


# The f32 operations of the fixed-dt SDE kernel (K4), each alone in a
# kernel built with the port's nvcc flags, for `f32_fast_paths`: the
# kernel's libm calls and intrinsics, and one counter normal of
# threefry.cuh (Threefry-2x32-20 and Box-Muller, as the kernel draws it);
# `probe_base` (a load and a store) is subtracted from each.
F32_PROBE_CU = r"""
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include "threefry.cuh"
#define PROBE(name, expr)                                               \
  extern "C" __global__ void probe_##name(const float* a, const float* b, \
                                          float* o) {                   \
    const unsigned i = threadIdx.x;                                     \
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a);           \
    const uint32_t* k = reinterpret_cast<const uint32_t*>(b);           \
    o[i] = (expr);                                                      \
  }
PROBE(base, a[i])
PROBE(logf, logf(a[i]))
PROBE(cosf, cosf(a[i]))
PROBE(sqrtf, sqrtf(a[i]))
PROBE(fsqrt_rn, __fsqrt_rn(a[i]))
PROBE(powf, powf(a[i], b[i]))
PROBE(fdiv_rn, __fdiv_rn(a[i], b[i]))
PROBE(uint2float_rn, __uint2float_rn(w[i]))
PROBE(normal, repro_rng::counter_normal(k[0], k[1], k[2], w[i]))
"""
F32_PROBES = ("logf", "cosf", "sqrtf", "fsqrt_rn", "powf", "fdiv_rn",
              "uint2float_rn", "normal")


def f32_fast_paths() -> dict:
    """{op: {pipe: instructions}} on the fast path of each f32 operation
    of `F32_PROBE_CU` (`fast_path_mix` to EXIT, less `probe_base`), from
    the SASS of a probe compiled with the port's flags."""
    listings = sass_listings(probe_library("f32_probe", F32_PROBE_CU))
    base = fast_path_mix(listings["probe_base"])
    out = {}
    for op in F32_PROBES:
        mix = fast_path_mix(listings[f"probe_{op}"])
        out[op] = {k: max(0, mix[k] - base[k]) for k in MIX_KEYS}
    return out


# K4's rows: the mangled-name fragments of each row's instantiation, its
# Wiener processes, and its float work a step besides the normals, as the
# kernel writes it with every repeated sub-expression counted once (the
# least work of the step): divisions, square roots, pows, min/max,
# conversions (the step index to float; a table lookup's floor) and the
# other adds and multiplies, which the no-event, no-data forms may fuse
# in pairs (`contracted`).  crn: the Hill term once (2 pows, 1 division,
# 4 more), the drift's 3 divisions, the noise's 4 distinct u/tau, 6
# distinct square roots and maxima, 21 adds and multiplies (negation is
# an operand modifier), the update 12, t 2.  gbm em: 18 and t 2; platen_w2
# 87 and t 2 besides the 3 divisions by sqrt(dt); the barrier form: em's
# and the condition (`event_ops`); the rate table: the lookup's division,
# clamp and floor, 7 more, and the step's 7.
K4_ROWS = {
    "gbm-1M-em": (("sde_ensemble_kernelIf", "3Gbm", "2EmELb0E", "7NoEvent",
                   "6NoData"), 3,
                  dict(simple=20, conv=1, contracted=True)),
    "gbm-1M-platen_w2": (("sde_ensemble_kernelIf", "3Gbm", "8PlatenW2",
                          "Lb0E", "7NoEvent", "6NoData"), 3,
                         dict(simple=89, fdiv_rn=3, conv=1,
                              contracted=True)),
    "crn-1M-em": (("sde_ensemble_kernelIf", "3Crn", "2EmELb0E", "7NoEvent",
                   "6NoData"), 8,
                  dict(simple=44, powf=2, fdiv_rn=8, sqrtf=6, alu=6, conv=1,
                       contracted=True)),
    "gbm-1M-em-barrier": (("sde_ensemble_kernelIf", "3Gbm", "2EmELb0E",
                           "10GbmBarrier"), 3,
                          dict(simple=20, conv=1, contracted=False)),
    "gbm-rate-1M-em": (("sde_ensemble_kernelIf", "7GbmRate", "2EmELb0E",
                        "6Tables"), 1,
                       dict(simple=14, fdiv_rn=1, alu=2, conv=2,
                            contracted=False)),
}


def k4_bound_instr(row: str, steps: int, fast: dict, extra_ops: int = 0):
    """K4's bound in the card's instructions on `steps` active lane-steps:
    (ms, pipe, {pipe: ms}).  A step issues its m normals at
    `f32_fast_paths`' counter normal and one multiply each (dW = z
    sqrt(dt)), each division, sqrt and pow of `K4_ROWS` at its fast path,
    the min/max on the ALU pipe, the conversions, and the other float
    operations on the FMA pipe, one instruction for two where the form
    contracts; `extra_ops` (the event forms' condition work, rounded
    alone) on the FMA pipe.  Each pipe's time is its instructions over its
    lanes an SM a clock (`PIPE_LANES_PER_SM`), the issue time all of them
    over 128; the bound is the largest."""
    _, m, step = K4_ROWS[row]
    per = dict.fromkeys(PIPE_LANES_PER_SM, 0.0)

    def add(mix, k=1.0):
        for pipe in per:
            per[pipe] += k * mix.get(pipe, 0)

    add(fast["normal"], m)
    add({"fma": 1, "all": 1}, m)
    for op in ("powf", "fdiv_rn", "sqrtf"):
        add(fast[op], step.get(op, 0))
    simple = step["simple"] / (2 if step["contracted"] else 1)
    add({"fma": simple, "all": simple})
    add({"alu": step.get("alu", 0), "conv": step.get("conv", 0),
         "all": step.get("alu", 0) + step.get("conv", 0)})
    times = {pipe: (per[pipe] * steps + (extra_ops if pipe in ("fma", "all")
                                         else 0))
             / (PIPE_LANES_PER_SM[pipe] * SM_LANE_CLOCKS_PER_S) * 1e3
             for pipe in per}
    pipe = max(times, key=times.get)
    return times[pipe], pipe, times


def k4_sass_report(row: str) -> dict:
    """Registers and spills of a K4 row's instantiation, and its step
    loop's pipe mix and opcodes (`loop_mix`) in this build's SASS."""
    from repro_torch.kernels.build import build_log, library_path
    from repro_torch.kernels.em.kernel import SOURCE
    t = time.perf_counter()
    keys = K4_ROWS[row][0]
    if SOURCE not in BUILD_LOGS:
        BUILD_LOGS[SOURCE] = build_log(SOURCE) or ptxas_log(SOURCE)
    lib = library_path(SOURCE)
    if lib not in SASS_CACHE:
        SASS_CACHE[lib] = sass_listings(lib)
    hits = [rows for name, rows in SASS_CACHE[lib].items()
            if all(k in name for k in keys)]
    if len(hits) != 1:
        raise AssertionError(f"sass: {len(hits)} kernels match {keys}")
    out = {"registers": ptxas_entry(BUILD_LOGS[SOURCE], keys),
           "loop": loop_mix(hits[0])}
    REPORT_S["register reports"] += time.perf_counter() - t
    return out


def k4_row_extra(row: str, steps: int, extra_ops: int = 0) -> dict:
    """The K4 keys of a kernels-line row: bound_instr_ms and its pipe, the
    pipes' times, registers, the step loop's pipe mix; printed too."""
    b, pipe, times = k4_bound_instr(row, steps, F32_FAST, extra_ops)
    rep = k4_sass_report(row)
    loop = {k: rep["loop"][k] for k in MIX_KEYS if k != "fp64"}
    print(f"{row}: bound in the card's instructions {b:.4f} ms by {pipe} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f" ms); registers {rep['registers']}; step loop in the SASS "
          + json.dumps(loop) + ", opcodes "
          + json.dumps(dict(list(rep["loop"]["opcodes"].items())[:16])))
    return {"bound_instr_ms": b, "bound_instr_pipe": pipe,
            "bound_instr_times": times, "registers": rep["registers"],
            "step_loop": loop}


# K1's rows: the mangled-name fragments of each row's instantiation, and
# its form for `k1_work`: the tableau, the state size, the RHS's float
# operations besides a lookup and the multiply-add pairs among them that
# may fuse (Lorenz 9 and 3; the ball none, its negation an operand
# modifier; the forced oscillator 4, none fused), the lookup mode of the
# data forms, whether every operation rounds alone (`Rounded`: the event
# and data forms, and vern7) and the event's condition and affect
# instructions.
K1_ROWS = {
    "lorenz-1M-f32-adaptive": (("kernelIf", "5Tsit5", "6Lorenz", "7NoEvent",
                                "6NoData"), dict(n=3, rhs=(9, 3))),
    "lorenz-1M-f32-fixed": (("kernelIf", "5Tsit5", "6Lorenz", "7NoEvent",
                             "6NoData"), dict(n=3, rhs=(9, 3))),
    "ball-1M-tsit5-events": (("kernelId", "5Tsit5", "4BallEN",
                              "10BallBounce"),
                             dict(n=2, rhs=(0, 0), rounded=True, cond=0,
                                  affect=1)),
    "ball-1M-tsit5-events-f32": (("kernelIf", "5Tsit5", "4BallEN",
                                  "10BallBounce"),
                                 dict(n=2, rhs=(0, 0), rounded=True, cond=0,
                                      affect=1)),
    "osc-1M-f32-fixed-gather": (("kernelIf", "5Tsit5", "ForcedOscILi0E",
                                 "7NoEvent", "6Tables"),
                                dict(n=2, rhs=(4, 0), rounded=True,
                                     lookup="gather")),
    "osc-1M-f32-fixed-onehot": (("kernelIf", "5Tsit5", "ForcedOscILi1E",
                                 "7NoEvent", "6Tables"),
                                dict(n=2, rhs=(4, 0), rounded=True,
                                     lookup="onehot")),
    "osc-1M-f32-fixed-cubic": (("kernelIf", "5Tsit5", "ForcedOscILi2E",
                                "7NoEvent", "6Tables"),
                               dict(n=2, rhs=(4, 0), rounded=True,
                                    lookup="cubic")),
    "osc-1M-f64-adaptive": (("kernelId", "5Tsit5", "ForcedOscILi0E",
                             "7NoEvent", "6Tables"),
                            dict(n=2, rhs=(4, 0), rounded=True,
                                 lookup="gather")),
    "osc-1M-tsit5-data-event": (("kernelId", "5Tsit5", "ForcedOscILi0E",
                                 "8OscLevel", "6Tables"),
                                dict(n=2, rhs=(4, 0), rounded=True,
                                     lookup="gather", cond=1, affect=0)),
    "lorenz-1M-f32-vern7-adaptive": (("kernelIf", "5Vern7", "6Lorenz",
                                      "7NoEvent", "6NoData"),
                                     dict(n=3, rhs=(9, 3), tab="vern7",
                                          rounded=True)),
}
# One 1-D table lookup of interp.cuh as the kernel writes it, every
# operation rounded alone: `locate` (a subtraction, a division, the clamp's
# and the NaN test's three compares, floor, the conversions to int and
# back, the weight's subtraction), the cell's integer clamp, the reads
# (`__ldg`) with their address arithmetic, and the blend (gather and
# onehot: 1 - w, two products, a sum; cubic: the Catmull-Rom weights' 18
# operations, four products and three sums, four clamped indices).
K1_LOOKUP = {
    "gather": dict(arith=6, cmp=3, div=1, conv=3, int=4, ldg=2),
    "onehot": dict(arith=6, cmp=3, div=1, conv=3, int=4, ldg=2),
    "cubic": dict(arith=27, cmp=3, div=1, conv=3, int=14, ldg=4),
}
# the instruction classes of `k1_work` and the f32 pipe of each (the FP64
# pipe takes arith and cmp in f64); loads and stores issue only
K1_PIPE = {"arith": "fma", "cmp": "alu", "int": "alu", "conv": "conv",
           "ldg": None, "stg": None}


def k1_work(row: str, *, attempts: int, accepted: int, saves: int,
            stores: int, adaptive: bool, hits: int = 0, reanchors: int = 0,
            bisect_iters: int = 30) -> dict:
    """K1's instructions on a run, by class (`K1_PIPE`, and "div", "sqrt",
    "pow" counted as operations), as the kernel writes them: a float add,
    multiply, compare, min or max one instruction, a multiply and the add
    it feeds one where the form contracts (`Contracting`), two where it
    rounds every operation alone (`Rounded`; a NaN-propagating max or min
    two compares).  Per attempt: dt_step, the s - 1 stages (their sums,
    t_i where the RHS reads t, the RHS and its lookup), the b sum, and
    where adaptive the btilde sum, the scaled RMS norm (n + 1 divisions, a
    sqrt) and the PI controller (two pows); per accepted step the save
    scan, and in an event form the condition at both ends, the sign tests
    and k1 evaluated again (FSAL off); per interpolated save theta (a
    division) and the dense output (Tsitouras' weights, 46 operations, 43
    where three pairs fuse, and 15 (8) a state; Hermite's 12 (10) and 7 (4)
    a state); every save stored; per hit `bisect_iters` midpoints, each an
    interpolant, a condition and the bracket update, then the root's
    interpolant and the affect; per re-anchored start one interpolant and a
    condition.  Integer loop work 4 an attempt."""
    from repro_torch.core.tableaus import get_tableau
    cfg = K1_ROWS[row][1]
    tab = get_tableau(cfg.get("tab", "tsit5"))
    n, R = cfg["n"], cfg.get("rounded", False)
    lookup = K1_LOOKUP.get(cfg.get("lookup"), {})
    event = "cond" in cfg
    nz = lambda row_: int(np.count_nonzero(row_))
    total: dict = {}

    def add(count, **work):
        for k, v in work.items():
            total[k] = total.get(k, 0) + count * v

    def pairs(k):          # k multiply-adds: 2k rounded, k contracted
        return 2 * k if R else k

    def rhs_eval(count):
        ops, fused = cfg["rhs"]
        add(count, arith=ops - (0 if R else fused))
        add(count, **lookup)

    # ---- an attempt ------------------------------------------------------
    add(attempts, arith=1, cmp=2, int=4)                 # dt_step, loop
    for i in range(1, tab.stages):
        add(attempts, arith=n * (pairs(nz(tab.a[i, :i])) + (1 if R else 0)))
        if lookup:                                       # t_i = t + c_i dt
            add(attempts, arith=pairs(1))
    rhs_eval(attempts * (tab.stages - 1))
    add(attempts, arith=n * (pairs(nz(tab.b)) + (1 if R else 0)) + 1,
        cmp=1)                                           # ucand, t_end, done
    if adaptive:
        add(attempts, arith=n * (pairs(nz(tab.btilde)) - (1 if R else 0)
                                 + 1),
            div=n + 1, sqrt=1, pow=2)
        add(attempts, arith=n * (pairs(1) + pairs(1)) - (1 if R else 0) + 3,
            cmp=3 * n + 17)
    # ---- an accepted step ------------------------------------------------
    add(accepted, arith=2, cmp=4, ldg=2)                 # the save scan
    if not tab.fsal or event:
        rhs_eval(accepted)                               # k1 at the new point
    if event:
        add(accepted, arith=2 * cfg["cond"] + 1, cmp=8)
    # ---- dense output ----------------------------------------------------
    if tab.interp_bpoly is not None:
        interp = dict(arith=(46 if R else 43) + n * (15 if R else 8))
    else:
        interp = dict(arith=(12 if R else 10) + 2 + n * (7 if R else 4))
    add(saves, arith=1, div=1, cmp=4)
    add(saves, **interp)
    add(stores, stg=n)
    # ---- events: bisection on the hits, re-anchored starts ---------------
    if event:
        per_mid = dict(arith=2 + cfg["cond"] + pairs(1) + 1, cmp=3)
        add(hits * bisect_iters, **per_mid)
        add(hits * (bisect_iters + 1), **interp)
        add(hits, arith=pairs(1) + cfg["affect"])
        add(reanchors, arith=cfg["cond"] + pairs(1))
        add(reanchors, **interp)
    return total


def k1_bound_instr(work: dict, f64: bool, bytes_ms: float):
    """K1's bound in the card's instructions on `work` (`k1_work`):
    (ms, by, {pipe: ms}).  f64: the FP64 pipe's instructions (each float
    operation one, each division, sqrt and pow its fast path's FP64-pipe
    instructions in this build's SASS, `fp64_fast_paths`) over the FP64
    instruction rate (`bound_instr_ms`).  f32: each pipe's instructions
    (`K1_PIPE`; a division, sqrtf and powf at `f32_fast_paths`' mix) over
    its lanes an SM a clock, and every instruction over the issue rate
    (`k4_bound_instr`'s rule).  The larger of that and the bytes bound."""
    if f64:
        ops = work.get("arith", 0) + work.get("cmp", 0)
        special = {op: work.get(op, 0) for op in ("div", "sqrt", "pow")}
        times = {"fp64": bound_instr_ms(ops + sum(special.values()), special,
                                        FP64_FAST)}
    else:
        per = dict.fromkeys(PIPE_LANES_PER_SM, 0.0)
        for cls, pipe in K1_PIPE.items():
            if pipe:
                per[pipe] += work.get(cls, 0)
            per["all"] += work.get(cls, 0)
        for op, probe in (("div", "fdiv_rn"), ("sqrt", "sqrtf"),
                          ("pow", "powf")):
            for pipe in per:
                per[pipe] += work.get(op, 0) * F32_FAST[probe].get(pipe, 0)
        times = {pipe: per[pipe] / (PIPE_LANES_PER_SM[pipe]
                                    * SM_LANE_CLOCKS_PER_S) * 1e3
                 for pipe in per}
    times["bytes"] = bytes_ms
    by = max(times, key=times.get)
    return times[by], by, times


def k1_row_extra(row: str, ms: float, stats, work: dict, f64: bool,
                 bytes_ms: float, hits: int = 0) -> dict:
    """The K1 keys of a kernels-line row: bound_instr_ms and by what, the
    pipes' times, the warp SIMT efficiency of the row's own attempts
    (`simt_efficiency`, one trajectory a thread), registers and spills
    (`ptxas_entry` on the build's report) and, in an event form, the share
    of accepted steps that hit; printed too."""
    from repro_torch.kernels.build import build_log
    from repro_torch.kernels.queue import simt_efficiency
    from repro_torch.kernels.tsit5.kernel import source_of
    t = time.perf_counter()
    b, by, times = k1_bound_instr(work, f64, bytes_ms)
    st = stats.long()
    eff = simt_efficiency(st[0] + st[1])
    keys = K1_ROWS[row][0]
    src = source_of(K1_ROWS[row][1].get("tab", "tsit5"))
    if src not in BUILD_LOGS:
        BUILD_LOGS[src] = build_log(src) or ptxas_log(src)
    regs = ptxas_entry(BUILD_LOGS[src], keys)
    out = {"bound_instr_ms": b, "bound_instr_by": by,
           "bound_instr_times": times, "simt_efficiency": eff,
           "registers": regs,
           "instructions": {k: int(v) for k, v in work.items()}}
    note = ""
    if "cond" in K1_ROWS[row][1]:
        out["hit_share"] = hits / max(1, int(st[0].sum()))
        note = f", hits {hits} ({out['hit_share']:.2e} of accepted steps)"
    REPORT_S["register reports"] += time.perf_counter() - t
    print(f"{row}: bound in the card's instructions {b:.4f} ms by {by} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"), kernel / it {ms / b:.2f}x, SIMT efficiency {eff:.4f}, "
          f"registers {regs}{note}; instructions "
          + json.dumps(out["instructions"]))
    return out


def k1_saves(sv, t0: float, t_final):
    """(saves interpolated, saves stored) of a K1 run: the save points
    after t0 and at or before each lane's end (within the save tolerance,
    1e-7 max(|t|, 1)) are interpolated; every point is stored."""
    tf_ = t_final.double()
    s = sv.double().to(tf_.device)
    eps = 1e-7 * tf_.abs().clamp_min(1.0)
    crossed = (s[:, None] > t0) & (s[:, None] <= (tf_ + eps)[None, :])
    return int(crossed.sum()), int(s.numel() * tf_.numel())


# mangled-name fragments of the K3 and K5 instantiations on the rows
K35_KEYS = {
    "rober-1M-rodas5p": ("rosenbrock_kernelId", "7Rodas5p", "5RoberELb0E",
                         "7NoEvent", "6NoData"),
    "rober-1M-rodas4-eager": ("rosenbrock_kernelId", "6Rodas4",
                              "5RoberELb0E", "7NoEvent", "6NoData"),
    "rober-1M-rodas4-lazyW": ("rosenbrock_kernelId", "6Rodas4",
                              "5RoberELb1E", "7NoEvent", "6NoData"),
    "rober-1M-rodas5p-event": ("rosenbrock_kernelId", "7Rodas5p",
                               "5RoberELb0E", "9RoberHalf"),
    "osc-1M-rosenbrock23-data": ("rosenbrock_kernelId", "6Ros23w",
                                 "9ForcedOscELb0E", "6Tables"),
    "gbm-1M-em-adaptive": ("sde_adaptive_kernelIf", "3Gbm", "6EmPair",
                           "7NoEvent", "6NoData"),
    "gbm-1M-em-adaptive-doubling": ("sde_adaptive_kernelIf", "3Gbm",
                                    "2EmELb0E", "7NoEvent", "6NoData"),
    "gbm-1M-em-adaptive-barrier": ("sde_adaptive_kernelIf", "3Gbm",
                                   "6EmPair", "10GbmBarrier"),
    "gbm-rate-1M-em-adaptive": ("sde_adaptive_kernelIf", "7GbmRate",
                                "6EmPair", "6Tables"),
}
# the nvcc reports of the last build (phase_build), per source, and the
# fast paths of an f64 division, sqrt and pow in this build's SASS
BUILD_LOGS: dict = {}
FP64_FAST: dict = {}
F32_FAST: dict = {}
SASS_CACHE: dict = {}
# seconds of the work behind the K3, K4, K5 and K6 reports, and of each
# phase
REPORT_S = {"probes": 0.0, "register reports": 0.0, "K6 at 2^16": 0.0}
PHASE_S: dict = {}


def ptxas_entry(log: str, keys) -> str:
    """'N registers, spills' of the one kernel in nvcc's -Xptxas=-v report
    whose mangled name holds every key."""
    lines, hits = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and all(k in ln for k in keys):
            spill, regs = "", ""
            for nxt in lines[i + 1:i + 6]:
                if "spill stores" in nxt:
                    spill = nxt.strip()
                if "Used" in nxt and "registers" in nxt:
                    regs = nxt.split("Used", 1)[1].split(",")[0].strip()
                    break
            hits.append(f"{regs}, {spill}")
    if len(hits) != 1:
        raise AssertionError(f"ptxas: {len(hits)} kernels match {keys}")
    return hits[0]


def row_registers(form: str) -> str:
    """The registers and spills of the K3 or K5 instantiation of a row."""
    from repro_torch.kernels.build import build_log
    from repro_torch.kernels.em.adaptive import SOURCE as K5_SOURCE
    from repro_torch.kernels.rosenbrock.kernel import SOURCE as RB_SOURCE
    t = time.perf_counter()
    keys = K35_KEYS[form]
    src = RB_SOURCE if keys[0].startswith("rosenbrock") else K5_SOURCE
    if src not in BUILD_LOGS:
        BUILD_LOGS[src] = build_log(src) or ptxas_log(src)
    out = ptxas_entry(BUILD_LOGS[src], keys)
    REPORT_S["register reports"] += time.perf_counter() - t
    return out


def phase_build(device):
    """Every source of csrc/, the fast-path probes and the translation's
    generated units (traced and emitted first, on `phase_translate`'s
    inputs) in one parallel nvcc call.  Returns what `phase_translate`
    takes: its inputs, its form cases and the units."""
    from repro_torch.kernels.build import build, library_path
    from repro_torch.kernels.em.adaptive import SOURCE as K5_SOURCE
    from repro_torch.kernels.em.kernel import SOURCE as SDE_SOURCE
    from repro_torch.kernels.flashattn.kernel import SOURCE as K7_SOURCE
    from repro_torch.kernels.flashattn.kernel import SM90_SOURCE
    from repro_torch.kernels.lu.kernel import SOURCE as LU_SOURCE
    from repro_torch.kernels.rosenbrock.kernel import SOURCE as RB_SOURCE
    from repro_torch.kernels.interp import SOURCE as LOOKUP_SOURCE
    from repro_torch.kernels.tsit5.kernel import SOURCE, TABLEAUS_SOURCE
    sources = [SOURCE, TABLEAUS_SOURCE, SDE_SOURCE, LU_SOURCE, RB_SOURCE,
               K5_SOURCE, LOOKUP_SOURCE, K7_SOURCE, SM90_SOURCE]
    t = time.perf_counter()
    prepared = translate_prepare(device)
    trace_s = time.perf_counter() - t
    t = time.perf_counter()
    logs = build(sources + [probe_unit("fp64_probe", FP64_PROBE_CU),
                            probe_unit("f32_probe", F32_PROBE_CU)]
                 + prepared[2])
    secs = time.perf_counter() - t
    BUILD_LOGS.update({s: logs[s] for s in sources if s in logs})
    for src in sources:
        if src in logs:
            print(f"build {src}: " + "; ".join(ptxas_summary(logs[src], src)))
    print(f"build: {secs:.1f} s ({len(logs)} compiled: {len(sources)} "
          f"sources, 2 probes and the translation's {len(prepared[2])} "
          f"generated units, traced and emitted in {trace_s:.2f} s)")
    t = time.perf_counter()
    FP64_FAST.update(fp64_fast_paths())
    F32_FAST.update(f32_fast_paths())
    REPORT_S["probes"] = time.perf_counter() - t
    print("fp64 fast paths (FP64-pipe instructions, MUFU, all up to EXIT): "
          + json.dumps(FP64_FAST))
    print("f32 fast paths (instructions a pipe, all up to EXIT): "
          + json.dumps(F32_FAST))
    # the integer instruction mix behind the SDE kernel's bound: one normal
    # per thread in the normals kernel; 3 normals per step in f32 em/gbm
    lib = library_path(SDE_SOURCE)
    for what, keys in (("normals", ("sde_normals_kernel",)),
                       ("f32 em/gbm rng", ("sde_ensemble_kernelIf", "3Gbm",
                                           "2EmE", "Lb0E", "NoEvent"))):
        mix = sass_mix(lib, *keys)
        ints = {op: mix.get(op, 0) for op in ("SHF", "LOP3", "PRMT", "IADD3",
                                              "IMAD")}
        print(f"sass {what}: {sum(mix.values())} instructions, integer "
              + json.dumps(ints))
    # K7's tensor-core form on the LM path: wgmma and TMA in its SASS, no
    # spills in ptxas's report
    mix = sass_mix(library_path(SM90_SOURCE), "flash_sm90_kernel",
                   "Li128ELb1E")
    report = [e for e in ptxas_summary(logs.get(SM90_SOURCE)
                                       or ptxas_log(SM90_SOURCE), SM90_SOURCE)
              if e.startswith("bf16,hd=128,causal:")]
    print(f"sass K7 sm90 bf16 hd=128 causal: HGMMA {mix.get('HGMMA', 0)}, "
          f"UTMALDG {mix.get('UTMALDG', 0)}; ptxas {report}")
    if not (mix.get("HGMMA") and mix.get("UTMALDG")):
        raise AssertionError("K7's sm90 form compiled without HGMMA or "
                             "UTMALDG")
    if len(report) != 1 or "0 bytes spill stores, 0 bytes spill loads" \
            not in report[0]:
        raise AssertionError(f"K7's sm90 form spills: {report}")
    return prepared


def ptxas_log(source: str) -> str:
    """nvcc's -Xptxas=-v report of `source`, compiled once more into a
    scratch library (for a build that was already cached)."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, library_path, nvcc
    tmp = library_path(source).with_suffix(".report.tmp")
    try:
        return subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(CSRC / source)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              check=True).stdout
    finally:
        tmp.unlink(missing_ok=True)


def profiled_device_ms(fn) -> float:
    """The card's time in one fn(), after a warm-up: the summed durations
    of the kernels and copies that `torch.profiler` saw it run (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("torch.profiler saw no device time")
    return us / 1e3


def host_ms(fn, reps: int) -> float:
    """Median host time of fn() from an idle card: `perf_counter` around
    the call, with no synchronisation after it, so it counts the host's
    own work and every wait for the card inside the call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def k2_times(staged, one, reps: int, launches=None) -> dict:
    """K2's staged front door and the one-launch front door: each one's ms
    (CUDA events around it, `cuda_ms`), the two timed in turns, its device
    ms and its host ms (`host_ms`).  Device ms: CUDA events around
    `launches`, the pair of wrapper calls that make each one's launches
    (their host work a small share of the kernels' time), or else
    `profiled_device_ms` (`torch.profiler`, whose CUPTI tracing slows every
    later launch of the process: the smoke passes `launches`)."""
    out = {"staged_ms": [], "one_ms": []}
    for _ in range(reps):
        out["staged_ms"].append(cuda_ms(staged, 1))
        out["one_ms"].append(cuda_ms(one, 1))
    out = {k: statistics.median(v) for k, v in out.items()}
    if launches is None:
        device = (profiled_device_ms(staged), profiled_device_ms(one))
    else:
        device = tuple(cuda_ms(fn, reps) for fn in launches)
    out.update(staged_device_ms=device[0], one_device_ms=device[1],
               staged_host_ms=host_ms(staged, reps),
               one_host_ms=host_ms(one, reps))
    return out


# K1's f64 parity cases on Lorenz (phase_parity): (tableau, adaptive, bar,
# settings besides rtol = atol = 1e-8 and dt0 = 1e-3).  The contracted
# forms hold per-lane counts identical and states within 1e-10 (fixed dt
# 1e-12); rkck54, vern7 and gbs10, compiled `Rounded`
# (csrc/erk_tableaus.cu), hold bit for bit (bar None).  The plain versions
# step on the host, so a case costs its steps: bs3, third order, runs at
# 1e-6 (about 300 steps, not 1200) and rk4 at dt 2^-7.
K1_PARITY = (("tsit5", True, 1e-10, {}), ("tsit5", False, 1e-12, {}),
             ("dopri5", True, 1e-10, {}), ("rkck54", True, None, {}),
             ("bs3", True, 1e-10, dict(rtol=1e-6, atol=1e-6)),
             ("rkf45", True, 1e-10, {}),
             ("rk4", False, 1e-12, dict(dt0=2.0 ** -7)),
             ("vern7", True, None, {}), ("gbs10", True, None, {}))


def k1_parity(device, N: int, cases=K1_PARITY, raise_on_fail=True):
    """f64 Lorenz (11 saves on [0, 1]), each case of `cases` through the
    front door on the kernel and on the plain version on the same card:
    {name: (lanes with other counts, rel err of us and u_final,
    bitwise)}; raises where a case misses its bar."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    ep = lorenz_inputs(N, torch.float64, device)
    saveat = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
    out = {}
    for alg, adaptive, tol, settings in cases:
        common = dict(dict(rtol=1e-8, atol=1e-8, dt0=1e-3), **settings,
                      t0=0.0, tf=1.0, saveat=saveat, device=device,
                      ensemble="kernel")
        name = (f"{alg} adaptive rtol={common['rtol']:g}" if adaptive
                else f"{alg} fixed dt={common['dt0']:g}")
        kw = dict(alg=alg, adaptive=adaptive)
        before = erk_kernel.launches
        rk = solve_ensemble_local(ep, backend="cuda", **common, **kw)
        rt = solve_ensemble_local(ep, backend="torch", **common, **kw)
        if device.type == "cuda" and erk_kernel.launches != before + 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        other = int(((rk.naccept != rt.naccept)
                     | (rk.nreject != rt.nreject)).sum())
        errs = (rel_err(rk.us, rt.us), rel_err(rk.u_final, rt.u_final))
        bitwise = all(torch.equal(getattr(rk, k), getattr(rt, k))
                      for k in ("us", "u_final", "t_final", "naccept",
                                "nreject", "nf", "status"))
        out[name] = (other, max(errs), bitwise)
        bar = "bitwise" if tol is None else f"{tol:g}"
        print(f"parity {name}: N={N} f64 lanes with other counts {other}, "
              f"rel err us {errs[0]:.3e} u_final {errs[1]:.3e}, bitwise "
              f"{bitwise} (bar {bar}), attempts "
              f"{int((rk.naccept + rk.nreject).sum())}, nf {int(rk.nf)}")
        ok = (other == 0 and int(rk.status) == int(rt.status)
              and int(rk.nf) == int(rt.nf)
              and (bitwise if tol is None else max(errs) <= tol))
        if raise_on_fail and not ok:
            raise AssertionError(f"{name}: misses its bar ({bar}): other "
                                 f"counts on {other} lanes, rel err "
                                 f"{max(errs):.3e}, bitwise {bitwise}")
    return out


def phase_parity(device, N: int = PARITY_N):
    """K1 against its plain version on the same card (f64 Lorenz, every
    tableau, `k1_parity`); K2's staged fixed-dt runs bitwise one launch
    (tsit5 and vern7) and against K1's plain version; K2's front doors
    silent under `torch.cuda.set_sync_debug_mode("error")` with the grid
    on the host; K2's time, split into device (CUDA events around the
    wrapper's launches) and host."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.ensemble_kernel import save_segments
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda

    worst = {k: v[1] for k, v in k1_parity(device, N).items()}
    ep = lorenz_inputs(N, torch.float64, device)
    u0s, ps = ep.materialize()
    # staged fixed-dt: chunk-aligned dyadic grid -> bitwise one launch
    grid = torch.arange(1, 9, dtype=torch.float64) / 8.0     # on the host
    kw = dict(t0=0.0, tf=1.0, dt0=2.0 ** -10, saveat=grid, rtol=1e-8,
              atol=1e-8, adaptive=False)
    for alg in ("vern7", "tsit5"):
        tab = get_tableau(alg)
        one = solve_ensemble_cuda(ep.prob, u0s, ps, tab, save_chunks=1, **kw)
        # ---- K2's path, with the launch count read around it ------------
        erk_kernel.launches = 0
        three = solve_ensemble_cuda(ep.prob, u0s, ps, tab, save_chunks=3,
                                    **kw)
        sync(device)
        launches = erk_kernel.launches
        if device.type == "cuda" and launches != 3:
            raise AssertionError(f"staged run: expected 3 launches, got "
                                 f"{launches}")
        for field in ("us", "u_final", "t_final", "naccept"):
            if not torch.equal(getattr(one, field), getattr(three, field)):
                raise AssertionError(f"staged fixed-dt {alg} {field} is not "
                                     "bitwise equal to the single launch")
        print(f"parity staged fixed-dt {alg} save_chunks=3: bitwise equal "
              f"to one launch, launches {launches}")
    # ---- the staged run against K1's plain version on the same inputs --
    f = ep.prob.f
    t = time.perf_counter()
    plain = erk_kernel._plain(f, tab, u0s.T.contiguous(), ps.T.contiguous(),
                              grid.to(device), 0.0, 1.0, 2.0 ** -10, 1e-8,
                              1e-8, False, 100_000)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    k2_err = max(float((three.us - plain[0].permute(2, 0, 1)).abs().max()),
                 float((three.u_final - plain[1].T).abs().max()))
    if k2_err > K2_TOL:
        raise AssertionError(f"staged fixed-dt against the plain version: "
                             f"max abs {k2_err:.3e} > {K2_TOL}")
    print(f"parity staged fixed-dt tsit5 save_chunks=3: max abs against the "
          f"plain version {k2_err:.3e} (bar {K2_TOL:g})")

    # ---- K2 reads nothing back from the card: the staged driver, and the
    # front door on a grid it stages by the reference's count -----------
    big = np.linspace(0.01, 1.0, 2000)
    front = dict(ensemble="kernel", backend="cuda", t0=0.0, tf=1.0,
                 dt0=1e-3, rtol=1e-8, atol=1e-8, saveat=big, device=device)
    staged = lambda: solve_ensemble_cuda(ep.prob, u0s, ps, tab,
                                         save_chunks=3, **kw)
    staged()
    solve_ensemble_local(ep, **front)
    sync(device)
    erk_kernel.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        staged()
        solve_ensemble_local(ep, **front)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync(device)
    print(f"K2 without a sync (set_sync_debug_mode('error'), grid on the "
          f"host): the staged driver (3 launches) and the front door on "
          f"{big.size} saves ({erk_kernel.launches - 3} launches)")

    # ---- K2's time: the staged driver on this case, against one launch,
    # device and host apart, with K1's bound over the same work (f64
    # operations at the FP64 peak: the no-event kernel contracts products
    # into fused multiply-adds) -----------------------------------------
    u0_l, p_l, grid_l = u0s.T.contiguous(), ps.T.contiguous(), grid.to(device)
    segments = save_segments(grid.tolist(), 3, 0.0, 1.0)
    raw = dict(dt0=2.0 ** -10, rtol=1e-8, atol=1e-8, adaptive=False,
               max_iters=100_000)
    times_k2 = k2_times(staged, lambda: solve_ensemble_cuda(
        ep.prob, u0s, ps, tab, save_chunks=1, **kw), 5, launches=(
            lambda: erk_kernel.erk_ensemble_staged(
                ep.prob.f, tab, u0_l, p_l, grid_l, segments, **raw),
            lambda: erk_kernel.erk_ensemble(ep.prob.f, tab, u0_l, p_l,
                                            grid_l, t0=0.0, tf=1.0, **raw)))
    S = grid.shape[0]
    flops = (N * 2 ** 10 * attempt_flops(tab, 3, 9, False)
             + N * S * save_flops(tab, 3))
    nbytes = 8 * (6 * N + S + S * 3 * N + 3 * N + N) + 4 * 6 * N
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp64": flops / PEAK_FP64_FLOPS * 1e3}
    pipe = max(times, key=times.get)
    ms, ms_one = times_k2["staged_ms"], times_k2["one_ms"]
    print(f"K2 staged driver (save_chunks=3, {launches} launches of K1): "
          f"{ms:.3f} ms against one launch {ms_one:.3f} ms "
          f"({ms / ms_one:.2f}x); device {times_k2['staged_device_ms']:.3f}"
          f" / {times_k2['one_device_ms']:.3f} ms, host "
          f"{times_k2['staged_host_ms']:.3f} / {times_k2['one_host_ms']:.3f}"
          f" ms; bound {times[pipe]:.4f} ms by {pipe} ({flops:.3e} ops, "
          f"{nbytes:.3e} bytes), plain version {plain_ms:.1f} ms (one run)")
    k2 = {"name": "run_ensemble_kernel_staged[tsit5,lorenz,f64,fixed,3]",
          "route": "cuda",
          "source": "src/repro_torch/kernels/ensemble_kernel.py",
          "replaces": "src/repro/kernels/ensemble_kernel.py:372",
          "launches": launches, "max_abs_err": k2_err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": times[pipe],
          "bound_by": "bytes" if pipe == "bytes" else "operations",
          "library_ms": None, "one_launch_ms": ms_one,
          **{k: v for k, v in times_k2.items()
             if k not in ("staged_ms", "one_ms")}}
    return worst, k2


# ---------------------------------------------------------------------------
# the automated translation (src/repro_torch/translate): an RHS without a
# registration traced into a device functor and compiled into K1, K2, K3
# and K4 in a generated translation unit
# ---------------------------------------------------------------------------

# f64 parity of the generated functors, 4096 lanes: against the hand-written
# functor on the same inputs (every case; bitwise where the kernel rounds
# every operation alone: K1's Rounded tableaus, K3 with ROBER's analytic
# Jacobian traced), and against the plain version driven by the traced
# function's `evaluate` (`translate.ir.as_function`) at K1_PARITY's bars,
# per-lane counts identical; K3 against the plain version with jac=None
# (`torch.func.jacfwd`) bitwise or with counts identical within
# STIFF_SAME_COUNTS_TOL and the ROBER bar; K4 against the plain version on
# a noise table within 1e-12.
HEUN_EULER = dict(a=[[0.0, 0.0], [1.0, 0.0]], b=[0.5, 0.5],
                  btilde=[-0.5, 0.5], c=[0.0, 1.0], order=2,
                  embedded_order=1, fsal=False)
# Hairer's dopri5 dense output (CONTD5) as stage weights, b_i(θ) = b_i θ
# + (δ_i1 − b_i) θ(1−θ) + (2 b_i − δ_i1 − δ_i7) θ²(1−θ) + d_i θ²(1−θ)²:
# the second user tableau with a free interpolant (`interp_tableaus`)
DOPRI5_DENSE_D = (-12715105075 / 11282082432, 0.0, 87487479700 / 32700410799,
                  -10690763975 / 1880347072, 701980252875 / 199316789632,
                  -1453857185 / 822651844, 69997945 / 29380423)
_INTERP_TABLEAUS: dict = {}
TRANSLATE_SDE = {"gbm": ("em", "heun_strat", "platen_w2", "milstein"),
                 "crn": ("em", "heun_strat")}
# the K1 cases held to the plain version even where bitwise the hand-written
# run: a contracted and a Rounded form
TRANSLATE_K1_PLAIN = {("tsit5", True), ("vern7", True)}
# lanes of the phase's gradient case
TRANSLATE_GRAD_N = 1024
# the generated event and data rows hold their plain versions on the first
# TRANSLATE_ROW_PLAIN_N lanes (the lanes are independent)
TRANSLATE_ROW_PLAIN_N = 2 ** 16
_WRAPPED: dict = {}


def interp_tableaus():
    """The two user tableaus with a free interpolant (made once, so their
    traces and units are made once): ``tsit5_copy``, tsit5's coefficients
    with a copy of `_tsit5_bpoly` as its interpolant, which compiles as the
    hand-written tsit5 does (`units.twin_flags`); ``dopri5_dense``,
    dopri5's coefficients with Hairer's dense output (`DOPRI5_DENSE_D`),
    every operation rounded alone."""
    if _INTERP_TABLEAUS:
        return _INTERP_TABLEAUS
    import inspect
    import torch
    from repro_torch.convert import tableau_from_arrays
    from repro_torch.core import tableaus as tabs
    ns = {"torch": torch}
    exec(inspect.getsource(tabs._tsit5_bpoly).replace(
        "_tsit5_bpoly", "tsit5_copy_bpoly"), ns)
    b = [float(x) for x in tabs.DOPRI5.b]
    c2 = [(1.0 if i == 0 else 0.0) - b[i] for i in range(7)]
    c3 = [2.0 * b[i] - (1.0 if i == 0 else 0.0) - (1.0 if i == 6 else 0.0)
          for i in range(7)]

    def dopri5_bpoly(t):
        s = 1.0 - t
        return torch.stack([b[i] * t + c2[i] * (t * s) + c3[i] * (t * t * s)
                            + DOPRI5_DENSE_D[i] * (t * t * (s * s))
                            for i in range(7)])

    for name, ref, bpoly in (("tsit5_copy", tabs.TSIT5,
                              ns["tsit5_copy_bpoly"]),
                             ("dopri5_dense", tabs.DOPRI5, dopri5_bpoly)):
        _INTERP_TABLEAUS[name] = tableau_from_arrays(
            name, ref.a, ref.b, ref.btilde, ref.c, order=ref.order,
            embedded_order=ref.embedded_order, fsal=ref.fsal,
            interp_bpoly=bpoly)
    return _INTERP_TABLEAUS


def unregistered(fn):
    """A plain wrapper of `fn`: it carries no device registration, so the
    CUDA wrappers translate it (one wrapper a function, so its trace and
    unit are made once); a data-driven fn takes its dataset through it."""
    if fn not in _WRAPPED:
        def wrapper(*args):
            return fn(*args)
        wrapper.__name__ = wrapper.__qualname__ = \
            f"{fn.__name__}_unregistered"
        _WRAPPED[fn] = wrapper
    return _WRAPPED[fn]


def probe_ops(u, p, t):
    """One op a state for the one-op probe (`translate.units.probe_unit`):
    the forms where PyTorch's CUDA kernels take special paths (pow by a
    Python number, division by one, NaN in maximum and the clamps) and the
    library calls."""
    import torch
    return torch.stack([
        u[0] ** 2, u[1] ** 3, u[2] ** 0.5, u[3] ** -1, u[4] ** -2,
        u[5] ** -0.5, u[6] / 3.0, u[7] / 7.0, torch.exp(u[8]),
        torch.log(u[9]), torch.sin(u[10]), torch.cos(u[11]),
        torch.tanh(u[12]), u[13] ** 2.5, torch.sqrt(u[14]),
        torch.maximum(u[15], u[16]), torch.clamp_min(u[17], 0.5),
        3.0 / u[18], u[19] - 0.1, 1.0 - u[20], u[21] ** p[0],
        u[22] * u[23] + u[21], torch.where(u[22] > u[23], u[22], -u[23]),
        torch.abs(u[23] - 1.0)])


PROBE_NAMES = ("**2", "**3", "**0.5", "**-1", "**-2", "**-0.5", "/3.0",
               "/7.0", "exp", "log", "sin", "cos", "tanh", "**2.5", "sqrt",
               "maximum", "clamp_min", "3.0/x", "x-0.1", "1.0-x", "x**p",
               "x*y+z", "where", "abs")


def probe_run(device, dtype, N: int = 2 ** 16):
    """K1's generated functor of `probe_ops` once a lane under each policy
    against the same ops in PyTorch on the card: {policy: {op: "bitwise"
    or how many lanes differ}}, NaN inputs on some lanes of maximum and
    clamp_min."""
    import ctypes
    import torch
    from repro_torch.kernels.build import load_generated
    from repro_torch.translate.ir import evaluate
    from repro_torch.translate.trace import trace
    from repro_torch.translate.units import probe_unit
    traced = trace(probe_ops, 24, 1, outputs=(24,))
    fn = load_generated(probe_unit(traced, dtype)).probe_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(SEED)
    u = (torch.rand(24, N, generator=gen, dtype=torch.float64) * 4
         + 0.01).to(dtype).to(device)
    u[15:17, :100] = float("nan")
    u[17, 100:200] = float("nan")
    p = (torch.rand(1, N, generator=gen, dtype=torch.float64) * 3).to(
        dtype).to(device)
    t = torch.zeros(N, dtype=dtype, device=device)
    want = evaluate(traced, u, p, t)
    out = {}
    for policy, rounded in (("Rounded", 1), ("Contracting", 0)):
        got = torch.empty_like(want)
        rc = fn(int(dtype == torch.float64), rounded, u.data_ptr(),
                p.data_ptr(), t.data_ptr(), got.data_ptr(), N,
                torch.cuda.current_stream(device).cuda_stream)
        sync(device)
        if rc != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")
        res = {}
        for i, name in enumerate(PROBE_NAMES):
            a, b = got[i], want[i]
            differ = int(((a != b) & ~(a.isnan() & b.isnan())).sum())
            res[name] = "bitwise" if differ == 0 else f"{differ} lanes"
        out[policy] = res
    return out


def cos_stiff(u, p, t):
    """tests/test_kernels.py:243-244's time-dependent stiff RHS."""
    import torch
    return torch.stack([-p[0] * (u[0] - torch.cos(t))])


def translate_problem(ep, *, jac="keep"):
    """`ep` with its callbacks replaced by their `unregistered` wrappers;
    ``jac=None`` drops the Jacobian hook."""
    import dataclasses
    from repro_torch.core.problem import EnsembleProblem
    prob = ep.prob
    repl = {"f": unregistered(prob.f)}
    if hasattr(prob, "g"):
        repl["g"] = unregistered(prob.g)
    elif jac != "keep":
        repl["jac"] = jac
    u0s, ps = ep.materialize()
    return EnsembleProblem(dataclasses.replace(prob, **repl), ep.n_trajectories,
                           u0s=u0s, ps=ps)


def unregistered_event(ev):
    """`ev` with its condition and affect replaced by their `unregistered`
    wrappers: the CUDA wrappers translate it."""
    return ev._replace(condition=unregistered(ev.condition),
                       affect=None if ev.affect is None
                       else unregistered(ev.affect))


def plain_event(ev, n: int, m: int):
    """`ev` with its condition and affect replaced by their translation's
    plain version."""
    from repro_torch.translate.ir import as_function
    from repro_torch.translate.trace import trace_event
    cond, affect = trace_event(ev.condition, ev.affect, n, m)
    return ev._replace(condition=as_function(cond),
                       affect=None if affect is None else as_function(affect))


def plain_problem(ep):
    """`ep` with its callbacks replaced by their translation's plain
    version, `ir.evaluate` of the traced function (traced with the
    problem's dataset, where it has one)."""
    import dataclasses
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.translate.ir import as_function
    from repro_torch.translate.trace import trace, trace_pair
    prob = ep.prob
    n, m = prob.u0.shape[0], prob.p.shape[0]
    data = getattr(prob, "data", None)
    if hasattr(prob, "g"):
        g_out = (n,) if prob.noise == "diagonal" else (n, prob.noise_dim())
        tf, tg = trace_pair(prob.f, prob.g, n, m, f_outputs=(n,),
                            g_outputs=g_out, data=data)
        repl = dict(f=as_function(tf), g=as_function(tg))
    else:
        repl = dict(f=as_function(trace(prob.f, n, m, outputs=(n,),
                                        data=data)))
        if prob.jac is not None:
            repl["jac"] = as_function(trace(prob.jac, n, m,
                                            outputs=(n, n), data=data))
    u0s, ps = ep.materialize()
    return EnsembleProblem(dataclasses.replace(prob, **repl), ep.n_trajectories,
                           u0s=u0s, ps=ps)


def same_run(a, b) -> bool:
    """Two front-door results bitwise equal (NaN where NaN)."""
    import torch
    for k in ("us", "u_final", "t_final", "naccept", "nreject", "nf",
              "status", "njac", "nfact"):
        x, y = getattr(a, k), getattr(b, k)
        if torch.is_tensor(x) and x.is_floating_point():
            if not (torch.equal(x.isnan(), y.isnan())
                    and torch.equal(torch.nan_to_num(x),
                                    torch.nan_to_num(y))):
                return False
        elif not bool(torch.equal(torch.as_tensor(x).cpu(),
                                  torch.as_tensor(y).cpu())):
            return False
    return True


def translate_inputs(device, N: int):
    """The phase's ensembles: Lorenz and ROBER, OREGO and Van der Pol as
    the stiff parity phase makes them, the cos(t) RHS, GBM and CRN as the
    SDE parity phase makes them (f64)."""
    import torch
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.problem import ODEProblem
    f64 = torch.float64
    stiff = {name.split()[0]: (ep, kw) for name, ep, kw, _ in
             stiff_parity_cases(device, N)
             if name in ("rober rodas5p eager", "orego rodas5p", "vdp rodas4")}
    cos_prob = ODEProblem(cos_stiff, torch.zeros(1, dtype=f64),
                          torch.tensor([1e5], dtype=f64), (0.0, 1.0))
    cos_ep = ensemble_problem(cos_prob, np.zeros((N, 1)),
                              np.geomspace(1e3, 1e5, N)[:, None],
                              device=device)
    stiff["cos"] = (cos_ep, dict(alg="rosenbrock23", t0=0.0, tf=1.0,
                                 dt0=1e-6, rtol=1e-4, atol=1e-7,
                                 saveat=torch.linspace(0.0, 1.0, 5,
                                                       dtype=f64)))
    return dict(lorenz=lorenz_inputs(N, f64, device), stiff=stiff,
                gbm=sde_inputs("gbm", N, f64, device),
                crn=sde_inputs("crn", N, f64, device))


def translate_units(inputs, device):
    """Every generated unit the phase and its rows launch (f64 parity; the
    f32 Lorenz and CRN rows), made by the wrappers' own `generated_unit`."""
    import torch
    from repro_torch.convert import tableau_from_arrays
    from repro_torch.core.tableaus import get_rosenbrock_tableau, get_tableau
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    from repro_torch.configs import de_problems as dp
    f32, f64 = torch.float32, torch.float64
    lor = unregistered(dp.lorenz_rhs)
    units = [erk_kernel.generated_unit(lor, get_tableau(alg), 3, 3, f64)
             for alg in erk_kernel.TABLEAU_IDS]
    units.append(erk_kernel.generated_unit(
        lor, tableau_from_arrays("heun_euler", **HEUN_EULER), 3, 3, f64))
    units.append(erk_kernel.generated_unit(lor, get_tableau("tsit5"), 3, 3,
                                           f32))
    # the free interpolants: tsit5_copy with the registered Lorenz (f64
    # parity, the f32 row), dopri5_dense with the traced one
    user = interp_tableaus()
    units += [erk_kernel.route(dp.lorenz_rhs, user["tsit5_copy"], n=3, m=3,
                               dtype=dtype).target for dtype in (f64, f32)]
    units.append(erk_kernel.generated_unit(lor, user["dopri5_dense"], 3, 3,
                                           f64))
    rober = unregistered(dp.rober_rhs)
    for alg in ("rosenbrock23", "rodas4", "rodas5p"):
        units += [rb_kernel.generated_unit(
            rober, dp.rober_jac, get_rosenbrock_tableau(alg), 3, 3, f64,
            w_reuse=wr) for wr in (False, True)]
    for name, (ep, kw) in inputs["stiff"].items():
        n, m = ep.prob.u0.shape[0], ep.prob.p.shape[0]
        units.append(rb_kernel.generated_unit(
            unregistered(ep.prob.f), None,
            get_rosenbrock_tableau(kw["alg"]), n, m, f64,
            w_reuse=bool(kw.get("w_reuse"))))
    for name, methods in TRANSLATE_SDE.items():
        prob = inputs[name].prob
        fun = sde_kernel.SDEFunctor(-1, prob.u0.shape[0], prob.p.shape[0],
                                    prob.noise, prob.noise_dim(),
                                    prob.noise == "diagonal", False)
        f, g = unregistered(prob.f), unregistered(prob.g)
        units += [sde_kernel.generated_unit(f, g, alg, fun, f64)
                  for alg in methods]
        if name == "crn":
            units.append(sde_kernel.generated_unit(f, g, "em", fun, f32))
    from repro_torch.translate.trace import trace
    from repro_torch.translate.units import probe_unit
    probe = trace(probe_ops, 24, 1, outputs=(24,))
    units += [probe_unit(probe, dtype) for dtype in (f32, f64)]
    return units


# The event, data and data-and-event forms through the translation
# (`translate_form_cases`, f64 but the f32 Van der Pol case, N lanes): each
# generated form against the hand-written form where a source compiles
# one (bitwise: the event and data forms round every operation alone), and
# against its plain version (`plain_problem`, `plain_event`) where none
# does, at the bar of its family: TRANSLATE_FORM_BAR (0.0: bitwise; K1's
# adaptive event forms are held at the event parity phase's 1e-10 as the
# hand-written ones are, onehot's lookups at ONEHOT_TOL).
TRANSLATE_FORM_BAR = {"erk": 1e-10, "rosenbrock": 0.0, "sde": 0.0,
                      "sde_adaptive": 0.0}
# the up-and-out barrier of the rate-table GBM (gbm-rate-1M-em-barrier)
RATE_BARRIER = 1.1


def _level(level: float, direction: int, terminal: bool):
    """An event on u[0] crossing `level` (no registration: translated)."""
    from repro_torch.core.events import Event

    def condition(u, p, t):
        return u[0] - level
    condition.__name__ = condition.__qualname__ = \
        f"u0_crosses_{level:g}".replace(".", "_").replace("-", "m")
    return Event(condition=condition, direction=direction, terminal=terminal)


_LEVELS: dict = {}


def level_event(level: float, direction: int, terminal: bool):
    """`_level`, made once a setting (so its trace and unit are too)."""
    key = (level, direction, terminal)
    if key not in _LEVELS:
        _LEVELS[key] = _level(*key)
    return _LEVELS[key]


def translate_form_cases(device, N: int):
    """(name, family, generated ensemble, front-door arguments, the
    hand-written (ensemble, arguments) or None, the plain-version bar or
    None) of the event, data and data-and-event forms of
    `phase_translate`."""
    import dataclasses
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.problem import EnsembleProblem
    f32, f64 = torch.float32, torch.float64
    bar = TRANSLATE_FORM_BAR
    cases = []
    ev_cases = {name: (ep, kw) for name, _, ep, kw in
                event_parity_cases(device, N)}
    # ---- a translated event on each kernel ------------------------------
    ball, bal = ev_cases["ball tsit5"]
    gball = translate_problem(ball)
    gbal = dict(bal, event=unregistered_event(bal["event"]))
    for alg in ("tsit5", "dopri5", "vern7"):
        cases.append((f"K1 ball {alg} event", "erk", gball,
                      dict(gbal, alg=alg),
                      None if alg == "vern7" else (ball, dict(bal, alg=alg)),
                      bar["erk"] if alg == "vern7" else None))
    rober, rkw = ev_cases["rober rodas5p eager"]
    grober = translate_problem(rober)
    for wr in (False, True):
        kw = dict(rkw, alg="rodas5p", w_reuse=wr)
        cases.append((f"K3 rober_half rodas5p {'lazyW' if wr else 'eager'}",
                      "rosenbrock", grober,
                      dict(kw, event=unregistered_event(kw["event"])),
                      (rober, kw), None))
    gbm, gkw = ev_cases["gbm barrier em fixed"]
    cases.append(("K4 gbm barrier em fixed", "sde", translate_problem(gbm),
                  dict(gkw, event=unregistered_event(gkw["event"])),
                  (gbm, gkw), None))
    for est in ("embedded", "doubling"):
        ramp, skw = ev_cases[f"ramp sawtooth em {est}"]
        cases.append((f"K5 ramp sawtooth em {est}", "sde_adaptive",
                      translate_problem(ramp),
                      dict(skw, event=unregistered_event(skw["event"])),
                      (ramp, skw), None))
    # ---- translated data in every lookup mode ---------------------------
    fixed = {k: v for k, v in TEXTURE_FIXED.items()
             if k not in ("n_steps", "save_every")}
    big = dp.forced_oscillator_problem()
    for mode, rhs in dp.FORCED_OSC_RHS.items():
        osc = osc_inputs(N, device, f64, mode=mode)
        kw = dict(fixed, alg="tsit5", saveat=[0.5, 1.0])
        cases.append((f"K1 osc {mode} tsit5 fixed", "erk",
                      translate_problem(osc), kw, (osc, kw), None))
        osc = osc_inputs(N, device, f64, prob=dataclasses.replace(big, f=rhs),
                         p=(2.0, 0.1))
        kw = dict(OSC_ADAPTIVE, alg="tsit5")
        cases.append((f"K1 osc {mode} tsit5 adaptive", "erk",
                      translate_problem(osc), kw, (osc, kw), None))
    # rosenbrock23 on the data parity phase's stiff oscillator, [0, 0.5],
    # at rtol 1e-6 (its plain version's host loop is the phase's longest)
    stiff_kw = dict(OSC_STIFF, tf=0.5, rtol=1e-6, atol=1e-6,
                    saveat=[0.0, 0.25, 0.5], alg="rosenbrock23")
    for mode, rhs in dp.FORCED_OSC_RHS.items():
        stiff = osc_inputs(N, device, f64, prob=dataclasses.replace(
            big, f=rhs, tspan=(0.0, 3.0)), p=(50.0, 2.0))
        kw = dict(stiff_kw)
        hand = (stiff, kw) if mode == "gather" else None
        cases.append((f"K3 osc {mode} rosenbrock23", "rosenbrock",
                      translate_problem(stiff), kw, hand,
                      None if hand else (ONEHOT_TOL if mode == "onehot"
                                         else bar["rosenbrock"])))
    rate = ensemble_problem(dp.gbm_rate_problem(), np.ones((N, 1)),
                            np.full((N, 1), 0.2), device=device)
    grate = translate_problem(rate)
    kw = dict(RATE_FIXED, alg="em")
    cases.append(("K4 gbm-rate em fixed", "sde", grate, kw, (rate, kw),
                  None))
    kw = dict(RATE_ADAPTIVE, alg="em", error_est="embedded")
    cases.append(("K5 gbm-rate em embedded", "sde_adaptive", grate, kw,
                  (rate, kw), None))
    # ---- data and an event together -------------------------------------
    lvl = osc_inputs(N, device, f64, prob=big, p=(1.0, 0.0), u0=(0.0, 2.0),
                     scale=(0.8, 1.2))
    kw = dict(OSC_EVENT, alg="tsit5", event=dp.osc_level_event())
    cases.append(("K1 osc gather tsit5 osc_level", "erk",
                  translate_problem(lvl),
                  dict(kw, event=unregistered_event(kw["event"])),
                  (lvl, kw), None))
    stiff = osc_inputs(N, device, f64, prob=dataclasses.replace(
        big, tspan=(0.0, 3.0)), p=(50.0, 2.0))
    cases.append(("K3 osc gather rosenbrock23 x=0 down", "rosenbrock", stiff,
                  dict(stiff_kw, event=level_event(0.0, -1, False)),
                  None, bar["rosenbrock"]))
    # the rate GBM with its barrier on half the data phase's span (its
    # plain versions' host loops): about a third of the lanes hit
    barrier = level_event(RATE_BARRIER, 1, True)
    cases.append(("K4 gbm-rate em fixed barrier", "sde", rate,
                  dict(RATE_FIXED, alg="em", n_steps=250, save_every=125,
                       event=barrier), None, bar["sde"]))
    cases.append(("K5 gbm-rate em embedded barrier", "sde_adaptive", rate,
                  dict(RATE_ADAPTIVE, alg="em", error_est="embedded",
                       tf=0.5, saveat=[0.0, 0.25, 0.5], event=barrier),
                  None, bar["sde_adaptive"]))
    # ---- K3 in f32 with an event: Van der Pol, u[0] = 0 downward ---------
    vdp = dp.vdp_ensemble(N)
    vdp32 = EnsembleProblem(dp.vdp_problem(dtype=f32), N,
                            u0s=vdp.materialize()[0].float().to(device),
                            ps=vdp.ps.float().to(device))
    cases.append(("K3 vdp rodas4 f32 x=0 down", "rosenbrock", vdp32,
                  dict(alg="rodas4", t0=0.0, tf=10.0, dt0=1e-3, rtol=1e-4,
                       atol=1e-6, saveat=torch.linspace(0.0, 10.0, 5),
                       event=level_event(0.0, -1, True)),
                  None, bar["rosenbrock"]))
    # ---- K1's six tableaus with the ball's event and the gather table ---
    osc = osc_inputs(N, device, f64, mode="gather")
    for alg, adaptive, tol, settings in K1_PARITY:
        if alg in ("tsit5", "dopri5") or not adaptive and alg != "rk4":
            continue
        extra = dict(dict(rtol=1e-8, atol=1e-8, dt0=1e-3), **settings,
                     adaptive=adaptive)
        cases.append((f"K1 ball {alg} event (registered)", "erk", ball,
                      dict(bal, **extra, alg=alg), None,
                      bar["erk"] if tol is not None else 0.0))
        cases.append((f"K1 osc gather {alg} fixed (registered)", "erk", osc,
                      dict(fixed, alg=alg, dt0=1.0 / 100, saveat=[0.5, 1.0]),
                      None, 0.0))
    # ---- K5: every stepper and pair on GBM, gdg and ddb derived ---------
    gbm = sde_inputs("gbm", N, f64, device)
    ggbm = translate_problem(gbm)
    for alg, est in (("em", "doubling"), ("heun_strat", "doubling"),
                     ("platen_w2", "doubling"), ("milstein", "doubling"),
                     ("em", "embedded"), ("milstein", "embedded")):
        kw = dict(ADAPTIVE_SETTINGS["gbm"], adaptive=True, seed=SDE_SEED,
                  alg=alg, error_est=est)
        kw["saveat"] = list(kw["saveat"])
        cases.append((f"K5 gbm {alg} {est}", "sde_adaptive", ggbm, kw,
                      (gbm, kw), None))
    return cases


def form_unit(family: str, ep, kw):
    """The generated unit a front-door solve of `ep` with `kw` launches
    (None where a hand-written source compiles the form), from the
    wrappers' own routing."""
    from repro_torch.core.tableaus import get_rosenbrock_tableau, get_tableau
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    prob = ep.prob
    n, m = prob.u0.shape[0], prob.p.shape[0]
    dtype, data, event = ep.u0s.dtype, getattr(prob, "data", None), \
        kw.get("event")
    if family == "erk":
        alg = kw["alg"]
        tab = get_tableau(alg) if isinstance(alg, str) else alg
        target = erk_kernel.route(prob.f, tab, event, data, n=n, m=m,
                                  dtype=dtype).target
        return None if isinstance(target, str) else target
    if family == "rosenbrock":
        return rb_kernel.route(prob.f, prob.jac,
                               get_rosenbrock_tableau(kw["alg"]), event,
                               data, n=n, m=m, dtype=dtype,
                               w_reuse=bool(kw.get("w_reuse")))[0]
    if family == "sde":
        return sde_kernel.sde_route(
            prob.f, prob.g, kw["alg"], noise=prob.noise,
            m_noise=prob.noise_dim(), n=n, k=m, dtype=dtype, event=event,
            data=data).unit
    return k5._device_functor(prob.f, prob.g, kw["alg"], prob.noise,
                              prob.noise_dim(), kw["error_est"], n=n, k=m,
                              dtype=dtype, event=event, data=data)[2]


def translate_forms(device, cases, out, launched):
    """Runs `translate_form_cases`: each generated form against the
    hand-written one (bitwise) and, where no source compiles one, against
    its plain version at its bar; raises on a miss."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    mods = {"erk": erk_kernel, "rosenbrock": rb_kernel, "sde": sde_kernel,
            "sde_adaptive": k5}
    out.setdefault("forms", {})
    for name, family, ep, kw, hand, bar in cases:
        t = time.perf_counter()
        mod = mods[family]
        kw = dict(kw, device=device)
        before = mod.launches
        rg = solve_ensemble_local(ep, ensemble="kernel", backend="cuda", **kw)
        launched(mod, before, name)
        unit = form_unit(family, ep, kw)
        if device.type == "cuda" and unit is None:
            raise AssertionError(f"translate {name}: no generated unit")
        rec = {"unit": None if unit is None else unit.name}
        line = f"translate {name}:"
        if hand is not None:
            rh = solve_ensemble_local(hand[0], ensemble="kernel",
                                      backend="cuda", **dict(hand[1],
                                                             device=device))
            rec["bitwise_to_hand"] = same_run(rg, rh)
            line += f" generated == hand-written {rec['bitwise_to_hand']}"
            if not rec["bitwise_to_hand"]:
                raise AssertionError(f"translate {name}: not bitwise the "
                                     "hand-written form")
        if bar is not None:
            n, m = ep.prob.u0.shape[0], ep.prob.p.shape[0]
            pkw = dict(kw)
            if kw.get("event") is not None:
                pkw["event"] = plain_event(kw["event"], n, m)
            extra = dict(linsolve="lanes") if family == "rosenbrock" else {}
            rp = solve_ensemble_local(plain_problem(ep), ensemble="kernel",
                                      backend="torch", **pkw, **extra)
            counts, worst, lanes = event_compare(rg, rp)
            rec.update(plain_counts_identical=counts, plain_worst=worst,
                       plain_bitwise=same_run(rg, rp), bar=bar)
            line += (f" against the plain version: counts identical "
                     f"{counts}, worst |gen - plain| {worst:.3e} (bar {bar}),"
                     f" bitwise {rec['plain_bitwise']}")
            if not counts or worst > bar:
                raise AssertionError(f"translate {name}: misses its bar")
        ended = float((rg.t_final < rg.ts[-1] - 1e-9).double().mean())
        rec["ended_early_share"] = ended
        rec["seconds"] = time.perf_counter() - t
        out["forms"][name] = rec
        print(line + f"; lanes ended early {ended:.4f}; "
              f"{rec['seconds']:.1f} s")


def translate_row_units(device):
    """The units of `translate_event_data_rows` that the parity cases do not
    build: the f32 forms (gbm-1M-em-adaptive's generated pair, the rate
    table's barrier)."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.problem import EnsembleProblem
    f32 = torch.float32
    gbm = EnsembleProblem(dp.gbm_problem(r=1.5, v=0.2, dtype=f32), 2,
                          u0s=torch.full((2, 3), 0.1, dtype=f32),
                          ps=torch.tensor([[1.5, 0.2]] * 2, dtype=f32))
    rate = ensemble_problem(dp.gbm_rate_problem(dtype=f32), np.ones((2, 1)),
                            np.full((2, 1), 0.2), dtype=f32)
    return [form_unit("sde_adaptive", translate_problem(gbm),
                      dict(alg="em", error_est="embedded")),
            form_unit("sde", rate, dict(alg="em", event=level_event(
                RATE_BARRIER, 1, True)))]


def translate_prepare(device, N: int = PARITY_N):
    """(inputs, form cases, units) of `phase_translate`: its ensembles
    (`translate_inputs`), its event and data forms
    (`translate_form_cases`) and every generated unit it and
    `phase_translate_rows` launch, traced and emitted."""
    inputs = translate_inputs(device, N)
    form_cases = translate_form_cases(device, N)
    units = translate_units(inputs, device)
    units += [u for c in form_cases
              if (u := form_unit(c[1], c[2], c[3])) is not None]
    return inputs, form_cases, units + translate_row_units(device)


def phase_translate(device, prepared=None, N: int = PARITY_N):
    """The generated functors against the hand-written ones and against
    their plain versions (f64, N lanes), after one parallel build of every
    generated unit; the first-use and second-use compile seconds of a new
    RHS; one gradient through `kernel_adjoint` on a generated forward."""
    import subprocess as sp
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import tableau_from_arrays
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.sensitivity import suggest_adjoint_steps
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels import build
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
    on_card = device.type == "cuda"
    f64 = torch.float64
    out = {"bitwise_to_hand": {}, "plain": {}}

    # ---- every unit: built by phase_build; driven alone, the phase traces
    # and builds them here, in one call -----------------------------------
    t = time.perf_counter()
    inputs, form_cases, units = prepared or translate_prepare(device, N)
    trace_s = time.perf_counter() - t
    t = time.perf_counter()
    logs = build.build(units) if on_card else {}
    build_s = time.perf_counter() - t
    out.update(units=len(units), trace_s=trace_s, build_s=build_s)
    print(f"translate: {len(units)} generated units (traced and emitted in "
          f"{trace_s:.2f} s here), built in parallel in {build_s:.1f} s "
          f"({len(logs)} compiled here)")
    for unit in {u.name: u for u in units}.values() if on_card else ():
        log = build.build_log(unit) or ""
        regs = re.findall(r"Used (\d+) registers", log)
        spill = re.findall(r"(\d+) bytes spill stores", log)
        print(f"translate build {unit.name}: registers {regs}, spill stores "
              f"{spill}")

    # ---- a new RHS: first use compiles its unit, a second use (and a
    # second process) compiles nothing ----------------------------------
    if on_card:
        fresh = lambda u, p, t: torch.stack([  # noqa: E731
            p[0] * (u[1] - u[0]), p[1] * u[0] - u[1] - u[0] * u[2],
            u[0] * u[1] - p[2] * u[2] + 0.0 * t])
        tab32 = get_tableau("tsit5")
        t = time.perf_counter()
        unit = erk_kernel.generated_unit(fresh, tab32, 3, 3, torch.float32)
        build.load_generated(unit)
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        build.load_generated(erk_kernel.generated_unit(fresh, tab32, 3, 3,
                                                       torch.float32))
        second_s = time.perf_counter() - t
        code = ("import sys, time; sys.path.insert(0, 'src'); "
                "from repro_torch.kernels import build; "
                "from repro_torch.translate.units import Unit; "
                "t = time.perf_counter(); "
                "logs = build.build([Unit(sys.argv[1], sys.stdin.read())]); "
                "print(len(logs), time.perf_counter() - t)")
        got = sp.run([sys.executable, "-c", code, unit.name], input=unit.text,
                     capture_output=True, text=True, cwd=str(ROOT),
                     check=True).stdout.split()
        out.update(first_use_s=first_s, second_use_s=second_s,
                   second_process_compiled=int(got[0]),
                   second_process_s=float(got[1]))
        print(f"translate: a new RHS on tsit5 f32: first use {first_s:.2f} s "
              f"(trace, emit, nvcc, load), second use {second_s:.4f} s, a "
              f"second process compiled {got[0]} units in {float(got[1]):.3f}"
              " s")
        # a new problem with a dataset and an event: the same, for its unit
        from repro_torch.configs import de_problems as dp
        from repro_torch.core.events import Event
        from repro_torch.core.interp import interp1d
        table = dp.texture_oscillator_problem(dtype=torch.float32).data
        fresh_data = lambda u, p, t, d: torch.stack([  # noqa: E731
            u[1], interp1d(d["force"], t, "cubic") - p[0] * u[0]])
        fresh_ev = Event(condition=lambda u, p, t: u[0] * u[1] - 0.25,
                         affect=lambda u, p, t: u * 0.5, direction=-1)
        t = time.perf_counter()
        unit = erk_kernel.generated_unit(fresh_data, tab32, 2, 2,
                                         torch.float32, event=fresh_ev,
                                         data=table)
        build.load_generated(unit)
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        build.load_generated(erk_kernel.generated_unit(
            fresh_data, tab32, 2, 2, torch.float32, event=fresh_ev,
            data=table))
        second_s = time.perf_counter() - t
        got = sp.run([sys.executable, "-c", code, unit.name], input=unit.text,
                     capture_output=True, text=True, cwd=str(ROOT),
                     check=True).stdout.split()
        out.update(first_use_event_data_s=first_s,
                   second_use_event_data_s=second_s,
                   second_process_compiled_event_data=int(got[0]))
        print(f"translate: a new problem with a dataset and an event on "
              f"tsit5 f32: first use {first_s:.2f} s, second use "
              f"{second_s:.4f} s, a second process compiled {got[0]} units "
              f"in {float(got[1]):.3f} s")

    # ---- the one-op probe: each op of the emitter against PyTorch's ----
    if on_card:
        for dtype in (torch.float32, f64):
            got = probe_run(device, dtype)
            out[f"probe_{str(dtype)[6:]}"] = got
            for policy, res in got.items():
                print(f"translate probe {str(dtype)[6:]} {policy}: "
                      + json.dumps(res))
            wrong = [k for k, v in got["Rounded"].items() if v != "bitwise"]
            if wrong:
                raise AssertionError(f"translate probe {dtype}: {wrong} not "
                                     "bitwise PyTorch's CUDA ops")

    clock = [time.perf_counter()]
    out["seconds"] = {}

    def lap(what):
        now = time.perf_counter()
        out["seconds"][what] = now - clock[0]
        clock[0] = now

    def launched(mod, before, what, k=1):
        if on_card and mod.launches != before + k:
            raise AssertionError(f"translate {what}: {mod.launches - before}"
                                 f" launches, expected {k}")

    def record(key, bitwise, plain_err=None):
        out["bitwise_to_hand"][key] = bitwise
        if plain_err is not None:
            out["plain"][key] = plain_err

    # ---- K1: Lorenz on every tableau: against the hand-written functor;
    # against the plain version (evaluate) on TRANSLATE_K1_PLAIN and on any
    # case that is not bitwise the hand-written run (phase_parity holds the
    # hand-written runs to their plain versions) -------------------------
    lor = inputs["lorenz"]
    lor_w, lor_p = translate_problem(lor), plain_problem(translate_problem(lor))
    saveat = torch.linspace(0.0, 1.0, 11, dtype=f64)
    for alg, adaptive, tol, settings in K1_PARITY:
        kw = dict(dict(rtol=1e-8, atol=1e-8, dt0=1e-3), **settings, t0=0.0,
                  tf=1.0, saveat=saveat, device=device, ensemble="kernel",
                  alg=alg, adaptive=adaptive)
        key = f"K1 {alg} {'adaptive' if adaptive else 'fixed'}"
        rh = solve_ensemble_local(lor, backend="cuda", **kw)
        before = erk_kernel.launches
        rg = solve_ensemble_local(lor_w, backend="cuda", **kw)
        launched(erk_kernel, before, key)
        bitwise = same_run(rg, rh)
        line = f"translate {key}: generated == hand-written {bitwise}"
        err = None
        if not bitwise or (alg, adaptive) in TRANSLATE_K1_PLAIN:
            rp = solve_ensemble_local(lor_p, backend="torch", **kw)
            other = int(((rg.naccept != rp.naccept)
                         | (rg.nreject != rp.nreject)).sum())
            plain_bitwise = same_run(rg, rp)
            err = 0.0 if plain_bitwise else max(
                rel_err(rg.us, rp.us), rel_err(rg.u_final, rp.u_final))
            line += (f"; against the plain version (evaluate): lanes with "
                     f"other counts {other}, rel err {err:.3e}, bitwise "
                     f"{plain_bitwise} (bar "
                     f"{'bitwise' if tol is None else tol})")
            if other or (tol is None and not plain_bitwise) or (
                    tol is not None and err > tol):
                raise AssertionError(f"translate {key}: misses its bar")
        record(key, bitwise, err)
        print(line)
        if tol is None and not bitwise:
            raise AssertionError(f"translate {key}: a Rounded form not "
                                 "bitwise the hand-written one")

    lap("K1")
    # ---- K2: the staged driver through the generated unit --------------
    u0s, ps = lor.materialize()
    grid = torch.arange(1, 9, dtype=f64) / 8.0
    skw = dict(t0=0.0, tf=1.0, dt0=2.0 ** -10, saveat=grid, rtol=1e-8,
               atol=1e-8, adaptive=False)
    for alg in ("tsit5", "vern7"):
        tab = get_tableau(alg)
        before = erk_kernel.launches
        three = solve_ensemble_cuda(lor_w.prob, u0s, ps, tab, save_chunks=3,
                                    **skw)
        sync(device)
        launched(erk_kernel, before, f"K2 {alg}", 3)
        one = solve_ensemble_cuda(lor_w.prob, u0s, ps, tab, save_chunks=1,
                                  **skw)
        hand = solve_ensemble_cuda(lor.prob, u0s, ps, tab, save_chunks=3,
                                   **skw)
        ok = all(torch.equal(getattr(three, k), getattr(one, k))
                 for k in ("us", "u_final", "t_final", "naccept"))
        bitwise = same_run(three, hand)
        record(f"K2 {alg} staged", bitwise)
        print(f"translate K2 {alg} save_chunks=3: bitwise one launch {ok}, "
              f"bitwise the hand-written staged run {bitwise}")
        if not (ok and bitwise):
            raise AssertionError(f"translate K2 {alg}: not bitwise")

    lap("K2")
    # ---- a user tableau: Heun–Euler 2(1) from its arrays ----------------
    heun = tableau_from_arrays("heun_euler", **HEUN_EULER)
    # second order: rtol 1e-3 keeps the plain version's host loop short
    for adaptive, extra in ((True, dict(rtol=1e-3, atol=1e-3, dt0=1e-3)),
                            (False, dict(dt0=2.0 ** -8))):
        kw = dict(extra, t0=0.0, tf=1.0, saveat=saveat, device=device,
                  ensemble="kernel", alg=heun, adaptive=adaptive)
        key = f"K1 heun_euler {'adaptive' if adaptive else 'fixed'}"
        before = erk_kernel.launches
        rg = solve_ensemble_local(lor_w, backend="cuda", **kw)
        launched(erk_kernel, before, key)
        rp = solve_ensemble_local(lor_p, backend="torch", **kw)
        bitwise = same_run(rg, rp)
        record(key, None, 0.0 if bitwise else max(
            rel_err(rg.us, rp.us), rel_err(rg.u_final, rp.u_final)))
        print(f"translate {key} (user tableau): bitwise the plain version "
              f"{bitwise}, attempts {int((rg.naccept + rg.nreject).sum())}")
        if not bitwise:
            raise AssertionError(f"translate {key}: not bitwise")

    lap("user tableau")
    # ---- a user tableau's free interpolant: tsit5_copy bitwise the
    # hand-written tsit5 (one launch and K2's staged run), dopri5_dense
    # bitwise its plain version -----------------------------------------
    user = interp_tableaus()
    for adaptive in (True, False):
        kw = dict(rtol=1e-8, atol=1e-8, dt0=1e-3, t0=0.0, tf=1.0,
                  saveat=saveat, device=device, ensemble="kernel",
                  adaptive=adaptive)
        what = "adaptive" if adaptive else "fixed"
        key = f"K1 tsit5_copy {what}"
        rh = solve_ensemble_local(lor, backend="cuda", alg="tsit5", **kw)
        before = erk_kernel.launches
        rg = solve_ensemble_local(lor, backend="cuda", alg=user["tsit5_copy"],
                                  **kw)
        launched(erk_kernel, before, key)
        bitwise = same_run(rg, rh)
        record(key, bitwise)
        print(f"translate {key} (a user tableau with tsit5's interpolant, "
              f"copied): bitwise the hand-written tsit5 {bitwise}, attempts "
              f"{int((rg.naccept + rg.nreject).sum())}")
        if not bitwise:
            raise AssertionError(f"translate {key}: not bitwise")
        key = f"K1 dopri5_dense {what}"
        before = erk_kernel.launches
        rg = solve_ensemble_local(lor_w, backend="cuda",
                                  alg=user["dopri5_dense"], **kw)
        launched(erk_kernel, before, key)
        rp = solve_ensemble_local(lor_p, backend="torch",
                                  alg=user["dopri5_dense"], **kw)
        bitwise = same_run(rg, rp)
        record(key, None, 0.0 if bitwise else max(
            rel_err(rg.us, rp.us), rel_err(rg.u_final, rp.u_final)))
        print(f"translate {key} (Hairer's dense output): bitwise the plain "
              f"version {bitwise}")
        if not bitwise:
            raise AssertionError(f"translate {key}: not bitwise")
    before = erk_kernel.launches
    three = solve_ensemble_cuda(lor.prob, u0s, ps, user["tsit5_copy"],
                                save_chunks=3, **skw)
    sync(device)
    launched(erk_kernel, before, "K2 tsit5_copy", 3)
    hand = solve_ensemble_cuda(lor.prob, u0s, ps, get_tableau("tsit5"),
                               save_chunks=3, **skw)
    bitwise = same_run(three, hand)
    record("K2 tsit5_copy staged", bitwise)
    print(f"translate K2 tsit5_copy save_chunks=3: bitwise the hand-written "
          f"staged run {bitwise}")
    if not bitwise:
        raise AssertionError("translate K2 tsit5_copy: not bitwise")

    lap("free interpolant")
    # ---- K3: ROBER with its analytic Jacobian traced, and derived -------
    rober, rober_kw = inputs["stiff"]["rober"]
    rober_w = translate_problem(rober)
    for alg in ("rosenbrock23", "rodas4", "rodas5p"):
        for wr in (False, True):
            kw = dict(rober_kw, alg=alg, w_reuse=wr, device=device)
            key = f"K3 rober {alg} {'lazyW' if wr else 'eager'} jac traced"
            rh = solve_ensemble_local(rober, ensemble="kernel",
                                      backend="cuda", **kw)
            before = rb_kernel.launches
            rg = solve_ensemble_local(rober_w, ensemble="kernel",
                                      backend="cuda", **kw)
            launched(rb_kernel, before, key)
            bitwise = same_run(rg, rh)
            plain = None
            if (alg, wr) in (("rodas5p", False), ("rodas4", True)):
                rp = solve_ensemble_local(plain_problem(rober_w),
                                          ensemble="kernel", backend="torch",
                                          linsolve="lanes", **kw)
                plain = 0.0 if same_run(rg, rp) else stiff_compare(
                    key, rg, rp, rober=True)[2]
            record(key, bitwise, plain)
            print(f"translate {key}: generated == hand-written {bitwise}"
                  + ("" if plain is None else
                     f"; against the plain version {plain:.3e} (0: bitwise)"))
            if not bitwise:
                raise AssertionError(f"translate {key}: not bitwise")
    for name, (ep, kw) in inputs["stiff"].items():
        kw = dict(kw, device=device)
        gen = translate_problem(ep, jac=None)
        key = f"K3 {name} {kw['alg']} jac derived"
        before = rb_kernel.launches
        rg = solve_ensemble_local(gen, ensemble="kernel", backend="cuda",
                                  **kw)
        launched(rb_kernel, before, key)
        rp = solve_ensemble_local(plain_problem(gen), ensemble="kernel",
                                  backend="torch", linsolve="lanes", **kw)
        bitwise = same_run(rg, rp)
        share, worst_same, worst = (1.0, 0.0, 0.0) if bitwise else \
            stiff_compare(key, rg, rp, rober=name == "rober")
        hand = None
        if name == "rober":
            hand = same_run(rg, solve_ensemble_local(
                ep, ensemble="kernel", backend="cuda", **kw))
        record(key, hand, 0.0 if bitwise else worst)
        print(f"translate {key}: against the plain version with jac=None "
              f"(jacfwd) bitwise {bitwise}, lanes with equal counts "
              f"{share:.4f}, worst {worst:.3e}"
              + ("" if hand is None else
                 f"; == the analytic hand-written run {hand}"))

    lap("K3")
    # ---- K4: GBM on every stepper, CRN on em and heun_strat -------------
    settings = {"gbm": dict(dt0=0.01, n_steps=100, save_every=25),
                "crn": dict(dt0=0.1, n_steps=100, save_every=25)}
    for name, methods in TRANSLATE_SDE.items():
        ep = inputs[name]
        gen = translate_problem(ep)
        m = ep.prob.noise_dim()
        gen_t = torch.Generator().manual_seed(SEED)
        table = torch.randn((settings[name]["n_steps"], m, N),
                            generator=gen_t, dtype=f64).to(device)
        for alg in methods:
            for src in ("rng", "table"):
                kw = dict(settings[name], alg=alg, ensemble="kernel", t0=0.0,
                          seed=SDE_SEED, device=device,
                          noise_table=table if src == "table" else None)
                key = f"K4 {name} {alg} {src}"
                rh = solve_ensemble_local(ep, backend="cuda", **kw)
                before = sde_kernel.launches
                rg = solve_ensemble_local(gen, backend="cuda", **kw)
                launched(sde_kernel, before, key)
                bitwise = same_run(rg, rh)
                plain = None
                if src == "table":
                    rp = solve_ensemble_local(plain_problem(gen),
                                              backend="torch", **kw)
                    mism, err = finite_compare(rg.us, rp.us)
                    mism_f, err_f = finite_compare(rg.u_final, rp.u_final)
                    plain = max(err, err_f)
                    if mism or mism_f or plain > 1e-12:
                        raise AssertionError(f"translate {key}: against the "
                                             f"plain version {plain:.3e}")
                elif not bitwise:
                    # the counter stream: against the hand-written run, at
                    # the plain-version bar (both meet it, phase_sde_parity)
                    mism, err = finite_compare(rg.us, rh.us)
                    mism_f, err_f = finite_compare(rg.u_final, rh.u_final)
                    if mism or mism_f or max(err, err_f) > 1e-12 or not (
                            torch.equal(rg.naccept, rh.naccept)):
                        raise AssertionError(f"translate {key}: against the "
                                             "hand-written run "
                                             f"{max(err, err_f):.3e}")
                    out.setdefault("rng_vs_hand", {})[key] = max(err, err_f)
                record(key, bitwise, plain)
                print(f"translate {key}: generated == hand-written {bitwise}"
                      + ("" if plain is None else
                         f"; against the plain version {plain:.3e} (bar "
                         "1e-12)")
                      + (f"; against it {out['rng_vs_hand'][key]:.3e} (bar "
                         "1e-12)" if key in out.get("rng_vs_hand", {})
                         else ""))

    lap("K4")
    # ---- the event, data and data-and-event forms -----------------------
    translate_forms(device, form_cases, out, launched)
    lap("forms")
    # ---- one gradient: tsit5 on Lorenz, the generated forward (on
    # TRANSLATE_GRAD_N lanes: the backward replays the plain version) ----
    glor = lorenz_inputs(min(N, TRANSLATE_GRAD_N), f64, device)
    gkw = dict(t0=0.0, tf=0.5, dt0=1e-3, rtol=1e-8, atol=1e-8,
               saveat=[0.125, 0.25, 0.375, 0.5])
    gkw["adjoint_steps"] = suggest_adjoint_steps(
        glor, ensemble="kernel", backend="cuda", device=device, **gkw)
    before = erk_kernel.launches
    gg = grad_run(translate_problem(glor), gkw, ("u0s", "ps"))
    launched(erk_kernel, before, "gradient")
    gh = grad_run(glor, gkw, ("u0s", "ps"))
    rel, worst = grad_diff("translate gradient", gg.grads, gh.grads)
    out["gradient_rel"] = rel
    lap("gradient")
    print("translate: seconds a part " + json.dumps(
        {k: round(v, 1) for k, v in out["seconds"].items()}))
    print(f"translate gradient tsit5 lorenz: the generated forward's "
          f"gradient against the hand-written forward's: rel {rel:.3e}, max "
          f"abs {worst:.3e} (0: bitwise); primal bitwise "
          f"{same_run(gg.res, gh.res)}")
    if rel != 0.0:
        raise AssertionError("translate gradient: not bitwise")
    return out


def phase_translate_rows(device, hand_rows, N: int = FULL_N,
                         reps: int = 5):
    """The generated functors at 2^20 beside the hand-written rows on the
    same inputs, hand and generated kernels timed in turns (CUDA events,
    median of `reps`): lorenz-1M-f32-adaptive (and on tsit5_copy, a user
    tableau with tsit5's free interpolant), crn-1M-em and rober-1M-rodas5p
    with the derived Jacobian."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.configs.de_problems import lorenz_ensemble
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.core.tableaus import get_rosenbrock_tableau, get_tableau
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    from repro_torch.translate.ir import as_function
    from repro_torch.translate.trace import trace, trace_pair
    by_name = {r["name"]: r for r in hand_rows}
    rows = []

    def in_turns(hand, gen):
        th, tg = [], []
        for _ in range(reps):
            th.append(cuda_ms(hand, 1))
            tg.append(cuda_ms(gen, 1))
        return statistics.median(th), statistics.median(tg)

    def row(hand_name, name, launches, max_abs, ms, hand_ms, plain_ms,
            bitwise, **extra):
        h = by_name[hand_name]
        r = {"name": name, "route": "cuda", "source": h["source"],
             "replaces": h["replaces"], "launches": launches,
             "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
             "library_ms": None, "functor": "generated",
             "hand_written_ms": hand_ms, "generated_over_hand": ms / hand_ms,
             "bitwise_to_hand_written": bitwise, **extra}
        if "bound_instr_ms" in h:
            r["bound_instr_ms"] = h["bound_instr_ms"]
        print(f"translate row {name}: generated {ms:.3f} ms, hand-written "
              f"{hand_ms:.3f} ms ({ms / hand_ms:.3f}x), bitwise {bitwise}, "
              f"launches {launches}, max abs against the plain version "
              f"{max_abs:.3e}, plain {plain_ms:.1f} ms")
        rows.append(r)

    # ---- lorenz-1M-f32-adaptive[generated] ------------------------------
    host = lorenz_ensemble(N, dtype=torch.float32)
    u0s, ps = (x.to(device).contiguous() for x in host.materialize())
    ep = EnsembleProblem(host.prob, N, u0s=u0s, ps=ps)
    gen = translate_problem(ep)
    kw = dict(alg="tsit5", t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6,
              saveat=torch.linspace(0.0, 1.0, 5), device=device)
    erk_kernel.launches = 0
    res = solve_ensemble_local(gen, ensemble="kernel", backend="cuda", **kw)
    sync(device)
    launches = erk_kernel.launches
    tab = get_tableau("tsit5")
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    sv = res.ts.contiguous()
    kargs = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6,
                 adaptive=True, max_iters=100_000)
    fh, fg = ep.prob.f, gen.prob.f
    out_h = erk_kernel.erk_ensemble(fh, tab, u0_l, p_l, sv, **kargs)
    out_g = erk_kernel.erk_ensemble(fg, tab, u0_l, p_l, sv, **kargs)
    bitwise = all(torch.equal(a, b) for a, b in zip(out_h, out_g))
    fp = as_function(trace(fg, 3, 3, outputs=(3,)))
    t = time.perf_counter()
    out_p = erk_kernel._plain(fp, tab, u0_l, p_l, sv, **kargs)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    max_abs = max(float((out_g[i] - out_p[i]).abs().max()) for i in (0, 1))
    hand_ms, ms = in_turns(
        lambda: erk_kernel.erk_ensemble(fh, tab, u0_l, p_l, sv, **kargs),
        lambda: erk_kernel.erk_ensemble(fg, tab, u0_l, p_l, sv, **kargs))
    row("erk_ensemble[tsit5,lorenz,f32,adaptive]",
        "erk_ensemble[tsit5,lorenz,f32,adaptive,generated]", launches,
        max_abs, ms, hand_ms, plain_ms, bitwise)

    # ---- the same row on tsit5_copy, a user tableau with tsit5's
    # interpolant: the hand-written RHS, the generated tableau struct ----
    copy = interp_tableaus()["tsit5_copy"]
    erk_kernel.launches = 0
    solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                         **dict(kw, alg=copy))
    sync(device)
    launches = erk_kernel.launches
    out_c = erk_kernel.erk_ensemble(fh, copy, u0_l, p_l, sv, **kargs)
    bitwise = all(torch.equal(a, b) for a, b in zip(out_h, out_c))
    t = time.perf_counter()
    out_p = erk_kernel._plain(fh, copy, u0_l, p_l, sv, **kargs)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    max_abs = max(float((out_c[i] - out_p[i]).abs().max()) for i in (0, 1))
    hand_ms, ms = in_turns(
        lambda: erk_kernel.erk_ensemble(fh, tab, u0_l, p_l, sv, **kargs),
        lambda: erk_kernel.erk_ensemble(fh, copy, u0_l, p_l, sv, **kargs))
    row("erk_ensemble[tsit5,lorenz,f32,adaptive]",
        "erk_ensemble[tsit5_copy,lorenz,f32,adaptive,user-tableau]",
        launches, max_abs, ms, hand_ms, plain_ms, bitwise)
    if not bitwise:
        raise AssertionError("lorenz-1M-f32-adaptive on tsit5_copy: not "
                             "bitwise the hand-written tsit5")

    # ---- crn-1M-em[generated] -------------------------------------------
    crn = sde_inputs("crn", N, torch.float32, device)
    gen = translate_problem(crn)
    spec = dict(dt0=0.1, n_steps=1000, save_every=100)
    sde_kernel.launches = 0
    solve_ensemble_local(gen, alg="em", ensemble="kernel", backend="cuda",
                         t0=0.0, seed=SDE_SEED, device=device, **spec)
    sync(device)
    launches = sde_kernel.launches
    u0s, ps = crn.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    sargs = dict(noise="general", m_noise=8, t0=0.0, dt=0.1, n_steps=1000,
                 save_every=100, seed=SDE_SEED, lane_offset=0)
    (fh, gh), (fg, gg) = (crn.prob.f, crn.prob.g), (gen.prob.f, gen.prob.g)
    out_h = sde_kernel.sde_ensemble(fh, gh, "em", u0_l, p_l, **sargs)
    out_g = sde_kernel.sde_ensemble(fg, gg, "em", u0_l, p_l, **sargs)
    bitwise = all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                  for a, b in zip(out_h, out_g))
    # the plain version (evaluate) on the first 2^16 lanes
    n_plain = min(N, 2 ** 16)
    tf_, tg_ = trace_pair(fg, gg, 4, 6, f_outputs=(4,), g_outputs=(4, 8))
    t = time.perf_counter()
    out_p = sde_kernel._plain(as_function(tf_), as_function(tg_), "em",
                              "general", 8, u0_l[:, :n_plain].contiguous(),
                              p_l[:, :n_plain].contiguous(), table=None,
                              **{k: v for k, v in sargs.items()
                                 if k not in ("noise", "m_noise")})
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    mism, max_abs, e = lane_errors(
        lanes_first([x[..., :n_plain] for x in out_g[:2]]),
        lanes_first(out_p))
    q, bar = SDE_F32_TOL["crn"]
    outliers = int((e > SDE_OUTLIER).sum())
    if float(e.quantile(q)) > bar or mism + outliers > 1e-4 * n_plain:
        raise AssertionError(f"crn-1M-em[generated]: against the plain "
                             f"version {float(e.quantile(q)):.3e} at quantile "
                             f"{q} > {bar}, or {mism + outliers} lanes off")
    hand_ms, ms = in_turns(
        lambda: sde_kernel.sde_ensemble(fh, gh, "em", u0_l, p_l, **sargs),
        lambda: sde_kernel.sde_ensemble(fg, gg, "em", u0_l, p_l, **sargs))
    row("sde_ensemble[em,crn,f32,rng]", "sde_ensemble[em,crn,f32,rng,"
        "generated]", launches, max_abs, ms, hand_ms, plain_ms, bitwise,
        plain_lanes=n_plain, plain_finite_mismatch=mism)

    # ---- rober-1M-rodas5p[derived-jac] ----------------------------------
    rober = rober_inputs(N, device)
    gen = translate_problem(rober, jac=None)
    sv = torch.tensor(ROBER_SAVEAT, dtype=torch.float64, device=device)
    rkw = dict(ROBER_SETTINGS, alg="rodas5p", saveat=sv, device=device)
    rb_kernel.launches = 0
    solve_ensemble_local(gen, ensemble="kernel", backend="cuda", **rkw)
    sync(device)
    launches = rb_kernel.launches
    rtab = get_rosenbrock_tableau("rodas5p")
    u0s, ps = rober.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    rargs = dict(t0=0.0, tf=1e4, dt0=1e-6, rtol=1e-6, atol=1e-8,
                 max_iters=100_000, w_reuse=None)
    fh, fg = rober.prob.f, gen.prob.f
    out_h = rb_kernel.rosenbrock_ensemble(fh, rtab, u0_l, p_l, sv,
                                          jac=rober.prob.jac, **rargs)
    out_g = rb_kernel.rosenbrock_ensemble(fg, rtab, u0_l, p_l, sv, jac=None,
                                          **rargs)
    bitwise = all(torch.equal(a, b) for a, b in zip(out_h, out_g))
    fp = as_function(trace(fg, 3, 3, outputs=(3,)))
    t = time.perf_counter()
    out_p = rb_kernel._plain(fp, rtab, u0_l, p_l, sv, jac=None, **rargs)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    lk, lp = lanes_first(out_g), lanes_first(out_p)
    max_abs = float((lk - lp).abs().max())
    within = bool(within_rober_bar(lk, lp).all())
    hand_ms, ms = in_turns(
        lambda: rb_kernel.rosenbrock_ensemble(fh, rtab, u0_l, p_l, sv,
                                              jac=rober.prob.jac, **rargs),
        lambda: rb_kernel.rosenbrock_ensemble(fg, rtab, u0_l, p_l, sv,
                                              jac=None, **rargs))
    row("rosenbrock_ensemble[rodas5p,rober,f64,eager]",
        "rosenbrock_ensemble[rodas5p,rober,f64,eager,derived-jac]",
        launches, max_abs, ms, hand_ms, plain_ms, bitwise,
        within_rober_bar_of_plain=within,
        attempts=int((out_g[3][0].long() + out_g[3][1].long()).sum()))
    if not within:
        raise AssertionError("rober-1M-rodas5p[derived-jac]: lanes beyond "
                             "the ROBER bar of the plain version")
    rows += translate_event_data_rows(device, by_name, row, in_turns, N)
    return rows


def translate_event_data_rows(device, by_name, row, in_turns, N: int):
    """The generated event and data rows of `phase_translate_rows`:
    ball-1M-tsit5-events, osc-1M-f64-adaptive and gbm-1M-em-adaptive beside
    their hand-written twins (hand and generated kernels in turns, each
    held bitwise to the other and, on the first TRANSLATE_ROW_PLAIN_N
    lanes, to the plain version), and gbm-rate-1M-em-barrier, which no
    hand-written source compiles: K4 with the rate table and a terminal
    up-and-out barrier, held bitwise to its plain version on the first
    2^18 lanes, with its bound in f32 instructions."""
    import dataclasses
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.em.ref import solve_adaptive_lanes
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    f32, f64 = torch.float32, torch.float64
    rows = []
    n_plain = min(N, TRANSLATE_ROW_PLAIN_N)

    def first(x, k):
        return x[..., :k].contiguous()

    def vs_plain(out_g, out_p, k):
        """max |generated - plain| on the first k lanes, and whether they
        are bitwise there."""
        got = [first(x, k) for x in out_g]
        same = all(torch.equal(a, b) for a, b in zip(got, out_p))
        return max(float((got[i].double() - out_p[i].double()).abs().max())
                   for i in (0, 1, 2)), same

    def held(form, launches, bitwise, plain_bitwise, max_abs):
        """Raises unless the generated row's front door launched its kernel
        once and its output is bitwise the hand-written twin's and, on the
        first n_plain lanes, the plain version's."""
        if device.type == "cuda" and launches != 1:
            raise AssertionError(f"{form}[generated]: {launches} kernel "
                                 "launches, not 1")
        if not bitwise:
            raise AssertionError(f"{form}[generated]: not bitwise the "
                                 "hand-written form")
        if not plain_bitwise:
            raise AssertionError(f"{form}[generated]: not bitwise its plain "
                                 f"version on the first {n_plain} lanes "
                                 f"(max abs {max_abs:.3e})")

    # ---- ball-1M-tsit5-events[generated] --------------------------------
    tab = get_tableau("tsit5")
    e = torch.linspace(0.75, 0.95, N, dtype=f64, device=device)
    u0_l = torch.stack([torch.full_like(e, 10.0), torch.zeros_like(e)])
    p_l = torch.stack([torch.full_like(e, 9.8), e])
    sv = torch.tensor(np.linspace(0.0, 8.0, 81), dtype=f64, device=device)
    tol = BALL_TOL["f64"][0]
    kargs = dict(t0=0.0, tf=8.0, dt0=1e-3, rtol=tol, atol=tol, adaptive=True,
                 max_iters=100_000)
    ev_h = dp.bouncing_ball_event()
    ev_g = unregistered_event(ev_h)
    fh, fg = dp.bouncing_ball_rhs, unregistered(dp.bouncing_ball_rhs)
    ep = EnsembleProblem(dp.bouncing_ball_problem(dtype=f64), N,
                         u0s=u0_l.T.contiguous(), ps=p_l.T.contiguous())
    erk_kernel.launches = 0
    solve_ensemble_local(translate_problem(ep), ensemble="kernel",
                         backend="cuda", alg="tsit5",
                         saveat=list(np.linspace(0.0, 8.0, 81)),
                         event=ev_g, device=device, **BALL_SETTINGS,
                         rtol=tol, atol=tol)
    sync(device)
    launches = erk_kernel.launches
    out_h = erk_kernel.erk_ensemble(fh, tab, u0_l, p_l, sv, event=ev_h,
                                    **kargs)
    out_g = erk_kernel.erk_ensemble(fg, tab, u0_l, p_l, sv, event=ev_g,
                                    **kargs)
    bitwise = all(torch.equal(a, b) for a, b in zip(out_h, out_g))
    fp, evp = plain_problem(translate_problem(ep)).prob.f, \
        plain_event(ev_g, 2, 2)
    t = time.perf_counter()
    out_p = erk_kernel._plain(fp, tab, first(u0_l, n_plain),
                              first(p_l, n_plain), sv, event=evp, **kargs)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    max_abs, plain_bitwise = vs_plain(out_g, out_p, n_plain)
    hand_ms, ms = in_turns(
        lambda: erk_kernel.erk_ensemble(fh, tab, u0_l, p_l, sv, event=ev_h,
                                        **kargs),
        lambda: erk_kernel.erk_ensemble(fg, tab, u0_l, p_l, sv, event=ev_g,
                                        **kargs))
    row("erk_ensemble[tsit5,ball,f64,bounce]",
        "erk_ensemble[tsit5,ball,f64,bounce,generated]", launches, max_abs,
        ms, hand_ms, plain_ms, bitwise, plain_lanes=n_plain,
        plain_bitwise=plain_bitwise)
    held("ball-1M-tsit5-events", launches, bitwise, plain_bitwise, max_abs)

    # ---- osc-1M-f64-adaptive[generated] ---------------------------------
    big = dp.forced_oscillator_problem()
    osc = osc_inputs(N, device, f64, prob=big, p=(2.0, 0.1))
    u0s, ps = osc.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    sv = torch.tensor(OSC_ADAPTIVE["saveat"], dtype=f64, device=device)
    data = osc.prob.data
    kargs = dict(t0=0.0, tf=5.0, dt0=1e-2, rtol=1e-8, atol=1e-8,
                 adaptive=True, max_iters=100_000, data=data)
    gen = translate_problem(osc)
    fh, fg = osc.prob.f, gen.prob.f
    erk_kernel.launches = 0
    solve_ensemble_local(gen, ensemble="kernel", backend="cuda",
                         alg="tsit5", device=device, **OSC_ADAPTIVE)
    sync(device)
    launches = erk_kernel.launches
    out_h = erk_kernel.erk_ensemble(fh, tab, u0_l, p_l, sv, **kargs)
    out_g = erk_kernel.erk_ensemble(fg, tab, u0_l, p_l, sv, **kargs)
    bitwise = all(torch.equal(a, b) for a, b in zip(out_h, out_g))
    fp = plain_problem(gen).prob.f
    t = time.perf_counter()
    out_p = erk_kernel._plain(
        lambda u, p, t_, fp=fp: fp(u, p, t_, data), tab,
        first(u0_l, n_plain), first(p_l, n_plain), sv,
        **{k: v for k, v in kargs.items() if k != "data"})
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    max_abs, plain_bitwise = vs_plain(out_g, out_p, n_plain)
    hand_ms, ms = in_turns(
        lambda: erk_kernel.erk_ensemble(fh, tab, u0_l, p_l, sv, **kargs),
        lambda: erk_kernel.erk_ensemble(fg, tab, u0_l, p_l, sv, **kargs))
    row("erk_ensemble[tsit5,osc,f64,data-gather]",
        "erk_ensemble[tsit5,osc,f64,data-gather,generated]", launches,
        max_abs, ms, hand_ms, plain_ms, bitwise, plain_lanes=n_plain,
        plain_bitwise=plain_bitwise)
    held("osc-1M-f64-adaptive", launches, bitwise, plain_bitwise, max_abs)

    # ---- gbm-1M-em-adaptive[generated] (f32) ----------------------------
    prob = dp.gbm_problem(r=1.5, v=0.2, dtype=f32)
    gbm = EnsembleProblem(
        prob, N, u0s=torch.full((N, 3), 0.1, dtype=f32, device=device),
        ps=torch.tensor([1.5, 0.2], dtype=f32,
                        device=device).expand(N, 2).contiguous())
    gen = translate_problem(gbm)
    cfg = dict(ADAPTIVE_FULL)
    depth, seed = cfg.pop("depth"), cfg.pop("seed")
    saveat_t = cfg.pop("saveat")
    u0s, ps = gbm.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    sv = torch.tensor(saveat_t, dtype=f32, device=device)
    args = adaptive_args("em", "embedded", "diagonal", 3, seed=seed,
                         depth=depth, **cfg)
    k5.launches = 0
    solve_ensemble_local(gen, ensemble="kernel", backend="cuda", alg="em",
                         adaptive=True, error_est="embedded", seed=seed,
                         brownian_depth=depth, saveat=list(saveat_t),
                         device=device, **cfg)
    sync(device)
    launches = k5.launches
    (fh, gh), (fg, gg) = (prob.f, prob.g), (gen.prob.f, gen.prob.g)
    out_h = k5.sde_adaptive_ensemble(fh, gh, "em", u0_l, p_l, sv, **args)
    out_g = k5.sde_adaptive_ensemble(fg, gg, "em", u0_l, p_l, sv, **args)
    bitwise = all(torch.equal(a, b) for a, b in zip(out_h, out_g))
    pp = plain_problem(gen).prob
    t = time.perf_counter()
    out_p = solve_adaptive_lanes(pp.f, pp.g, "em", first(u0_l, n_plain),
                                 first(p_l, n_plain), sv, **args)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    max_abs, plain_bitwise = vs_plain(out_g, out_p, n_plain)
    hand_ms, ms = in_turns(
        lambda: k5.sde_adaptive_ensemble(fh, gh, "em", u0_l, p_l, sv,
                                         **args),
        lambda: k5.sde_adaptive_ensemble(fg, gg, "em", u0_l, p_l, sv,
                                         **args))
    row("sde_adaptive_ensemble[em,gbm,f32,embedded]",
        "sde_adaptive_ensemble[em,gbm,f32,embedded,generated]", launches,
        max_abs, ms, hand_ms, plain_ms, bitwise, plain_lanes=n_plain,
        plain_bitwise=plain_bitwise)
    held("gbm-1M-em-adaptive", launches, bitwise, plain_bitwise, max_abs)

    # ---- gbm-rate-1M-em-barrier: K4, the rate table and an event --------
    form = "gbm-rate-1M-em-barrier"
    rate = ensemble_problem(dp.gbm_rate_problem(dtype=f32), np.ones((N, 1)),
                            np.full((N, 1), 0.2), device=device, dtype=f32)
    ev = level_event(RATE_BARRIER, 1, True)
    kw = dict(RATE_FIXED, alg="em", event=ev, device=device)
    sde_kernel.launches = 0
    res = solve_ensemble_local(rate, ensemble="kernel", backend="cuda", **kw)
    sync(device)
    launches = sde_kernel.launches
    if device.type == "cuda" and launches != 1:
        raise AssertionError(f"{form}: {launches} kernel launches, not 1")
    if int(res.status) != 0 or not bool(torch.isfinite(res.us).all()):
        raise AssertionError(f"{form}: status {int(res.status)} or "
                             "non-finite values")
    u0s, ps = rate.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    n_steps, dt = RATE_FIXED["n_steps"], RATE_FIXED["dt0"]
    data = rate.prob.data
    sargs = dict(noise="diagonal", m_noise=1, t0=0.0, dt=dt,
                 n_steps=n_steps, save_every=RATE_FIXED["save_every"],
                 seed=RATE_FIXED["seed"], lane_offset=0, event=ev)
    f, g = rate.prob.f, rate.prob.g

    def kernel():
        return sde_kernel.sde_ensemble(f, g, "em", u0_l, p_l, data=data,
                                       **sargs)

    out_k = kernel()
    k = min(N, 2 ** 18)
    pe = plain_event(ev, 1, 1)
    t = time.perf_counter()
    out_p = sde_kernel._plain(
        lambda u, p, t_: f(u, p, t_, data), lambda u, p, t_: g(u, p, t_, data),
        "em", "diagonal", 1, first(u0_l, k), first(p_l, k), table=None,
        **dict({x: v for x, v in sargs.items()
                if x not in ("noise", "m_noise", "event")}, event=pe))
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    max_abs, plain_bitwise = vs_plain(out_k, out_p, k)
    if not plain_bitwise:
        raise AssertionError(f"{form}: not bitwise its plain version on the "
                             f"first {k} lanes (max abs {max_abs:.3e})")
    ended = out_k[2] < n_steps * dt - 1e-6
    hit = float(ended.double().mean())
    d_bar = float((out_k[1][0, ended].double() - RATE_BARRIER).abs().max())
    ms = cuda_ms(kernel, 5)
    st = out_k[3].long()
    steps = int(st[0].sum())
    ev_flops = event_ops(steps=steps, reanchors=0, hits=int(ended.sum()),
                         interp=3, cond=1, affect=0)
    ops = (steps * (GBM_RATE_STEP_OPS + LOOKUP_OPS["gather"])
           + steps * NORMAL_FLOPS + ev_flops)
    K = int(data["rate"].values.numel())
    S = n_steps // RATE_FIXED["save_every"]
    nbytes = 4 * (2 * N + S + K + S * N + N + N) + 4 * 6 * N
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32": ops / PEAK_FP32_FLOPS * 1e3,
             "int32_alu": steps * THREEFRY_ALU_OPS
             / (ALU_LANES_PER_SM * SM_LANE_CLOCKS_PER_S) * 1e3,
             "issue": (steps * (THREEFRY_ALU_OPS + THREEFRY_ADD_OPS)
                       + ops / 2) / (ISSUE_LANES_PER_SM
                                     * SM_LANE_CLOCKS_PER_S) * 1e3}
    b_instr, b_pipe, _ = k4_bound_instr("gbm-rate-1M-em", steps, F32_FAST,
                                        ev_flops)
    r = _event_row("sde_ensemble[em,gbm-rate,f32,data-gather,barrier,"
                   "generated-event]", "src/repro_torch/csrc/sde_body.cuh",
                   "src/repro/kernels/ensemble_kernel.py:533", launches,
                   max_abs, ms, plain_ms, times, functor="hand-written "
                   "GbmRate, generated event", form=form, plain_lanes=k,
                   plain_bitwise=plain_bitwise, hit_share=hit,
                   barrier_err=d_bar, bound_instr_ms=b_instr,
                   bound_instr_pipe=b_pipe)
    print(f"{form}: N={N} f32 status 0, launches {launches}, {hit:.4f} of "
          f"the lanes hit the barrier {RATE_BARRIER} (frozen u0 off it by "
          f"{d_bar:.3e}), bitwise the plain version on the first {k} lanes "
          f"{plain_bitwise} ({plain_ms:.1f} ms); kernel {ms:.3f} ms, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_pipe']}, in f32 instructions "
          f"{b_instr:.4f} ms ({b_pipe}), kernel / that bound "
          f"{ms / b_instr:.2f}x")
    rows.append(r)
    return rows


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


def phase_full_size(device, N: int = FULL_N, reps: int = FULL_REPS):
    """The main path at full size: Lorenz, float32, N trajectories, tsit5
    adaptive and fixed dt, and vern7 adaptive (the paper's GPUVern7 beside
    GPUTsit5)."""
    import torch
    from repro_torch.configs.de_problems import lorenz_ensemble
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5 import kernel as erk_kernel

    host = lorenz_ensemble(N, dtype=torch.float32)
    u0s, ps = (x.to(device).contiguous() for x in host.materialize())
    ep = EnsembleProblem(host.prob, N, u0s=u0s, ps=ps)
    forms = {
        "adaptive": dict(dt0=1e-3, saveat=torch.linspace(0.0, 1.0, 5),
                         rtol=1e-6, atol=1e-6),
        "fixed": dict(dt0=1e-3, adaptive=False, n_steps=1000,
                      save_every=250, rtol=1e-6, atol=1e-6),
        "vern7-adaptive": dict(dt0=1e-3, saveat=torch.linspace(0.0, 1.0, 5),
                               rtol=1e-6, atol=1e-6, alg="vern7"),
    }
    rows = []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for form, kw in forms.items():
        alg = kw.pop("alg", "tsit5")
        tab = get_tableau(alg)
        adaptive = kw.get("adaptive", True)
        tol = F32_TOL["adaptive" if adaptive else "fixed"]
        row_name = f"lorenz-1M-f32-{form}"
        kw = dict(kw, alg=alg, t0=0.0, tf=1.0, device=device)
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
        rel64 = lambda a, b: ((a.double() - b).abs()
                              / (1.0 + b.abs())).max().item()
        d = rel64(res.us[idx], r64.us)
        bar = tol
        if tab.interp_bpoly is None:
            # vern7's saves are Hermite's between large steps: each run's
            # carries its own interpolation error (the f64 twin's measured
            # here against a tight tsit5 solve, `herm`), so they are held
            # within the f32 bar plus both runs' Hermite error; its final
            # state, a step's end, is held at the f32 bar alone
            tight = solve_ensemble_local(
                ep64, ensemble="kernel", backend="torch",
                **dict(kw, alg="tsit5", rtol=1e-10, atol=1e-10,
                       saveat=res.ts.double()))
            herm = rel64(r64.us, tight.us)
            bar = tol + 2 * herm
            d_final = rel64(res.u_final[idx], r64.u_final)
            print(f"full {form}: f32 vs f64 twin at t_f {d_final:.3e} (bar "
                  f"{tol}); the f64 twin's Hermite saves {herm:.3e} off a "
                  f"tsit5 solve at rtol 1e-10")
            if d_final > tol:
                raise AssertionError(f"{form}: f32 kernel vs f64 twin at t_f "
                                     f"{d_final:.3e} > {tol}")
        if d > bar:
            raise AssertionError(f"{form}: f32 kernel vs f64 twin {d:.3e} > "
                                 f"{bar:.3e}")

        # ---- times: the kernel and its plain twin on the same inputs ----
        u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
        sv = res.ts.contiguous()
        kargs = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6,
                     adaptive=adaptive, max_iters=100_000)
        f = ep.prob.f
        out_k = erk_kernel.erk_ensemble(f, tab, u0_l, p_l, sv, **kargs)
        out_p = erk_kernel._plain(f, tab, u0_l, p_l, sv, **kargs)
        max_abs = max(float((out_k[i] - out_p[i]).abs().max())
                      for i in (0, 1))
        rel = max(float(((out_k[i] - out_p[i]).abs()
                         / (1.0 + out_p[i].abs())).max()) for i in (0, 1))
        if rel > tol:
            raise AssertionError(f"{form}: kernel vs f32 twin {rel:.3e} > "
                                 f"{tol}")
        count_mismatch = int((out_k[3][:2] != out_p[3][:2]).any(0).sum())
        ms = cuda_ms(lambda: erk_kernel.erk_ensemble(
            f, tab, u0_l, p_l, sv, **kargs), reps)
        plain_ms = cuda_ms(lambda: erk_kernel._plain(
            f, tab, u0_l, p_l, sv, **kargs), 1, warmup=0)
        # the plain strategies (Figs. 5/6) on the adaptive tsit5 form;
        # the fixed form, whose plain runs take seconds, times the lanes
        # twin alone (above: its front door on kernel/torch is the same
        # lanes loop, 5.0 s, so it is not run)
        strategies = {}
        others = {"kernel_torch": ("kernel", "torch"),
                  "vmap": ("vmap", "torch"), "array": ("array", "torch")}
        if form == "fixed":
            others = {}
        for name, (ens, be) in {"kernel_cuda": ("kernel", "cuda"),
                                **(others if alg == "tsit5" else {})
                                }.items():
            strategies[name] = cuda_ms(lambda: solve_ensemble_local(
                ep, ensemble=ens, backend=be, **kw),
                reps if be == "cuda" else 1, warmup=1 if be == "cuda" else 0)

        # ---- bound: the larger of bytes / HBM rate and ops / FP32 peak ---
        item = 4
        bytes_moved = item * (3 * N + 3 * N + S) + item * (S * 3 * N + 3 * N
                                                           + N) + 4 * 6 * N
        flops = (attempts * attempt_flops(tab, 3, 9, adaptive)
                 + N * S * save_flops(tab, 3))
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        print(f"full {form}: N={N} f32 status 0, attempts {attempts}, "
              f"launches {launches}, f32 vs f64 twin {d:.3e} "
              f"(bar {bar:.3e}), kernel vs f32 twin max abs "
              f"{max_abs:.3e}, rel {rel:.3e} ({count_mismatch} lanes with "
              "other counts)")
        print(f"full {form}: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms ({flops:.3e} ops, "
              f"{bytes_moved:.3e} bytes); front door ms "
              + json.dumps({k: round(v, 3) for k, v in strategies.items()}))
        saves, stores = k1_saves(sv, 0.0, out_k[2])
        st = out_k[3].long()
        work = k1_work(row_name, attempts=int((st[0] + st[1]).sum()),
                       accepted=int(st[0].sum()), saves=saves,
                       stores=stores, adaptive=adaptive)
        extra = k1_row_extra(row_name, ms, out_k[3], work, False, t_bytes)
        rows.append({
            "name": f"erk_ensemble[{alg},lorenz,f32,{form.split('-')[-1]}]",
            "route": "cuda",
            "source": "src/repro_torch/csrc/" + erk_kernel.source_of(alg),
            "replaces": "src/repro/kernels/ensemble_kernel.py:184",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "front_door_ms": strategies["kernel_cuda"],
            **extra})
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


def phase_sde_full_size(device, N: int = FULL_N, reps: int = FULL_REPS):
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

        out_k = kernel()
        # the plain version runs once, timed (host clock around a synchronised
        # run: it is a host loop)
        t = time.perf_counter()
        out_p = plain()
        sync(device)
        plain_ms = (time.perf_counter() - t) * 1e3
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
        # the plain version through the front door ("kernel"/"torch", and
        # "array": the same lanes loop over the whole ensemble) is the twin
        # timed above, so it is not run again; "vmap" on gbm-1M-em only
        # (the CRN sweep's takes 13.2 s a run, platen_w2's 1.1 s)
        strategies = {}
        fronts = {"kernel_cuda": ("kernel", "cuda")}
        if form == "gbm-1M-em":
            fronts["vmap"] = ("vmap", "torch")
        for sname, (ens, be) in fronts.items():
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
        extra = k4_row_extra(form, N * n_steps)
        print(f"{form}: kernel / bound in instructions "
              f"{ms / extra['bound_instr_ms']:.2f}x")
        rows.append({
            "name": f"sde_ensemble[{alg},{name},f32,rng]", "route": "cuda",
            "source": "src/repro_torch/csrc/sde_ensemble.cu",
            "replaces": "src/repro/kernels/ensemble_kernel.py:533",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if pipe == "bytes" else "operations",
            "bound_pipe": pipe, "library_ms": None, **extra})
    return rows


# ---------------------------------------------------------------------------
# the adaptive SDE family: the kernel on the virtual Brownian tree (K5)
# ---------------------------------------------------------------------------

def adaptive_args(alg: str, est: str, noise: str, m: int, *, t0, tf, dt0,
                  rtol, atol, seed, depth=None, lane_offset=0):
    """The adaptive wrapper's arguments, resolved by the front door's
    rule (`resolve_adaptive_sde`)."""
    from repro_torch.core.ensemble import resolve_adaptive_sde
    from repro_torch.core.methods import get_method
    return dict(resolve_adaptive_sde(get_method(alg), noise, error_est=est,
                                     brownian_depth=depth, t0=t0, tf=tf,
                                     dt0=dt0),
                noise=noise, m_noise=m, t0=t0, tf=tf, dt0=dt0, rtol=rtol,
                atol=atol, max_iters=100_000, seed=seed,
                lane_offset=lane_offset)


def adaptive_compare(ok, op):
    """(stats identical, lanes whose outputs are bitwise equal, worst
    relative state difference where both are finite, non-finite placement
    equal) of a wrapper's (us, u_final, t_final, stats) against the plain
    version's."""
    import torch
    stats_equal = bool(torch.equal(ok[3], op[3]))
    bitwise = torch.ones(ok[1].shape[-1], dtype=torch.bool,
                         device=ok[1].device)
    worst, nan_equal = 0.0, True
    for a, b in zip(ok[:3], op[:3]):
        same = (a == b) | (a.isnan() & b.isnan())
        bitwise &= same.reshape(-1, same.shape[-1]).all(dim=0)
        fa, fb = a.isfinite(), b.isfinite()
        nan_equal &= bool(torch.equal(fa, fb))
        both = fa & fb
        d = (a[both] - b[both]).abs() / b[both].abs().clamp_min(1e-300)
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return stats_equal, bitwise, worst, nan_equal


def phase_sde_adaptive_parity(device, N: int = PARITY_N):
    """f64, the adaptive kernel against its plain version on the same card:
    the CPU front-door cases, GBM at t in [0, 1] and CRN on the Table-4
    sweep at t in [0, 10]."""
    import torch
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em.ref import solve_adaptive_lanes

    cases = [("gbm", "em", "embedded"), ("gbm", "em", "doubling"),
             ("gbm", "milstein", "embedded"), ("gbm", "milstein", "doubling"),
             ("gbm", "heun_strat", "doubling"),
             ("gbm", "platen_w2", "doubling"), ("crn", "em", "doubling")]
    eps = {name: sde_inputs(name, N, torch.float64, device)
           for name in ADAPTIVE_SETTINGS}
    out = {}
    for name, alg, est in cases:
        ep = eps[name]
        prob = ep.prob
        st = dict(ADAPTIVE_SETTINGS[name])
        saveat = torch.tensor(st.pop("saveat"), dtype=torch.float64,
                              device=device)
        off = 2 ** 32 - 20 if name == "crn" else 0
        args = adaptive_args(alg, est, prob.noise, prob.noise_dim(),
                             seed=SDE_SEED, lane_offset=off, **st)
        u0s, ps = ep.materialize()
        u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
        before = k5.launches
        t = time.perf_counter()
        ok = k5.sde_adaptive_ensemble(prob.f, prob.g, alg, u0_l, p_l, saveat,
                                      **args)
        op = solve_adaptive_lanes(prob.f, prob.g, alg, u0_l, p_l, saveat,
                                  **args)
        sync(device)
        secs = time.perf_counter() - t
        if device.type == "cuda" and k5.launches != before + 1:
            raise AssertionError(f"adaptive parity {name}/{alg}/{est}: the "
                                 "kernel was not launched")
        stats_equal, bitwise, worst, nan_equal = adaptive_compare(ok, op)
        if not (stats_equal and nan_equal) or worst > ADAPTIVE_TOL:
            bad = int((ok[3] != op[3]).any(dim=0).sum())
            raise AssertionError(
                f"adaptive parity {name}/{alg}/{est}: stats differ on {bad} "
                f"lanes, NaN placement equal {nan_equal}, worst rel state "
                f"difference {worst:.3e} (bar {ADAPTIVE_TOL})")
        stats = ok[3]
        attempts = (stats[0] + stats[1]).double()
        key = f"{name}/{alg}/{est}"
        out[key] = dict(bitwise_share=float(bitwise.double().mean()),
                        worst=worst,
                        status2_share=float((stats[2] == 2).double().mean()))
        print(f"adaptive parity {key}: N={N} f64 stats identical on every "
              f"lane, bitwise lanes {out[key]['bitwise_share']:.4f}, worst "
              f"rel {worst:.3e} (bar {ADAPTIVE_TOL}); attempts mean "
              f"{float(attempts.mean()):.1f} max {int(attempts.max())}, "
              f"status 2 share {out[key]['status2_share']:.4f}, depth "
              f"{args['depth']}; {secs:.1f} s with the plain version")
    return out


def phase_sde_adaptive_full_size(device, N: int = FULL_N, reps: int = FULL_REPS):
    """The adaptive SDE path at full size, float32, through the front door:
    GBM with the embedded pair and with step doubling."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.kernels import rng
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em.ref import solve_adaptive_lanes
    from repro_torch.kernels.queue import simt_efficiency

    f32, f64 = torch.float32, torch.float64
    r, v = 1.5, 0.2
    prob = dp.gbm_problem(r=r, v=v, dtype=f32)
    gbm = EnsembleProblem(
        prob, N, u0s=torch.full((N, 3), 0.1, dtype=f32, device=device),
        ps=torch.tensor([r, v], dtype=f32,
                        device=device).expand(N, 2).contiguous())
    cfg = dict(ADAPTIVE_FULL)
    depth, seed = cfg.pop("depth"), cfg.pop("seed")
    saveat_t = cfg.pop("saveat")
    S, n, m = len(saveat_t), 3, 3
    u0s, ps = gbm.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    # the closed form on the same path: W(1) from the port's tree, in f64
    lanes = torch.arange(N, dtype=torch.int64, device=device)
    w1 = rng.brownian_bridge_point(
        seed, torch.full((m, 1), 2 ** depth, dtype=torch.int64,
                         device=device), lanes[None],
        torch.arange(m, dtype=torch.int64, device=device)[:, None],
        depth=depth, t_total=1.0, dtype=f64)
    exact = 0.1 * torch.exp((r - 0.5 * v * v) * 1.0 + v * w1)   # (3, N)

    def strong(uf_lanes):
        """(median, 99th percentile, max) of |u_final - exact| / exact over
        the first lanes."""
        k = uf_lanes.shape[-1]
        e = ((uf_lanes.double() - exact[:, :k]).abs() / exact[:, :k])
        e = e.flatten()
        return float(e.median()), float(e.quantile(0.99)), float(e.max())

    rows = []
    for form, est in (("gbm-1M-em-adaptive", "embedded"),
                      ("gbm-1M-em-adaptive-doubling", "doubling")):
        kw = dict(alg="em", adaptive=True, error_est=est, seed=seed,
                  brownian_depth=depth, saveat=list(saveat_t), device=device,
                  **cfg)
        # ---- the path, with the launch count read around it --------------
        k5.launches = 0
        res = solve_ensemble_local(gbm, ensemble="kernel", backend="cuda",
                                   **kw)
        sync(device)
        launches = k5.launches
        if device.type == "cuda" and launches != 1:
            raise AssertionError(f"{form}: {launches} kernel launches, not 1")
        if tuple(res.us.shape) != (N, S, n) or int(res.status) != 0 or \
                not bool(torch.isfinite(res.us).all()):
            raise AssertionError(f"{form}: shape {tuple(res.us.shape)}, "
                                 f"status {int(res.status)}, or non-finite")

        # ---- the kernel and its plain version on the same inputs ---------
        saveat = torch.tensor(saveat_t, dtype=f32, device=device)
        args = adaptive_args("em", est, "diagonal", m, seed=seed,
                             depth=depth, **cfg)
        f, g = prob.f, prob.g

        def kernel():
            return k5.sde_adaptive_ensemble(f, g, "em", u0_l, p_l, saveat,
                                            **args)

        def plain(u0=u0_l, p=p_l, sv=saveat):
            return solve_adaptive_lanes(f, g, "em", u0, p, sv, **args)

        out_k = kernel()
        t = time.perf_counter()
        out_p = plain()
        sync(device)
        plain_ms = (time.perf_counter() - t) * 1e3
        same = (out_k[3][:2] == out_p[3][:2]).all(dim=0)
        share = float(same.double().mean())
        e_lane = ((out_k[1].double() - out_p[1].double()).abs()
                  / out_p[1].double().abs()).max(dim=0).values
        worst_same = float(e_lane[same].max())
        worst_any = float(e_lane.max())
        max_abs = max(float((out_k[i].double() - out_p[i].double()).abs()
                            .max()) for i in (0, 1))
        if share < ADAPTIVE_F32_SAME or worst_same > ADAPTIVE_F32_TOL or \
                worst_any > ADAPTIVE_ANY_TOL:
            raise AssertionError(
                f"{form}: counts equal on {share:.5f} of the lanes (bar "
                f"{ADAPTIVE_F32_SAME}), u_final rel {worst_same:.3e} on them "
                f"(bar {ADAPTIVE_F32_TOL}), {worst_any:.3e} on all (bar "
                f"{ADAPTIVE_ANY_TOL})")
        # ---- strong error against the closed form: the kernel's median
        # on the first STRONG_N lanes against the f64 plain version's there
        k = min(STRONG_N, N)
        out_64 = plain(u0_l[:, :k].double().contiguous(),
                       p_l[:, :k].double().contiguous(), saveat.double())
        sk, sk_sub, s64 = (strong(out_k[1]), strong(out_k[1][:, :k]),
                           strong(out_64[1]))
        if abs(sk_sub[0] / s64[0] - 1.0) > ADAPTIVE_MEDIAN_TOL:
            raise AssertionError(f"{form}: strong-error median {sk_sub[0]:.4e}"
                                 f" not within {ADAPTIVE_MEDIAN_TOL:.0%} of the"
                                 f" f64 plain version's {s64[0]:.4e}")
        del out_64

        # ---- times ------------------------------------------------------
        ms = cuda_ms(kernel, reps)
        strategies = {"kernel_cuda": cuda_ms(lambda: solve_ensemble_local(
            gbm, ensemble="kernel", backend="cuda", **kw), reps)}
        # no plain strategy ("vmap" takes 5.4 s a run on the embedded
        # form): the plain version's time is the row's plain_ms

        # ---- bound: the run's own attempts, K4's formula ------------------
        stats = out_k[3]
        attempts = int((stats[0].long() + stats[1].long()).sum())
        descents = 1 if est == "embedded" else 2
        # depth normals a descent and row, W(T) once a trajectory and row
        normals = attempts * descents * m * depth + N * m
        item = 4
        bytes_moved = (item * (n * N + 2 * N + S)
                       + item * (S * n * N + n * N + N) + 4 * 6 * N)
        flops = (normals * BRIDGE_FLOPS_PER_NORMAL
                 + attempts * ADAPTIVE_ATTEMPT_FLOPS[est])
        alu_ops = normals * THREEFRY_ALU_OPS
        issued = normals * (THREEFRY_ALU_OPS + THREEFRY_ADD_OPS) + flops / 2
        times = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
                 "fp32": flops / PEAK_FP32_FLOPS * 1e3,
                 "int32_alu": alu_ops / (ALU_LANES_PER_SM
                                         * SM_LANE_CLOCKS_PER_S) * 1e3,
                 "issue": issued / (ISSUE_LANES_PER_SM
                                    * SM_LANE_CLOCKS_PER_S) * 1e3}
        pipe = max(times, key=times.get)
        bound = times[pipe]
        lane_att = (stats[0] + stats[1]).double()
        eff = simt_efficiency(stats[0].long() + stats[1].long())
        regs = row_registers(form)
        print(f"sde {form}: N={N} f32 status 0, launches {launches}; kernel "
              f"vs f32 plain: counts equal on {share:.5f} of the lanes (bar "
              f"{ADAPTIVE_F32_SAME}), u_final rel {worst_same:.3e} on them "
              f"(bar {ADAPTIVE_F32_TOL}), {worst_any:.3e} on all (bar "
              f"{ADAPTIVE_ANY_TOL}), max abs {max_abs:.3e}")
        print(f"sde {form}: strong error vs the closed form on the same path "
              f"(median, p99, max): kernel f32 on all {N} lanes {sk[0]:.4e} "
              f"{sk[1]:.4e} {sk[2]:.4e}; on the first {k}: kernel f32 "
              f"{sk_sub[0]:.4e} {sk_sub[1]:.4e} {sk_sub[2]:.4e}, f64 plain "
              f"{s64[0]:.4e} {s64[1]:.4e} {s64[2]:.4e} (medians within "
              f"{ADAPTIVE_MEDIAN_TOL:.0%})")
        print(f"sde {form}: attempts {attempts} (per lane mean "
              f"{float(lane_att.mean()):.1f}, max {int(lane_att.max())}; "
              f"naccept mean {float(stats[0].double().mean()):.1f}), normals "
              f"{normals:.4e}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound:.4f} ms by {pipe} (" + ", ".join(
                  f"{k} {v:.4f}" for k, v in times.items())
              + "); front door ms " + json.dumps(
                  {k: round(v, 3) for k, v in strategies.items()}))
        print(f"sde {form}: SIMT efficiency {eff:.4f} (one trajectory a "
              f"thread), registers {regs}")
        rows.append({
            "name": f"sde_adaptive_ensemble[em,gbm,f32,{est}]",
            "route": "cuda",
            "source": "src/repro_torch/csrc/sde_adaptive_ensemble.cu",
            "replaces": "src/repro/kernels/ensemble_kernel.py:602",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if pipe == "bytes" else "operations",
            "bound_pipe": pipe, "library_ms": None,
            "simt_efficiency": eff, "registers": regs,
            "counts_equal_share": share,
            "strong_error_median": sk[0]})
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


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN where NaN."""
    import torch
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


def launches_ms(launch, n: int = 50, reps: int = 3) -> float:
    """Device time of one launch: CUDA events around `n` back-to-back
    launches on buffers the caller made, over n (median of `reps`)."""
    import torch
    launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def graph_ms(launch, n: int = 50, reps: int = 3) -> float:
    """As `launches_ms`, with the n launches captured in one CUDA graph and
    replayed, so that no host time lies between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    return launches_ms(graph.replay, 1, reps) / n


def lu_split_work(n: int, N: int, item: int = 8):
    """(bytes, float operations) of the factor and of one resolve of N
    systems of n (csrc/lu_solve.cu): the factor reads W and writes the
    state (n² words, n - 1 pivot bytes, pivmin); a resolve reads the state
    and b and writes x."""
    resolve_ops = 2 * n * (n - 1) + n
    factor = (N * (2 * n * n * item + (n - 1) + item),
              N * (lu_ops(n) - resolve_ops))
    resolve = (N * (n * n * item + (n - 1) + 2 * n * item),
               N * resolve_ops)
    return factor, resolve


def work_bound_ms(work) -> float:
    nbytes, ops = work
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FP64_FLOPS) * 1e3


def k6_split_times(W, b) -> dict:
    """The factor and resolve entries on W (N, n, n) and b (n, N) on the
    card: device ms by events around 50 launches (and in a CUDA graph),
    the wrapper's host ms (`perf_counter`, no sync), and each bound."""
    import torch
    from repro_torch.kernels.lu import kernel as lu_kernel
    n, N = W.shape[-1], W.shape[0]
    lu, piv, pm = lu_kernel.lu_factor(W)
    factor = lambda: lu_kernel.lu_factor(W)
    resolve = lambda: lu_kernel.lu_resolve(lu, piv, b)
    out = {}
    for name, fn, work in zip(("factor", "resolve"), (factor, resolve),
                              lu_split_work(n, N)):
        host = []
        for _ in range(20):
            t = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        out[name] = {"ms": launches_ms(fn), "graph_ms": graph_ms(fn),
                     "host_ms": statistics.median(host),
                     "bound_ms": work_bound_ms(work)}
    return out


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
        # the factor and resolve entries: the one-shot kernel's bits, x and
        # pivmin, singular systems included, on the batch-major W (no
        # copy); and the reroute taken at factor time
        fl0, rl0 = lu_kernel.factor_launches, lu_kernel.resolve_launches
        lu_st, piv_st, pm_st = lu_kernel.lu_factor(W)
        xs = lu_kernel.lu_resolve(lu_st, piv_st, bl)
        fac = lu_ops_mod.factor(W)
        lu_ops_mod.rerouted = 0
        xr = lu_ops_mod.resolve(fac, b.T)
        sync(device)
        if device.type == "cuda" and (
                lu_kernel.factor_launches - fl0 != 2
                or lu_kernel.resolve_launches - rl0 != 2):
            raise AssertionError(f"lu n={n}: the factor and resolve entries "
                                 "were not launched")
        split_bitwise = same_bits(xs, x) and same_bits(pm_st, pm)
        if not (split_bitwise and same_bits(xr, xb.T)
                and lu_ops_mod.rerouted == rerouted):
            raise AssertionError(f"lu n={n}: factor + resolve differ from "
                                 "the one-shot kernel or its reroute")
        split = k6_split_times(W, bl)
        plain_f = lambda: lu_kernel.pack_factors(
            lu_kernel.lu_factor_lanes(Wl), n)
        plain_r = lambda: lu_kernel.lu_resolve_lanes(
            lu_kernel.unpack_factors(lu_st, piv_st, pm_st), bl)
        LU, lpiv, _ = torch.linalg.lu_factor_ex(W)
        lib_f = lambda: torch.linalg.lu_factor_ex(W)
        lib_r = lambda: torch.linalg.lu_solve(LU, lpiv, b[..., None])
        split_rows = []
        for name, plain, lib, libname in (
                ("factor", plain_f, lib_f, "torch.linalg.lu_factor_ex"),
                ("resolve", plain_r, lib_r, "torch.linalg.lu_solve")):
            t = split[name]
            t.update(plain_ms=cuda_ms(plain, 1), library_ms=cuda_ms(lib, 3))
            print(f"lu n={n} {name}: N={N}, bitwise to the one-shot kernel "
                  f"{split_bitwise} (x and pivmin, {int(sing.sum())} singular "
                  f"systems included; the reroute at factor time equal), "
                  f"device {t['ms']:.4f} ms a launch (50 back to back; "
                  f"{t['graph_ms']:.4f} in a CUDA graph), wrapper host "
                  f"{t['host_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"(bytes), plain {t['plain_ms']:.3f} ms, library {libname} "
                  f"{t['library_ms']:.3f} ms")
            split_rows.append({
                "name": f"lu_{name}[f64,n={n}]", "n": n, "route": "cuda",
                "source": "src/repro_torch/csrc/lu_solve.cu",
                "replaces": "src/repro/kernels/lu/kernel.py:115",
                "launches": None, "max_abs_err": 0.0 if split_bitwise
                else float("nan"), "ms": t["ms"], "graph_ms": t["graph_ms"],
                "host_ms": t["host_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes",
                "library_ms": t["library_ms"], "library": libname})

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
        rows += split_rows
    return rows


def phase_array_linsolve_cuda(device, N: int = 2 ** 16, reps: int = 3):
    """The `array` strategy with the batched LU kernel as its W solve:
    ROBER, rodas4, against the same strategy on the library's LU.  One
    factor launch per W build, one resolve launch per stage solve, no sync
    inside a resolve; the front door a median of `reps` for both routes;
    the factor's and the resolve's device times at the path's shape."""
    import torch
    from repro_torch.core import rosenbrock as rb
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels.lu import kernel as lu_kernel
    from repro_torch.kernels.lu import ops as lu_ops_mod

    ep = rober_inputs(N, device)
    kw = dict(ROBER_SETTINGS, alg="rodas4", ensemble="array", device=device,
              saveat=torch.tensor(ROBER_SAVEAT, dtype=torch.float64))

    def run(linsolve):
        t = time.perf_counter()
        res = solve_ensemble_local(ep, linsolve=linsolve, **kw)
        sync(device)
        return res, time.perf_counter() - t

    lu_kernel.launches = lu_kernel.factor_launches = 0
    lu_kernel.resolve_launches = lu_ops_mod.rerouted = 0
    rc, secs = run("cuda")
    launches = (lu_kernel.factor_launches, lu_kernel.resolve_launches,
                lu_kernel.launches)
    rerouted = lu_ops_mod.rerouted
    secs_cuda, secs_torch = [secs], []
    rt, secs = run("torch")
    secs_torch.append(secs)
    for _ in range(reps - 1):
        secs_cuda.append(run("cuda")[1])
        secs_torch.append(run("torch")[1])
    iters = int((rc.naccept + rc.nreject).max())
    stages = 6
    # eager rodas4 builds W once a loop iteration
    if device.type == "cuda" and launches != (iters, stages * iters, 0):
        raise AssertionError(f"array linsolve=cuda: (factor, resolve, "
                             f"one-shot) launches {launches}, not ({iters}, "
                             f"{stages} x {iters}, 0)")
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
    # one step's stage solves under the sync check: a resolve that read
    # anything back to the host would raise
    rtab = get_rosenbrock_tableau("rodas4")
    u0s, ps = ep.materialize()
    u, p = u0s.T.contiguous(), ps.T.contiguous()
    t0 = torch.zeros(N, dtype=u.dtype, device=device)
    dt = torch.full((N,), 1e-3, dtype=u.dtype, device=device)
    fac = rb._w_factor(rb._w_build(rb._jac_lanes(ep.prob.f, u, p, t0,
                                                 ep.prob.jac), dt,
                                   float(rtab.gamma)), "cuda")
    checked = []

    def solve(rhs):
        if device.type != "cuda":
            return rb._w_resolve(fac, rhs, "cuda")
        torch.cuda.set_sync_debug_mode("error")
        try:
            x = rb._w_resolve(fac, rhs, "cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked.append(x)
        return x

    rb._stage_loop(ep.prob.f, rtab, u, p, t0, dt, solve)
    if device.type == "cuda" and len(checked) != stages:
        raise AssertionError("array linsolve=cuda: the sync check ran "
                             f"{len(checked)} resolves")
    med_c, med_t = statistics.median(secs_cuda), statistics.median(secs_torch)
    print(f"array rodas4 linsolve=cuda: N={N} f64 status 0, launches: "
          f"factor {launches[0]} (one per W build: {iters} loop "
          f"iterations), resolve {launches[1]} (one per stage solve: "
          f"{stages} x {iters}), one-shot {launches[2]}; {rerouted} systems "
          f"rerouted; {stages} resolves of a step under "
          "set_sync_debug_mode('error') raised nothing; against "
          f"linsolve=torch every lane within the ROBER bar, worst {worst:.3e}"
          f", lanes with equal counts {same:.4f}; front door median of "
          f"{reps}: {med_c:.3f} s (cuda) and {med_t:.3f} s (torch); runs "
          + json.dumps({"cuda": [round(x, 3) for x in secs_cuda],
                        "torch": [round(x, 3) for x in secs_torch]}))
    # K6's two entries at the path's shape (2^16 systems of n = 3) and at
    # 2^20, the path's W layout and a stage's right-hand side
    t = time.perf_counter()
    out = {"path_n_systems": N, "front_door_s": {"cuda": med_c,
                                                  "torch": med_t}}
    for n_sys in (N, FULL_N):
        Wn, bn = lu_batch(3, n_sys)
        W = torch.from_numpy(Wn).to(device)
        b = torch.from_numpy(bn).to(device).T.contiguous()
        split = k6_split_times(W, b)
        loss = {k: launches[i] * (split[k]["ms"] - split[k]["bound_ms"])
                for i, k in enumerate(("factor", "resolve"))}
        print(f"lu n=3 split at N={n_sys}: " + "; ".join(
            f"{k} device {v['ms']:.4f} ms ({v['graph_ms']:.4f} in a graph), "
            f"host {v['host_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms"
            for k, v in split.items())
            + (f"; the path's launches x (device - bound): factor "
               f"{loss['factor']:.2f} ms, resolve {loss['resolve']:.2f} ms"
               if n_sys == N else ""))
        out[f"split_{n_sys}"] = split
    REPORT_S["K6 at 2^16"] = time.perf_counter() - t
    return launches, out


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


def rosenbrock_special_ops(rtab, n: int, lookups: int = 0):
    """(divisions, square roots, pows) inside rosenbrock_attempt_ops'
    counts: per attempt the s back-substitutions' n divides, the error
    norm's n + 1 and its sqrt, the controller's two pows and one divide a
    table lookup; per factorization n reciprocals; per save one divide."""
    return ({"div": rtab.stages * n + n + 1 + lookups, "sqrt": 1, "pow": 2},
            {"div": n}, {"div": 1})


def bound_instr_ms(ops: float, special: dict, fast: dict) -> float:
    """The FP64 bound in the card's instructions: each add and multiply one
    instruction, each division, sqrt and pow its fast path's FP64-pipe
    instructions (`fp64_fast_paths`, this build's SASS), over the FP64
    instruction rate."""
    instr = ops + sum(k * (fast[op]["fp64"] - 1) for op, k in special.items())
    return instr / FP64_INSTR_PER_S * 1e3


def special_total(parts) -> dict:
    """Σ count x {op: per-unit count} over (count, per-unit) pairs."""
    out = {}
    for count, per in parts:
        for op, k in per.items():
            out[op] = out.get(op, 0) + count * k
    return out


def phase_stiff_full_size(device, N: int = FULL_N, reps: int = FULL_REPS):
    """The stiff path at full size, f64, through the front door: ROBER with
    rodas5p, and with rodas4 on lazy W beside eager rodas4."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels.queue import simt_efficiency
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
            # the paper's comparison with the plain strategies, run once,
            # on this form only: they take seconds a run ("array" is the
            # one tile of all N that "kernel_torch" runs, and that is the
            # lanes twin timed above: neither is run again)
            strategies["vmap"] = cuda_ms(lambda: solve_ensemble_local(
                ep, ensemble="vmap", backend="torch", **kw), 1, warmup=0)

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
        sp_att, sp_fact, sp_save = rosenbrock_special_ops(rtab, 3)
        special = special_total([(attempts, sp_att),
                                 (int(res.nfact), sp_fact),
                                 (N * S, sp_save)])
        b_instr = max(bound_instr_ms(ops, special, FP64_FAST), t_bytes)
        eff = simt_efficiency(out_k[3][0].long() + out_k[3][1].long())
        regs = row_registers(form)
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
        print(f"{form}: bound in the card's instructions {b_instr:.4f} ms "
              f"(kernel / it {ms / b_instr:.2f}x; {special['div']:.4e} "
              f"divisions, {special['sqrt']:.4e} sqrt, {special['pow']:.4e} "
              f"pow), SIMT efficiency {eff:.4f}, registers {regs}")
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
                "bound_instr_ms": b_instr, "simt_efficiency": eff,
                "registers": regs,
                "library_ms": None, "attempts": attempts,
                "njac": int(res.njac), "nfact": int(res.nfact)})
    lazy, eager = njac["rober-1M-rodas4-lazyW"], njac["rober-1M-rodas4-eager"]
    if not eager >= 2 * lazy:
        raise AssertionError(f"lazy W: njac {lazy} is not 2x below eager "
                             f"{eager}")
    print(f"rober-1M-rodas4: lazy-W njac {lazy} against eager {eager} "
          f"({eager / lazy:.2f}x fewer, bar 2x)")
    return rows


# ---------------------------------------------------------------------------
# the event forms of the four ensemble kernels (csrc/events.cuh): K1, K3,
# K4 and K5 with an event detected, located and applied inside the loop
# ---------------------------------------------------------------------------

# f64 parity, each kernel against its plain version on the card: K1 per-lane
# counts identical and states within 1e-10 (its no-event bar); K3 and K5
# bitwise (every operation rounded on its own on both sides); K4 within
# 1e-12, its fixed-dt bar (its event form rounds every operation on its
# own as well, so the phase prints how many lanes are bitwise).
EVENT_TOL = {"erk": 1e-10, "rosenbrock": 0.0, "sde": 1e-12,
             "sde_adaptive": 0.0}
# The bouncing ball at full size (examples/bouncing_ball.py at the paper's
# 10^6 scale): e linear over (0.75, 0.95), x0 = 10, v0 = 0, g = 9.8, 81
# saves on [0, 8].  Heights against the closed form within a bar 10x the
# error of a CPU run of the plain version on 2^18 lanes of the same sweep
# (2.08e-7 in f64 at rtol = atol = 1e-9; 2.35e-4 in f32 at 1e-6), plus, on
# a save that lies within the save and end tolerance 1e-7 max(t, 1) after
# an impact, the gap between the falling and the rising parabola there: a
# lane whose impact falls that close before tf ends at the impact, and its
# save at tf keeps the step's pre-bounce interpolant, by the reference's
# rules (one lane of the 2^20, 2.76e-6 off, on the card and on the CPU).
BALL_SETTINGS = dict(t0=0.0, tf=8.0, dt0=1e-3)
BALL_TOL = {"f64": (1e-9, 2.1e-6), "f32": (1e-6, 2.5e-3)}
# The knock-out barrier: the frozen state's first component within 1e-6 of
# it in f64 (the reference's bar, tests/test_event_parity.py) and, at full
# size in f32, within 1e-7 (10x the 7.2e-9 of a CPU run of the f32 plain
# version at N = 4096, fixed and adaptive: half an f32 ulp of 0.18).
BARRIER, BARRIER_TOL = 0.18, {"f64": 1e-6, "f32": 1e-7}
# The ramp's sawtooth on the adaptive path: u(1) = 0.1 within the
# reference's bound, 9 events of at most one dyadic cell each (2^-11 here).
SAWTOOTH_BOUND = 9 * 2.0 ** -11 + 1e-4
ROBER_HALF_TOL = 1e-6
# Float operations of the event path as the kernels write them (each add,
# multiply, divide one).  Per accepted step (per active step of the
# fixed-dt SDE kernel): the condition at both ends.  Per re-anchored start
# (g_old == 0): one interpolant and a condition.  Per hit: bisect_iters x
# (the midpoint's 2, its time's 2, the interpolant, the condition), the
# interpolant at the root, its time's 2 and the affect.  Interpolants:
# Tsitouras' 46 for the weights and 16 a state; Hermite 14 and 9 a state;
# rodas5p's Hermite needs f(u1) once (ROBER's 13); linear 3 a state.
def tsit5_interp_ops(n: int) -> int:
    return 46 + 16 * n


def event_ops(*, steps, reanchors, hits, interp, cond, affect, iters=30):
    return (steps * 2 * cond + reanchors * (interp + cond)
            + hits * (iters * (4 + interp + cond) + interp + 2 + affect))


def ball_closed_form(ts, e, g=9.8, x0=10.0):
    """Heights (N, S) of the bouncing ball at the save times ts: parabolas
    between the impacts t_1 = sqrt(2 x0 / g), t_{k+1} = t_k + 2 e^k t_1;
    the number of impacts in [0, ts[-1]] per lane; and (N, S) the gap
    between the rising and the falling parabola on saves within the save
    tolerance 1e-7 max(t, 1) after an impact (0 elsewhere).  e (N,)
    float64."""
    import torch
    t1 = float(np.sqrt(2.0 * x0 / g))
    v1 = g * t1
    out = torch.empty((e.shape[0], len(ts)), dtype=torch.float64,
                      device=e.device)
    gap = torch.zeros_like(out)
    t_imp = torch.full_like(e, t1)        # the latest impact at or before t
    speed = torch.zeros_like(e)           # the speed just after it
    hits = torch.zeros(e.shape[0], dtype=torch.int64, device=e.device)
    for j, t in enumerate(ts):
        while True:
            k = hits.double()
            nxt = torch.where(hits == 0, torch.full_like(e, t1),
                              t_imp + 2.0 * e ** k * t1)
            due = nxt <= t
            if not bool(due.any()):
                break
            t_imp = torch.where(due, nxt, t_imp)
            hits = hits + due.long()
            speed = torch.where(due, e ** hits.double() * v1, speed)
        tau = t - t_imp
        out[:, j] = torch.where(hits == 0,
                                torch.full_like(e, x0 - 0.5 * g * t * t),
                                speed * tau - 0.5 * g * tau * tau)
        near = (hits > 0) & (tau <= 1e-7 * max(abs(t), 1.0))
        # rising at `speed`, falling at `speed / e`, over tau
        gap[:, j] = torch.where(near, (speed + speed / e) * tau,
                                torch.zeros_like(e))
    return out, hits, gap


def event_parity_cases(device, N: int):
    """(name, kernel family, ensemble, front-door arguments) of the f64
    event parity phase."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    f64 = torch.float64
    lams = np.linspace(0.5, 2.0, N)
    decay = ensemble_problem(dp.linear_decay_problem(), np.ones((N, 1)),
                             lams[:, None], device=device)
    es = np.linspace(0.3, 0.9, N)
    ball = ensemble_problem(dp.bouncing_ball_problem(),
                            np.stack([np.full(N, 10.0), np.zeros(N)], 1),
                            np.stack([np.full(N, 9.8), es], 1),
                            device=device)
    gbm = sde_inputs("gbm", N, f64, device)
    ramp = ensemble_problem(dp.ramp_problem(), np.zeros((N, 1)),
                            np.tile([1.0, 1e-10], (N, 1)), device=device)
    dec = dict(t0=0.0, tf=3.0, dt0=1e-3, rtol=1e-9, atol=1e-9, saveat=[3.0],
               event=dp.half_event())
    bal = dict(t0=0.0, tf=2.0, dt0=1e-3, rtol=1e-9, atol=1e-9,
               saveat=[0.5, 1.0, 1.5, 2.0], event=dp.bouncing_ball_event())
    rober = dict(ROBER_SETTINGS, saveat=list(ROBER_SAVEAT),
                 event=dp.rober_half_event())
    fixed = dict(t0=0.0, dt0=1.0 / 200, n_steps=200, save_every=50,
                 seed=SDE_SEED, event=dp.gbm_barrier_event())
    adapt = dict(ADAPTIVE_SETTINGS["gbm"], adaptive=True, seed=SDE_SEED,
                 alg="em", event=dp.gbm_barrier_event())
    adapt["saveat"] = list(adapt["saveat"])
    saw = dict(event=dp.ramp_sawtooth_event(), seed=SDE_SEED)
    cases = []
    for alg in ("tsit5", "dopri5"):
        cases += [(f"decay {alg}", "erk", decay, dict(dec, alg=alg)),
                  (f"ball {alg}", "erk", ball, dict(bal, alg=alg))]
    cases += [("decay rosenbrock23", "rosenbrock", decay,
               dict(dec, alg="rosenbrock23")),
              ("ball rosenbrock23", "rosenbrock", ball,
               dict(bal, alg="rosenbrock23"))]
    cases += [(f"rober {alg} {'lazyW' if wr else 'eager'}", "rosenbrock",
               rober_inputs(N, device), dict(rober, alg=alg, w_reuse=wr))
              for alg, wr in (("rodas4", False), ("rodas4", True),
                              ("rodas5p", False))]
    cases += [(f"gbm barrier {alg} fixed", "sde", gbm, dict(fixed, alg=alg))
              for alg in ("em", "platen_w2")]
    cases += [(f"gbm barrier em {est}", "sde_adaptive", gbm,
               dict(adapt, error_est=est))
              for est in ("embedded", "doubling")]
    cases += [("ramp sawtooth em fixed", "sde", ramp,
               dict(saw, alg="em", t0=0.0, dt0=0.0125, n_steps=80,
                    save_every=20))]
    cases += [(f"ramp sawtooth em {est}", "sde_adaptive", ramp,
               dict(saw, alg="em", adaptive=True, error_est=est, t0=0.0,
                    tf=1.0, dt0=0.05, rtol=1e-3, atol=1e-5,
                    saveat=[0.25, 0.5, 0.75, 1.0]))
              for est in ("embedded", "doubling")]
    return cases


def event_compare(rk, rt):
    """(per-lane counts identical, worst |kernel - plain| over the saves,
    the final states and times, lanes bitwise equal)."""
    import torch
    counts = bool(torch.equal(rk.naccept, rt.naccept)
                  and torch.equal(rk.nreject, rt.nreject))
    worst, bitwise = 0.0, None
    for a, b in ((rk.us, rt.us), (rk.u_final, rt.u_final),
                 (rk.t_final, rt.t_final)):
        worst = max(worst, float((a - b).abs().max()))
        same = (a == b).reshape(a.shape[0], -1).all(dim=1)
        bitwise = same if bitwise is None else bitwise & same
    return counts, worst, int(bitwise.sum())


def phase_event_parity(device, N: int = PARITY_N):
    """f64, every event form against its plain version on the same card,
    through the front door, with the exact answers where there are some."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    mods = {"erk": erk_kernel, "rosenbrock": rb_kernel, "sde": sde_kernel,
            "sde_adaptive": k5}
    out = {}
    for name, family, ep, kw in event_parity_cases(device, N):
        mod, tol = mods[family], EVENT_TOL[family]
        before = mod.launches
        t = time.perf_counter()
        rk = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                  device=device, **kw)
        extra = dict(linsolve="lanes") if family == "rosenbrock" else {}
        rt = solve_ensemble_local(ep, ensemble="kernel", backend="torch",
                                  device=device, **kw, **extra)
        sync(device)
        secs = time.perf_counter() - t
        if device.type == "cuda" and mod.launches != before + 1:
            raise AssertionError(f"event parity {name}: the kernel was not "
                                 "launched")
        counts, worst, bitwise = event_compare(rk, rt)
        if not counts or worst > tol or int(rk.status) != 0:
            raise AssertionError(
                f"event parity {name}: counts identical {counts}, worst "
                f"|kernel - plain| {worst:.3e} (bar {tol}), status "
                f"{int(rk.status)}")
        tf = kw.get("tf", kw["t0"] + kw.get("n_steps", 0) * kw["dt0"])
        ended = rk.t_final < tf - 1e-9
        check = ""
        if name.startswith("decay"):
            exact = torch.log(torch.tensor(2.0, dtype=torch.float64)) \
                / ep.ps[:, 0]
            d = float((rk.t_final - exact).abs().max())
            if d > 1e-6:
                raise AssertionError(f"event parity {name}: t_final off "
                                     f"ln 2 / lam by {d:.3e}")
            check = f"t_final vs ln 2 / lam {d:.3e} (bar 1e-6)"
        elif name.startswith("gbm"):
            d = float((rk.u_final[ended, 0] - BARRIER).abs().max())
            if d > BARRIER_TOL["f64"]:
                raise AssertionError(f"event parity {name}: frozen state off "
                                     f"the barrier by {d:.3e}")
            check = (f"{float(ended.double().mean()):.4f} of the lanes hit, "
                     f"frozen u0 off {BARRIER} by {d:.3e} (bar "
                     f"{BARRIER_TOL['f64']})")
        elif name.startswith("rober"):
            d = float((rk.u_final[ended, 2] - 0.5).abs().max())
            if d > ROBER_HALF_TOL:
                raise AssertionError(f"event parity {name}: y3 off 0.5 by "
                                     f"{d:.3e}")
            check = (f"{float(ended.double().mean()):.4f} of the lanes hit, "
                     f"y3 off 0.5 by {d:.3e} (bar {ROBER_HALF_TOL})")
        elif name.startswith("ramp") and "fixed" not in name:
            d = float((rk.u_final[:, 0] - 0.1).abs().max())
            if d > SAWTOOTH_BOUND:
                raise AssertionError(f"event parity {name}: u(1) off 0.1 by "
                                     f"{d:.3e}")
            check = f"u(1) off 0.1 by {d:.3e} (bar {SAWTOOTH_BOUND:.3e})"
        elif name.startswith("ball"):
            low = float(rk.us[:, :, 0].min())
            if low < -1e-6:
                raise AssertionError(f"event parity {name}: the ball sank to "
                                     f"{low:.3e}")
            check = f"lowest saved height {low:.3e}"
        attempts = int((rk.naccept.long() + rk.nreject.long()).sum())
        out[name] = dict(worst=worst, bitwise_lanes=bitwise)
        print(f"event parity {name}: N={N} f64 counts identical, worst "
              f"|kernel - plain| {worst:.3e} (bar {tol}), {bitwise} of {N} "
              f"lanes bitwise; {check}; attempts {attempts}; {secs:.1f} s "
              "with the plain version")
    return out


def _event_row(name, source, replaces, launches, max_abs, ms, plain_ms,
               times, **extra):
    """A kernels-line row; `times` maps each bound's name to its ms."""
    pipe = max(times, key=times.get)
    return dict({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": times[pipe],
                 "bound_by": "bytes" if pipe == "bytes" else "operations",
                 "bound_pipe": pipe, "library_ms": None}, **extra)


def _print_row(form, front_ms, row, work, times):
    unfused = row.get("bound_unfused_ms")
    print(f"{form}: front door {front_ms:.3f} ms, kernel {row['ms']:.3f} ms, "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_pipe']} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + (f"; {unfused:.4f} at the unfused rate" if unfused else "")
          + f"), kernel / bound {row['ms'] / row['bound_ms']:.2f}x, work "
          f"{work}; plain version {row['plain_ms']:.1f} ms (one run)")


def phase_event_ball(device, N: int = FULL_N, reps: int = 3):
    """ball-1M-tsit5-events in f64 and f32 through the front door: K1's
    event form on the bouncing ball, against the closed form and the
    plain version."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.core.tableaus import get_tableau
    from repro_torch.kernels.tsit5 import kernel as erk_kernel

    f64 = torch.float64
    e64 = torch.linspace(0.75, 0.95, N, dtype=f64, device=device)
    ts = np.linspace(0.0, 8.0, 81)
    exact, hits, gap = ball_closed_form(ts, e64)
    tab = get_tableau("tsit5")
    ev = dp.bouncing_ball_event()
    rows, twin64 = [], None
    for label, dtype in (("f64", f64), ("f32", torch.float32)):
        form = "ball-1M-tsit5-events" + ("-f32" if label == "f32" else "")
        tol, bar = BALL_TOL[label]
        e = e64.to(dtype)
        ep = EnsembleProblem(
            dp.bouncing_ball_problem(dtype=dtype), N,
            u0s=torch.stack([torch.full_like(e, 10.0), torch.zeros_like(e)],
                            1).contiguous(),
            ps=torch.stack([torch.full_like(e, 9.8), e], 1).contiguous())
        kw = dict(alg="tsit5", rtol=tol, atol=tol, saveat=list(ts),
                  event=ev, device=device, **BALL_SETTINGS)
        erk_kernel.launches = 0
        res = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                   **kw)
        sync(device)
        launches = erk_kernel.launches
        if device.type == "cuda" and launches != 1:
            raise AssertionError(f"{form}: {launches} kernel launches, not 1")
        if tuple(res.us.shape) != (N, 81, 2) or int(res.status) != 0 or \
                not bool(torch.isfinite(res.us).all()):
            raise AssertionError(f"{form}: shape {tuple(res.us.shape)}, "
                                 f"status {int(res.status)} or non-finite")
        err = (res.us[:, :, 0].double() - exact).abs()
        d_exact = float(err.max())
        if bool((err > bar + gap).any()):
            raise AssertionError(
                f"{form}: heights off the closed form by {d_exact:.3e}, "
                f"beyond {bar} plus the end-of-step gap on "
                f"{int((err > bar + gap).sum())} saves")
        # ---- the kernel and its plain version on the same inputs --------
        u0s, ps = ep.materialize()
        u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
        sv = torch.tensor(ts, dtype=dtype, device=device)
        kargs = dict(t0=0.0, tf=8.0, dt0=1e-3, rtol=tol, atol=tol,
                     adaptive=True, max_iters=100_000, event=ev)
        f = ep.prob.f

        def kernel():
            return erk_kernel.erk_ensemble(f, tab, u0_l, p_l, sv, **kargs)

        out_k = kernel()
        t = time.perf_counter()
        out_p = erk_kernel._plain(f, tab, u0_l, p_l, sv, **kargs)
        sync(device)
        plain_ms = (time.perf_counter() - t) * 1e3
        same = (out_k[3][:2] == out_p[3][:2]).all(dim=0)
        max_abs = max(float((out_k[i].double() - out_p[i].double()).abs()
                            .max()) for i in (0, 1, 2))
        if label == "f64":
            if not bool(same.all()) or max_abs > EVENT_TOL["erk"]:
                raise AssertionError(
                    f"{form}: counts differ from the plain version's on "
                    f"{int((~same).sum())} lanes, or |kernel - plain| "
                    f"{max_abs:.3e} > {EVENT_TOL['erk']}")
            twin64 = out_p[0][:, 0].T            # (N, 81) heights
            note = (f"; counts identical on every lane, |kernel - plain| "
                    f"{max_abs:.3e} (bar {EVENT_TOL['erk']})")
        else:
            d64 = float((res.us[:, :, 0].double() - twin64).abs().max())
            if d64 > bar + float(gap.max()):
                raise AssertionError(f"{form}: heights off the f64 plain "
                                     f"version by {d64:.3e} > {bar}")
            note = (f"; heights off the f64 plain version by {d64:.3e} (bar "
                    f"{bar}); counts equal to the f32 plain version's on "
                    f"{float(same.double().mean()):.4f} of the lanes")
        del out_p
        ms = cuda_ms(kernel, reps)
        front_ms = cuda_ms(lambda: solve_ensemble_local(
            ep, ensemble="kernel", backend="cuda", **kw), reps)
        # ---- bound: the run's own attempts, saves and impacts -------------
        st = out_k[3].long()
        attempts, accepted = int((st[0] + st[1]).sum()), int(st[0].sum())
        nhits = int(hits.sum())
        ops = (attempts * attempt_flops(tab, 2, 0, True)
               + N * 81 * save_flops(tab, 2)
               # after a bounce the height is 0: the next step re-anchors
               + event_ops(steps=accepted, reanchors=nhits, hits=nhits,
                           interp=tsit5_interp_ops(2), cond=0, affect=1))
        item = 8 if label == "f64" else 4
        nbytes = item * (4 * N + 81 + 81 * 2 * N + 2 * N + N) + 4 * 6 * N
        peak = PEAK_FP64_FLOPS if label == "f64" else PEAK_FP32_FLOPS
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "fp64" if label == "f64" else "fp32": ops / peak * 1e3}
        # every operation is rounded on its own: at most half the peak
        unfused = max(times["bytes"], ops / (peak / 2) * 1e3)
        saves, stores = k1_saves(sv, 0.0, out_k[2])
        work = k1_work(form, attempts=attempts, accepted=accepted,
                       saves=saves, stores=stores, adaptive=True,
                       hits=nhits, reanchors=nhits)
        extra = k1_row_extra(form, ms, out_k[3], work, label == "f64",
                             times["bytes"], hits=nhits)
        row = _event_row(f"erk_ensemble[tsit5,ball,{label},bounce]",
                         "src/repro_torch/csrc/erk_ensemble.cu",
                         "src/repro/kernels/ensemble_kernel.py:461",
                         launches, max_abs, ms, plain_ms, times,
                         bound_unfused_ms=unfused, front_door_ms=front_ms,
                         attempts=attempts, impacts=nhits,
                         closed_form_err=d_exact, **extra)
        print(f"{form}: N={N} {label} status 0, launches {launches}, heights "
              f"off the closed form by {d_exact:.3e} (bar {bar}; "
              f"{int((gap > 0).sum())} saves within the tolerance after an "
              f"impact, gap up to {float(gap.max()):.3e}), impacts "
              f"{nhits} ({nhits / N:.2f} a lane), attempts {attempts} "
              f"({attempts / N:.1f} a lane)" + note)
        _print_row(form, front_ms, row, f"{attempts} attempts, {nhits} "
                   "impacts", times)
        rows.append(row)
    return rows


def phase_event_rober(device, N: int = FULL_N, reps: int = 3):
    """rober-1M-rodas5p-event: rober-1M-rodas5p's settings with the
    terminal half-conversion event, K3's event form."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels.queue import simt_efficiency
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel

    form = "rober-1M-rodas5p-event"
    ep = rober_inputs(N, device)
    sv = torch.tensor(ROBER_SAVEAT, dtype=torch.float64, device=device)
    ev = dp.rober_half_event()
    kw = dict(ROBER_SETTINGS, alg="rodas5p", saveat=sv, event=ev,
              device=device)
    rb_kernel.launches = 0
    res = solve_ensemble_local(ep, ensemble="kernel", backend="cuda", **kw)
    sync(device)
    launches = rb_kernel.launches
    if device.type == "cuda" and launches != 1:
        raise AssertionError(f"{form}: {launches} kernel launches, not 1")
    if int(res.status) != 0 or not bool(torch.isfinite(res.us).all()):
        raise AssertionError(f"{form}: status {int(res.status)} or "
                             "non-finite values")
    ended = res.t_final < 1e4
    d_half = float((res.u_final[ended, 2] - 0.5).abs().max())
    total = float((res.u_final.sum(dim=1) - 1.0).abs().max())
    if d_half > ROBER_HALF_TOL or total > ROBER_SUM_TOL:
        raise AssertionError(f"{form}: y3 off 0.5 by {d_half:.3e} or the sum "
                             f"off 1 by {total:.3e}")
    rtab = get_rosenbrock_tableau("rodas5p")
    u0s, ps = ep.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    kargs = dict(jac=ep.prob.jac, t0=0.0, tf=1e4, dt0=1e-6, rtol=1e-6,
                 atol=1e-8, max_iters=100_000, w_reuse=False, event=ev)
    f = ep.prob.f

    def kernel():
        return rb_kernel.rosenbrock_ensemble(f, rtab, u0_l, p_l, sv, **kargs)

    out_k = kernel()
    t = time.perf_counter()
    out_p = rb_kernel._plain(f, rtab, u0_l, p_l, sv, **kargs)
    sync(device)
    plain_ms = (time.perf_counter() - t) * 1e3
    lk, lp = lanes_first(out_k), lanes_first(out_p)
    bar = within_rober_bar(lk, lp)
    bitwise = int(((lk == lp).reshape(N, -1).all(dim=1)
                   & (out_k[2] == out_p[2])).sum())
    max_abs = max(float((lk - lp).abs().max()),
                  float((out_k[2] - out_p[2]).abs().max()))
    if not bool(bar.all()):
        raise AssertionError(f"{form}: {int((~bar).sum())} lanes beyond the "
                             f"ROBER bar of the plain version")
    del out_p
    ms = cuda_ms(kernel, reps)
    front_ms = cuda_ms(lambda: solve_ensemble_local(
        ep, ensemble="kernel", backend="cuda", **kw), reps)
    st = out_k[3].long()
    attempts, accepted = int((st[0] + st[1]).sum()), int(st[0].sum())
    nhits = int(ended.sum())
    per_attempt, per_jac, per_fact, per_save = rosenbrock_attempt_ops(
        rtab, 3, *STIFF_RHS_OPS["rober"])
    hermite = 14 + 9 * 3
    ops = (attempts * (per_attempt + per_jac + per_fact)
           + N * len(ROBER_SAVEAT) * per_save
           + event_ops(steps=accepted, reanchors=0, hits=nhits,
                       interp=hermite, cond=1, affect=0)
           + nhits * STIFF_RHS_OPS["rober"][0])       # f(u1), once a hit
    nbytes = 8 * (6 * N + 4 + 4 * 3 * N + 3 * N + N) + 4 * 6 * N
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp64": ops / PEAK_FP64_FLOPS * 1e3}
    unfused = max(times["bytes"], ops / PEAK_FP64_UNFUSED_OPS * 1e3)
    sp_att, sp_fact, sp_save = rosenbrock_special_ops(rtab, 3)
    special = special_total([(attempts, sp_att), (attempts, sp_fact),
                             (N * len(ROBER_SAVEAT), sp_save)])
    b_instr = max(bound_instr_ms(ops, special, FP64_FAST), times["bytes"])
    eff = simt_efficiency(st[0] + st[1])
    regs = row_registers(form)
    row = _event_row("rosenbrock_ensemble[rodas5p,rober,f64,half]",
                     "src/repro_torch/csrc/rosenbrock_ensemble.cu",
                     "src/repro/kernels/ensemble_kernel.py:491", launches,
                     max_abs, ms, plain_ms, times, bound_unfused_ms=unfused,
                     bound_instr_ms=b_instr, simt_efficiency=eff,
                     registers=regs, front_door_ms=front_ms,
                     attempts=attempts, terminated_share=nhits / N)
    print(f"{form}: N={N} f64 status 0, launches {launches}, "
          f"{nhits / N:.4f} of the lanes reach y3 = 0.5 (off it by "
          f"{d_half:.3e}, bar {ROBER_HALF_TOL}), y-sum off 1 by {total:.2e}; "
          f"against the plain version every lane within the ROBER bar, "
          f"{bitwise} of {N} lanes bitwise, max abs {max_abs:.3e}")
    _print_row(form, front_ms, row, f"{attempts} attempts", times)
    print(f"{form}: bound in the card's instructions {b_instr:.4f} ms "
          f"(kernel / it {ms / b_instr:.2f}x), SIMT efficiency {eff:.4f}, "
          f"registers {regs}")
    return [row]


def phase_event_barrier(device, N: int = FULL_N, reps: int = 3):
    """gbm-1M-em-barrier and gbm-1M-em-adaptive-barrier: the GBM forms of
    K4 and K5 (f32) with the terminal knock-out barrier."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.em.ref import solve_adaptive_lanes
    from repro_torch.kernels.queue import simt_efficiency

    f32 = torch.float32
    prob = dp.gbm_problem(r=1.5, v=0.2, dtype=f32)
    gbm = EnsembleProblem(
        prob, N, u0s=torch.full((N, 3), 0.1, dtype=f32, device=device),
        ps=torch.tensor([1.5, 0.2], dtype=f32,
                        device=device).expand(N, 2).contiguous())
    u0s, ps = gbm.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    ev = dp.gbm_barrier_event()
    n, m = 3, 3
    cfg = dict(ADAPTIVE_FULL)
    depth, seed = cfg.pop("depth"), cfg.pop("seed")
    saveat_t = cfg.pop("saveat")
    forms = [("gbm-1M-em-barrier", sde_kernel,
              dict(alg="em", t0=0.0, dt0=1.0 / 200, n_steps=200,
                   save_every=200, seed=SDE_SEED)),
             ("gbm-1M-em-adaptive-barrier", k5,
              dict(alg="em", adaptive=True, error_est="embedded", seed=seed,
                   brownian_depth=depth, saveat=list(saveat_t), **cfg))]
    rows = []
    for form, mod, spec in forms:
        kw = dict(spec, event=ev, device=device)
        mod.launches = 0
        res = solve_ensemble_local(gbm, ensemble="kernel", backend="cuda",
                                   **kw)
        sync(device)
        launches = mod.launches
        if device.type == "cuda" and launches != 1:
            raise AssertionError(f"{form}: {launches} kernel launches, not 1")
        if int(res.status) != 0 or not bool(torch.isfinite(res.us).all()):
            raise AssertionError(f"{form}: status {int(res.status)} or "
                                 "non-finite values")
        ended = res.t_final < 1.0 - 1e-6
        d_bar = float((res.u_final[ended, 0].double() - BARRIER).abs().max())
        if d_bar > BARRIER_TOL["f32"]:
            raise AssertionError(f"{form}: frozen u0 off the barrier by "
                                 f"{d_bar:.3e} > {BARRIER_TOL['f32']}")
        # ---- the kernel and its plain version on the same inputs ---------
        if mod is sde_kernel:
            kargs = dict(t0=0.0, dt=spec["dt0"], n_steps=200, save_every=200,
                         seed=SDE_SEED, lane_offset=0, event=ev)

            def kernel():
                return sde_kernel.sde_ensemble(prob.f, prob.g, "em", u0_l,
                                               p_l, noise="diagonal",
                                               m_noise=m, **kargs)

            def plain():
                return sde_kernel._plain(prob.f, prob.g, "em", "diagonal", m,
                                         u0_l, p_l, table=None, **kargs)
        else:
            saveat = torch.tensor(saveat_t, dtype=f32, device=device)
            args = dict(adaptive_args("em", "embedded", "diagonal", m,
                                      seed=seed, depth=depth, **cfg),
                        event=ev)

            def kernel():
                return k5.sde_adaptive_ensemble(prob.f, prob.g, "em", u0_l,
                                                p_l, saveat, **args)

            def plain():
                return solve_adaptive_lanes(prob.f, prob.g, "em", u0_l, p_l,
                                            saveat, **args)

        out_k = kernel()
        t = time.perf_counter()
        out_p = plain()
        sync(device)
        plain_ms = (time.perf_counter() - t) * 1e3
        same = (out_k[3][:2] == out_p[3][:2]).all(dim=0)
        share = float(same.double().mean())
        e_lane = ((lanes_first(out_k).double() - lanes_first(out_p).double())
                  .abs() / (1.0 + lanes_first(out_p).double().abs())) \
            .reshape(N, -1).max(dim=1).values
        max_abs = max(float((out_k[i].double() - out_p[i].double()).abs()
                            .max()) for i in (0, 1, 2))
        worst_same = float(e_lane[same].max())
        # both event forms round every operation on its own, as their plain
        # versions do: the adaptive rows' f32 gate holds them
        if share < ADAPTIVE_F32_SAME or worst_same > ADAPTIVE_F32_TOL \
                or float(e_lane.max()) > ADAPTIVE_ANY_TOL:
            for lane in torch.topk(e_lane, 3).indices.tolist():
                print(f"{form}: lane {lane}: steps {int(out_k[3][0, lane])} "
                      f"(plain {int(out_p[3][0, lane])}), t_final "
                      f"{float(out_k[2][lane]):.6f} "
                      f"({float(out_p[2][lane]):.6f}), u_final "
                      f"{out_k[1][:, lane].tolist()} "
                      f"({out_p[1][:, lane].tolist()}), rel "
                      f"{float(e_lane[lane]):.3e}")
            raise AssertionError(
                f"{form}: counts equal on {share:.5f} of the lanes (bar "
                f"{ADAPTIVE_F32_SAME}), states rel {worst_same:.3e} on "
                f"them (bar {ADAPTIVE_F32_TOL}), "
                f"{float(e_lane.max()):.3e} on all (bar "
                f"{ADAPTIVE_ANY_TOL})")
        bitwise = int(((out_k[3] == out_p[3]).all(dim=0)
                       & (e_lane == 0)).sum())
        gate = (f"counts equal on {share:.5f} of the lanes (bar "
                f"{ADAPTIVE_F32_SAME}), states rel {worst_same:.3e} on "
                f"them (bar {ADAPTIVE_F32_TOL}), {bitwise} of {N} lanes "
                "bitwise")
        del out_p
        ms = cuda_ms(kernel, reps)
        front_ms = cuda_ms(lambda: solve_ensemble_local(
            gbm, ensemble="kernel", backend="cuda", **kw), reps)
        # ---- bound: the run's own steps or attempts, K4's and K5's
        # formulas, plus the event work --------------------------------
        st = out_k[3].long()
        nhits = int(ended.sum())
        if mod is sde_kernel:
            steps = int(st[0].sum())       # a frozen lane draws nothing
            normals = steps * m
            flops = (steps * SDE_STEP_FLOPS[("gbm", "em")]
                     + normals * NORMAL_FLOPS)
            accepted, S = steps, 1
            work = f"{steps} active steps, {normals} normals"
        else:
            attempts, accepted = int((st[0] + st[1]).sum()), int(st[0].sum())
            normals = attempts * m * depth + N * m
            flops = (normals * BRIDGE_FLOPS_PER_NORMAL
                     + attempts * ADAPTIVE_ATTEMPT_FLOPS["embedded"])
            S = len(saveat_t)
            work = (f"{attempts} attempts, {normals} normals")
        ev_flops = event_ops(steps=accepted, reanchors=0, hits=nhits,
                             interp=3 * n, cond=1, affect=0)
        flops += ev_flops
        alu_ops = normals * THREEFRY_ALU_OPS
        issued = normals * (THREEFRY_ALU_OPS + THREEFRY_ADD_OPS) + flops / 2
        nbytes = 4 * (5 * N + S + S * n * N + n * N + N) + 4 * 6 * N
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "fp32": flops / PEAK_FP32_FLOPS * 1e3,
                 "int32_alu": alu_ops / (ALU_LANES_PER_SM
                                         * SM_LANE_CLOCKS_PER_S) * 1e3,
                 "issue": issued / (ISSUE_LANES_PER_SM
                                    * SM_LANE_CLOCKS_PER_S) * 1e3}
        kname = ("sde_ensemble[em,gbm,f32,barrier]" if mod is sde_kernel
                 else "sde_adaptive_ensemble[em,gbm,f32,embedded,barrier]")
        # K4: a warp steps while any of its lanes is active, so its SIMT
        # efficiency over the active steps tells what frozen lanes cost
        k5_extra = (dict(k4_row_extra(form, steps, ev_flops),
                         simt_efficiency=simt_efficiency(st[0]))
                    if mod is sde_kernel
                    else {"simt_efficiency": simt_efficiency(st[0] + st[1]),
                          "registers": row_registers(form)})
        src = ("sde_ensemble.cu" if mod is sde_kernel
               else "sde_adaptive_ensemble.cu")
        line = ":533" if mod is sde_kernel else ":602"
        row = _event_row(kname, f"src/repro_torch/csrc/{src}",
                         f"src/repro/kernels/ensemble_kernel.py{line}",
                         launches, max_abs, ms, plain_ms, times,
                         front_door_ms=front_ms, hit_share=nhits / N,
                         counts_equal_share=share, **k5_extra)
        print(f"{form}: N={N} f32 status 0, launches {launches}, "
              f"{nhits / N:.4f} of the lanes hit the barrier, frozen u0 off "
              f"{BARRIER} by {d_bar:.3e} (bar {BARRIER_TOL['f32']}); against "
              f"the f32 plain version: {gate}, max abs {max_abs:.3e}")
        _print_row(form, front_ms, row, work, times)
        if mod is sde_kernel:
            print(f"{form}: kernel / bound in instructions "
                  f"{ms / k5_extra['bound_instr_ms']:.2f}x, SIMT efficiency "
                  f"of the active steps {k5_extra['simt_efficiency']:.4f}")
        else:
            print(f"{form}: SIMT efficiency {k5_extra['simt_efficiency']:.4f}"
                  f" (one trajectory a thread), registers "
                  f"{k5_extra['registers']}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Data-driven problems (paper §6.7): the data forms of K1, K3, K4 and K5,
# which read `prob.data`'s tables on the card, and the lookup entry
# ---------------------------------------------------------------------------

# Float operations of a lookup as interp.cuh writes them (add, multiply,
# divide, min, max, floor one each): locating the cell 7 (sub, div, the
# clamp's min and max, floor, the weight's sub); gather and onehot 4 more
# (1 - w, two products, the sum); cubic 32 (the weights 18, four products,
# three sums).  Its tangent (K3's ∂f/∂t), from the lookup's own cell and
# the 1/dx formed once a thread: the scale's 2 products, the two products
# and their sum 4.
LOOKUP_OPS = {"gather": 11, "onehot": 11, "cubic": 32}
LOOKUP_TANGENT_OPS = 6
# the forced oscillator's RHS besides its lookup: -k x - c v + F (5)
OSC_RHS_OPS = 5
# the rate-table GBM's fixed-dt em step besides the lookup: the drift's
# product, g dW's 2, the update's 3 and t = t0 + k dt's 2; an adaptive em
# pair attempt on one state besides the lookup and the bridge normals: the
# estimator 18, the Hairer norm 10, the controller 10, the dt, t and cell
# arithmetic 8
GBM_RATE_STEP_OPS = 8
GBM_RATE_ATTEMPT_OPS = 46
# The bench configuration at the paper's scale
# (benchmarks/bench_texture_interp.py:32-35, N 1024 -> 2^20)
TEXTURE_FIXED = dict(t0=0.0, tf=1.0, dt0=1.0 / 200, n_steps=200,
                     save_every=200, adaptive=False)
# tests/test_texture_data.py's settings: the adaptive kink-limited case,
# the rosenbrock23 case, the SDE case and the level event
OSC_ADAPTIVE = dict(t0=0.0, tf=5.0, dt0=1e-2, rtol=1e-8, atol=1e-8,
                    saveat=list(np.linspace(0.0, 5.0, 11)))
OSC_STIFF = dict(t0=0.0, tf=3.0, dt0=1e-3, rtol=1e-8, atol=1e-8,
                 saveat=list(np.linspace(0.0, 3.0, 7)))
# the stiff data row on the first half of that span: its plain version, a
# host loop of ~3,500 steps on [0, 3] (44 s on 2^16 lanes), was the smoke's
# longest single run
OSC_STIFF_ROW = dict(OSC_STIFF, tf=1.5,
                     saveat=list(np.linspace(0.0, 1.5, 4)))
RATE_FIXED = dict(t0=0.0, dt0=1e-3, n_steps=500, save_every=250, seed=7)
RATE_ADAPTIVE = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-4, atol=1e-6,
                     seed=7, adaptive=True,
                     saveat=list(np.linspace(0.0, 1.0, 5)))
OSC_EVENT = dict(t0=0.0, tf=5.0, dt0=1e-2, rtol=1e-8, atol=1e-8,
                 saveat=list(np.linspace(0.0, 5.0, 6)))
# where a plain version takes minutes at 2^20 lanes it runs on the first
# DATA_PLAIN_N lanes, and the kernel is held to it on those lanes
DATA_PLAIN_N = 2 ** 18
# the stiff data row's plain version took 41 s on 2^18 lanes of an H100: it
# runs on the first 2^16, to make room for the gradient phases
DATA_STIFF_PLAIN_N = 2 ** 16
# the onehot plain version sums its contraction in cuBLAS: within 1e-12
ONEHOT_TOL = 1e-12


def osc_inputs(N: int, device, dtype, *, mode="gather", p=(4.0, 0.2),
               u0=(1.0, 0.0), scale=(0.5, 1.5), prob=None):
    """The forced oscillator's ensemble: u0 scaled by linspace(scale, N),
    one parameter pair; the bench table (`texture_oscillator_problem`)
    unless `prob` is given."""
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    prob = prob or dp.texture_oscillator_problem(mode, dtype=dtype)
    u0s = np.stack([u0] * N) * np.linspace(*scale, N)[:, None]
    return ensemble_problem(prob, u0s, np.tile(p, (N, 1)), device=device,
                            dtype=dtype)


def data_parity_cases(device, N: int):
    """(name, module, ensemble, front-door arguments, extra plain-version
    arguments, bar) of the f64 data parity phase."""
    import dataclasses
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    f64 = torch.float64
    cases = []
    # an explicit save grid: the front door's lanes path with adaptive off
    # is then the plain version (without one, its fixed-step engine
    # accumulates t otherwise)
    fixed = {k: v for k, v in TEXTURE_FIXED.items()
             if k not in ("n_steps", "save_every")}
    for mode in ("gather", "onehot", "cubic"):
        cases.append((f"osc {mode} tsit5 fixed", erk_kernel,
                      osc_inputs(N, device, f64, mode=mode),
                      dict(fixed, alg="tsit5", saveat=[0.5, 1.0]), {},
                      ONEHOT_TOL if mode == "onehot" else 0.0))
    big = dp.forced_oscillator_problem()
    osc = osc_inputs(N, device, f64, prob=big, p=(2.0, 0.1))
    for alg in ("tsit5", "dopri5"):
        cases.append((f"osc gather {alg} adaptive", erk_kernel, osc,
                      dict(OSC_ADAPTIVE, alg=alg), {}, 0.0))
    cases.append(("osc cubic tsit5 adaptive", erk_kernel,
                  osc_inputs(N, device, f64, prob=dataclasses.replace(
                      big, f=dp.forced_oscillator_cubic_rhs), p=(2.0, 0.1)),
                  dict(OSC_ADAPTIVE, alg="tsit5"), {}, 0.0))
    cases.append(("osc level event tsit5", erk_kernel,
                  osc_inputs(N, device, f64, prob=big, p=(1.0, 0.0),
                             u0=(0.0, 2.0), scale=(0.8, 1.2)),
                  dict(OSC_EVENT, alg="tsit5", event=dp.osc_level_event()),
                  {}, 0.0))
    stiff = osc_inputs(N, device, f64, prob=dataclasses.replace(
        big, tspan=(0.0, 3.0)), p=(50.0, 2.0))
    # rosenbrock23 and lazy-W rodas4 take 3,500 and 11,000 steps a lane on
    # [0, 3], minutes for the plain version: their parity runs on [0, 0.5]
    # (lazy-W rodas4, 38 s of plain version there, on [0, 0.25]), past the
    # first step from the table's first knot (the row
    # osc-1M-rosenbrock23-data runs [0, 1.5])
    short = dict(OSC_STIFF, tf=0.5, saveat=[0.0, 0.25, 0.5])
    shorter = dict(OSC_STIFF, tf=0.25, saveat=[0.0, 0.125, 0.25])
    for alg, wr, st in (("rosenbrock23", False, short),
                        ("rodas5p", False, OSC_STIFF_ROW),
                        ("rodas4", True, shorter)):
        cases.append((f"osc {alg} {'lazyW' if wr else 'eager'}", rb_kernel,
                      stiff, dict(st, alg=alg, w_reuse=wr),
                      dict(linsolve="lanes"), 0.0))
    rate = ensemble_problem(dp.gbm_rate_problem(), np.ones((N, 1)),
                            np.full((N, 1), 0.2), device=device)
    table = torch.tensor(np.random.default_rng(SEED).standard_normal(
        (500, 1, N)), dtype=f64, device=device)
    for alg in ("em", "milstein"):
        cases.append((f"gbm-rate {alg} fixed", sde_kernel, rate,
                      dict(RATE_FIXED, alg=alg), {}, 0.0))
    cases.append(("gbm-rate em fixed table", sde_kernel, rate,
                  dict(RATE_FIXED, alg="em", noise_table=table), {}, 0.0))
    for est in ("embedded", "doubling"):
        cases.append((f"gbm-rate em {est}", k5, rate,
                      dict(RATE_ADAPTIVE, alg="em", error_est=est), {}, 0.0))
    return cases


def phase_data_parity(device, N: int = PARITY_N):
    """parity-f64-data: every data form against its plain version on the
    same card, through the front door, in f64: bitwise (onehot's plain
    matmul within ONEHOT_TOL); the adaptive onehot form against the plain
    gather version, bitwise, since on the card the onehot lookup sums the
    contraction's two terms that are not zero, which is the gather lookup.
    Then K2: the fixed-dt data form in three launches of K1 (the tables
    passed to each) against one."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    from repro_torch.kernels.tsit5.ops import solve_ensemble_cuda
    out = {}
    for name, mod, ep, kw, extra, tol in data_parity_cases(device, N):
        before = mod.launches
        t = time.perf_counter()
        rk = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                  device=device, **kw)
        rt = solve_ensemble_local(ep, ensemble="kernel", backend="torch",
                                  device=device, **kw, **extra)
        sync(device)
        secs = time.perf_counter() - t
        if device.type == "cuda" and mod.launches != before + 1:
            raise AssertionError(f"data parity {name}: the kernel was not "
                                 "launched")
        counts, worst, bitwise = event_compare(rk, rt)
        if not counts or worst > tol or int(rk.status) != 0 \
                or not bool(torch.isfinite(rk.us).all()):
            raise AssertionError(
                f"data parity {name}: counts identical {counts}, worst "
                f"|kernel - plain| {worst:.3e} (bar {tol}), status "
                f"{int(rk.status)}")
        attempts = int((rk.naccept.long() + rk.nreject.long()).sum())
        note = ""
        if name == "osc level event tsit5":
            hit = float((rk.t_final < 5.0 - 1e-9).double().mean())
            d = float((rk.u_final[:, 0] - 1.5).abs().max())
            if hit < 1.0 or d > 1e-6:
                raise AssertionError(f"data parity {name}: {hit:.4f} of the "
                                     f"lanes hit, x off 1.5 by {d:.3e}")
            note = f"; every lane hit, x off 1.5 by {d:.3e} (bar 1e-6)"
        out[name] = dict(worst=worst, bitwise_lanes=bitwise)
        print(f"data parity {name}: N={N} f64 counts identical, worst "
              f"|kernel - plain| {worst:.3e} (bar {tol}), {bitwise} of {N} "
              f"lanes bitwise; attempts {attempts}{note}; {secs:.1f} s with "
              "the plain version")
    # the adaptive onehot form against the plain gather version
    import dataclasses
    from repro_torch.configs import de_problems as dp
    big = dp.forced_oscillator_problem()
    onehot = dataclasses.replace(big, f=dp.forced_oscillator_onehot_rhs)
    kw = dict(OSC_ADAPTIVE, alg="tsit5")
    rk = solve_ensemble_local(osc_inputs(N, device, torch.float64,
                                         prob=onehot, p=(2.0, 0.1)),
                              ensemble="kernel", backend="cuda",
                              device=device, **kw)
    rt = solve_ensemble_local(osc_inputs(N, device, torch.float64, prob=big,
                                         p=(2.0, 0.1)),
                              ensemble="kernel", backend="torch",
                              device=device, **kw)
    counts, worst, bitwise = event_compare(rk, rt)
    if not counts or worst != 0.0:
        raise AssertionError(f"data parity osc onehot tsit5 adaptive: "
                             f"counts identical {counts}, worst {worst:.3e} "
                             "against the plain gather version")
    out["osc onehot tsit5 adaptive"] = dict(worst=worst, bitwise_lanes=bitwise)
    print(f"data parity osc onehot tsit5 adaptive: N={N} f64 against the "
          f"plain gather version: counts identical, {bitwise} of {N} lanes "
          "bitwise")
    # K2 with data: three launches of K1's data form against one
    ep = osc_inputs(N, device, torch.float64)
    u0s, ps = ep.materialize()
    sv = torch.tensor([0.25, 0.5, 0.75, 1.0], dtype=torch.float64,
                      device=device)
    kw = dict(t0=0.0, tf=1.0, dt0=1.0 / 200, rtol=1e-8, atol=1e-8,
              adaptive=False, data=ep.prob.data)
    from repro_torch.core.tableaus import get_tableau
    before = erk_kernel.launches
    staged = solve_ensemble_cuda(ep.prob, u0s, ps, get_tableau("tsit5"),
                                 saveat=sv, save_chunks=3, **kw)
    launches = erk_kernel.launches - before
    one = solve_ensemble_cuda(ep.prob, u0s, ps, get_tableau("tsit5"),
                              saveat=sv, save_chunks=1, **kw)
    if device.type == "cuda" and launches != 3:
        raise AssertionError(f"K2 with data: {launches} launches, not 3")
    # each segment restarts its clock at its first save, where one launch
    # has summed the steps: F(t) sees t a rounding apart
    d = max(float((staged.us - one.us).abs().max()),
            float((staged.u_final - one.u_final).abs().max()))
    if d > K2_TOL:
        raise AssertionError(f"K2 with data: staged run {d:.3e} from one "
                             f"launch > {K2_TOL}")
    print(f"data parity K2 staged: N={N} f64 three launches of the fixed-dt "
          f"data form (the tables passed to each) within {d:.3e} of one "
          f"(bar {K2_TOL})")
    out["K2 staged"] = dict(launches=launches, max_abs=d)
    return out


def phase_interp_lookup(device, N: int = FULL_N, reps: int = 5):
    """interp-lookup: 2^20 queries for 1-D and 2-D tables in every mode, in
    f32 and f64, against core/interp.py on the same card; the queries hold
    points outside the grid, every knot and both bounds.  The only place
    the card runs interp2d.  Returns the row of the 1-D f32 gather lookup,
    with grid_sample (align_corners, border padding: the same clamped
    linear interpolation) as its library call."""
    import torch
    from repro_torch.core.interp import UniformTable1D, UniformTable2D
    from repro_torch.kernels import interp as kinterp
    rng = np.random.default_rng(SEED)
    K, KX, KY = 64, 33, 17
    v1 = rng.standard_normal(K)
    v2 = rng.standard_normal((KX, KY))
    x0, dx, y0, dy = -1.0, 0.125, 2.0, 0.25

    def queries(n, lo, step, k):
        edge = np.concatenate([lo + step * np.arange(k),
                               [lo, lo + step * (k - 1)]])
        return np.concatenate([edge, rng.uniform(lo - 2.0, lo + step * k
                                                 + 2.0, n - edge.size)])

    qx = queries(N, x0, dx, KX)
    qy = queries(N, y0, dy, KY)
    q1 = queries(N, x0, dx, K)
    row = None
    for dtype in (torch.float64, torch.float32):
        t1 = UniformTable1D(torch.tensor(v1, dtype=dtype, device=device),
                            x0, dx)
        t2 = UniformTable2D(torch.tensor(v2, dtype=dtype, device=device),
                            x0, dx, y0, dy)
        X1 = torch.tensor(q1, dtype=dtype, device=device)
        X = torch.tensor(qx, dtype=dtype, device=device)
        Y = torch.tensor(qy, dtype=dtype, device=device)
        for mode in ("gather", "onehot", "cubic"):
            tol = 0.0 if mode != "onehot" else (
                ONEHOT_TOL if dtype == torch.float64 else 1e-6)
            res = []
            for dims, tab, args in (("1d", t1, (X1,)), ("2d", t2, (X, Y))):
                before = kinterp.launches
                got = kinterp.interp_lookup(tab, *args, mode=mode)
                want = (kinterp.interp2d(tab, *args, mode) if dims == "2d"
                        else kinterp.interp1d(tab, *args, mode))
                sync(device)
                if device.type == "cuda" and kinterp.launches != before + 1:
                    raise AssertionError("interp-lookup: no launch")
                d = float((got.double() - want.double()).abs().max())
                nbit = int((got == want).sum())
                if d > tol or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"interp-lookup {dims} {mode} "
                                         f"{dtype}: |kernel - plain| {d:.3e}"
                                         f" > {tol}")
                res.append(f"{dims} {d:.3e} ({nbit} of {N} bitwise)")
            print(f"interp-lookup {str(dtype)[6:]} {mode}: N={N} queries, "
                  f"|kernel - plain| " + ", ".join(res) + f" (bar {tol})")
        if dtype == torch.float32:
            ms = cuda_ms(lambda: kinterp.interp_lookup(t1, X1), reps)
            plain_ms = cuda_ms(lambda: kinterp.interp1d(t1, X1), reps)
            img = t1.values.reshape(1, 1, 1, K)
            gx = (2.0 * (X1 - x0) / (dx * (K - 1)) - 1.0)
            grid = torch.stack([gx, torch.zeros_like(gx)], -1).reshape(
                1, 1, N, 2)
            lib = lambda: torch.nn.functional.grid_sample(
                img, grid, mode="bilinear", padding_mode="border",
                align_corners=True)
            d_lib = float((lib().reshape(-1) - kinterp.interp1d(t1, X1))
                          .abs().max())
            library_ms = cuda_ms(lib, reps)
            ops = N * LOOKUP_OPS["gather"]
            nbytes = 4 * (2 * N + K)
            times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "fp32": ops / PEAK_FP32_FLOPS * 1e3}
            pipe = max(times, key=times.get)
            kinterp.launches = 0
            kinterp.interp_lookup(t1, X1)
            row = {"name": "interp_lookup[1d,gather,f32]", "route": "cuda",
                   "source": "src/repro_torch/csrc/interp_lookup.cu",
                   "replaces": "src/repro/kernels/ensemble_kernel.py:240",
                   # the test entry; no path of the port launches it
                   "launches": 0, "max_abs_err": 0.0, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": times[pipe],
                   "bound_by": "bytes" if pipe == "bytes" else "operations",
                   "library_ms": library_ms, "library": "grid_sample",
                   "library_max_abs_err": d_lib}
            print(f"interp-lookup f32 gather 1d timing: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms "
                  f"(|grid_sample - plain| {d_lib:.3e}), bound "
                  f"{times[pipe]:.4f} ms by {pipe}")
    return row


def sv_of(kw, dtype, device):
    """The save grid a data row's wrapper call takes: its saveat, or the
    one save at the end of a fixed-dt run."""
    import torch
    if "n_steps" in kw:
        return torch.tensor([kw["t0"] + kw["n_steps"] * kw["dt0"]],
                            dtype=dtype, device=device)
    return torch.tensor(kw["saveat"], dtype=dtype, device=device)


def _data_kernel_fns(form, ep, kw, n_plain):
    """(kernel(), plain(), stats of the plain lanes) closures calling the
    wrapper and its plain version directly, lane-major; the plain version
    on the first `n_plain` lanes."""
    import torch
    from repro_torch.core.problem import bind_data
    from repro_torch.core.tableaus import (get_rosenbrock_tableau,
                                           get_tableau)
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    prob = ep.prob
    data = prob.data
    u0s, ps = ep.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    u0_p, p_p = u0_l[:, :n_plain].contiguous(), p_l[:, :n_plain].contiguous()
    dtype, dev = u0s.dtype, u0s.device
    alg = kw["alg"]
    if alg in ("tsit5", "dopri5"):
        tab = get_tableau(alg)
        sv = sv_of(kw, dtype, dev)
        kargs = dict(t0=kw["t0"], tf=kw["tf"], dt0=kw["dt0"],
                     rtol=kw.get("rtol", 1e-6), atol=kw.get("atol", 1e-6),
                     adaptive=kw.get("adaptive", True), max_iters=100_000,
                     event=kw.get("event"))
        return (lambda: erk_kernel.erk_ensemble(prob.f, tab, u0_l, p_l, sv,
                                                data=data, **kargs),
                lambda: erk_kernel._plain(bind_data(prob.f, data), tab, u0_p,
                                          p_p, sv, **kargs))
    if alg.startswith("ros") or alg.startswith("rodas"):
        rtab = get_rosenbrock_tableau(alg)
        sv = torch.tensor(kw["saveat"], dtype=dtype, device=dev)
        kargs = dict(jac=None, t0=kw["t0"], tf=kw["tf"], dt0=kw["dt0"],
                     rtol=kw["rtol"], atol=kw["atol"], max_iters=100_000,
                     w_reuse=kw.get("w_reuse"))
        return (lambda: rb_kernel.rosenbrock_ensemble(prob.f, rtab, u0_l,
                                                      p_l, sv, data=data,
                                                      **kargs),
                lambda: rb_kernel._plain(bind_data(prob.f, data), rtab, u0_p,
                                         p_p, sv, **kargs))
    if kw.get("adaptive"):
        args = adaptive_args(alg, kw.get("error_est"), prob.noise, 1,
                             t0=kw["t0"], tf=kw["tf"], dt0=kw["dt0"],
                             rtol=kw["rtol"], atol=kw["atol"],
                             seed=kw["seed"])
        sv = torch.tensor(kw["saveat"], dtype=dtype, device=dev)
        from repro_torch.kernels.em.ref import solve_adaptive_lanes
        return (lambda: k5.sde_adaptive_ensemble(prob.f, prob.g, alg, u0_l,
                                                 p_l, sv, data=data, **args),
                lambda: solve_adaptive_lanes(bind_data(prob.f, data),
                                             bind_data(prob.g, data), alg,
                                             u0_p, p_p, sv, **args))
    kargs = dict(t0=kw["t0"], dt=kw["dt0"], n_steps=kw["n_steps"],
                 save_every=kw["save_every"], seed=kw["seed"], lane_offset=0)
    return (lambda: sde_kernel.sde_ensemble(prob.f, prob.g, alg, u0_l, p_l,
                                            noise="diagonal", m_noise=1,
                                            data=data, **kargs),
            lambda: sde_kernel._plain(bind_data(prob.f, data),
                                      bind_data(prob.g, data), alg,
                                      "diagonal", 1, u0_p, p_p, table=None,
                                      **kargs))


def phase_data_full_size(device, N: int = FULL_N, reps: int = 3):
    """The data rows at the paper's 10^6 scale, inputs on the card: the
    bench configuration in three lookup modes (f32, fixed dt) beside the
    same solve on the vmap strategy; the forced oscillator adaptive (f64),
    on rosenbrock23 (f64) and with the level event (f64); the rate-table
    GBM fixed and adaptive (f32).  Each through the front door with the
    launch count read around it, the kernel against its plain version
    (on the first DATA_PLAIN_N lanes where that is slow), times and bound."""
    import dataclasses
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.tableaus import (get_rosenbrock_tableau,
                                           get_tableau)
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.queue import simt_efficiency
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    f32, f64 = torch.float32, torch.float64
    big = dp.forced_oscillator_problem()
    forms = []
    for mode in ("gather", "onehot", "cubic"):
        forms.append((f"osc-1M-f32-fixed-{mode}", erk_kernel,
                      osc_inputs(N, device, f32, mode=mode),
                      dict(TEXTURE_FIXED, alg="tsit5"), mode, N))
    forms += [
        ("osc-1M-f64-adaptive", erk_kernel,
         osc_inputs(N, device, f64, prob=big, p=(2.0, 0.1)),
         dict(OSC_ADAPTIVE, alg="tsit5"), "gather", DATA_PLAIN_N),
        ("osc-1M-rosenbrock23-data", rb_kernel,
         osc_inputs(N, device, f64, prob=dataclasses.replace(
             big, tspan=(0.0, 3.0)), p=(50.0, 2.0)),
         dict(OSC_STIFF_ROW, alg="rosenbrock23"), "gather",
         DATA_STIFF_PLAIN_N),
        ("gbm-rate-1M-em", sde_kernel,
         ensemble_problem(dp.gbm_rate_problem(dtype=f32), np.ones((N, 1)),
                          np.full((N, 1), 0.2), device=device, dtype=f32),
         dict(RATE_FIXED, alg="em"), "gather", N),
        ("gbm-rate-1M-em-adaptive", k5,
         ensemble_problem(dp.gbm_rate_problem(dtype=f32), np.ones((N, 1)),
                          np.full((N, 1), 0.2), device=device, dtype=f32),
         dict(RATE_ADAPTIVE, alg="em", error_est="embedded"), "gather",
         DATA_PLAIN_N),
        ("osc-1M-tsit5-data-event", erk_kernel,
         osc_inputs(N, device, f64, prob=big, p=(1.0, 0.0), u0=(0.0, 2.0),
                    scale=(0.8, 1.2)),
         dict(OSC_EVENT, alg="tsit5", event=dp.osc_level_event()), "gather",
         DATA_PLAIN_N)]
    rows = []
    for form, mod, ep, kw, mode, n_plain in forms:
        n_plain = min(n_plain, N)
        dtype = ep.u0s.dtype
        label = str(dtype)[6:].replace("float", "f")
        kwd = dict(kw, device=device)
        mod.launches = 0
        res = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                   **kwd)
        sync(device)
        launches = mod.launches
        if device.type == "cuda" and launches != 1:
            raise AssertionError(f"{form}: {launches} kernel launches, not 1")
        S = res.ts.shape[0]
        if tuple(res.us.shape) != (N, S, ep.u0s.shape[1]) \
                or int(res.status) != 0 \
                or not bool(torch.isfinite(res.us).all()):
            raise AssertionError(f"{form}: shape {tuple(res.us.shape)}, "
                                 f"status {int(res.status)} or non-finite")
        kernel, plain = _data_kernel_fns(form, ep, kw, n_plain)
        out_k = kernel()
        t = time.perf_counter()
        out_p = plain()
        sync(device)
        plain_ms = (time.perf_counter() - t) * 1e3
        kp = [x[..., :n_plain] for x in out_k]
        same = (kp[3][:2] == out_p[3][:2]).all(dim=0)
        share = float(same.double().mean())
        max_abs = max(float((kp[i].double() - out_p[i].double()).abs()
                            .max()) for i in (0, 1, 2))
        e_lane = ((lanes_first(kp).double() - lanes_first(out_p).double())
                  .abs() / (1.0 + lanes_first(out_p).double().abs())) \
            .reshape(n_plain, -1).max(dim=1).values
        bitwise = int(((kp[3] == out_p[3]).all(dim=0) & (e_lane == 0)).sum())
        if dtype == f64 or mode == "gather":
            tol = ONEHOT_TOL if mode == "onehot" else 0.0
        else:
            tol = 1e-6 if mode == "onehot" else 0.0
        if dtype == f64:
            ok = share == 1.0 and max_abs <= tol
            gate = (f"counts identical on every lane, |kernel - plain| "
                    f"{max_abs:.3e} (bar {tol})")
        else:
            # f32: bitwise is the aim; an accept decision of the adaptive
            # form may follow a last-ulp difference (the f32 gate of the
            # adaptive SDE rows)
            ok = (share >= ADAPTIVE_F32_SAME
                  and float(e_lane[same].max()) <= max(tol, ADAPTIVE_F32_TOL)
                  and float(e_lane.max()) <= ADAPTIVE_ANY_TOL)
            gate = (f"counts equal on {share:.5f} of the lanes, states rel "
                    f"{float(e_lane[same].max()):.3e} on them, "
                    f"{float(e_lane.max()):.3e} on all")
        if not ok:
            for lane in torch.topk(e_lane, 3).indices.tolist():
                print(f"{form}: lane {lane}: counts "
                      f"{kp[3][:2, lane].tolist()} (plain "
                      f"{out_p[3][:2, lane].tolist()}), rel "
                      f"{float(e_lane[lane]):.3e}")
            raise AssertionError(f"{form}: against the plain version: {gate}")
        gate += f"; {bitwise} of {n_plain} lanes bitwise"
        if n_plain < N:
            gate += f" (the plain version on the first {n_plain} lanes)"
        del out_p
        ms = cuda_ms(kernel, reps)
        front_ms = cuda_ms(lambda: solve_ensemble_local(
            ep, ensemble="kernel", backend="cuda", **kwd), reps)
        extra = {}
        if form == "osc-1M-f32-fixed-gather":
            # the texture benchmark's comparison, in its gather mode (the
            # onehot and cubic modes' vmap runs take 2.5 and 2.1 s)
            extra["vmap_ms"] = cuda_ms(lambda: solve_ensemble_local(
                ep, ensemble="vmap", backend="torch", **kwd), 1, warmup=0)
        # ---- bound: the run's own work, as the kernel writes it ----------
        st = out_k[3].long()
        attempts, accepted = int((st[0] + st[1]).sum()), int(st[0].sum())
        item = 4 if dtype == f32 else 8
        n = ep.u0s.shape[1]
        k = ep.ps.shape[1]
        K = int(ep.prob.data[next(iter(ep.prob.data))].values.numel())
        nbytes = (item * (n * N + k * N + S + K + S * n * N + n * N + N)
                  + 4 * 6 * N)
        peak = PEAK_FP64_FLOPS if dtype == f64 else PEAK_FP32_FLOPS
        pipe_name = "fp64" if dtype == f64 else "fp32"
        if mod is erk_kernel:
            tab = get_tableau(kw["alg"])
            ops = (attempts * attempt_flops(tab, n, OSC_RHS_OPS
                                            + LOOKUP_OPS[mode],
                                            kw.get("adaptive", True))
                   + N * S * save_flops(tab, n))
            hits = (int((out_k[2] < kw["tf"] - 1e-9).sum())
                    if "event" in kw else 0)
            if "event" in kw:
                ops += event_ops(steps=accepted, reanchors=0, hits=hits,
                                 interp=tsit5_interp_ops(n), cond=1,
                                 affect=0)
            times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     pipe_name: ops / peak * 1e3}
            work = f"{attempts} attempts"
            saves, stores = k1_saves(sv_of(kw, dtype, device), kw["t0"],
                                     out_k[2])
            extra.update(k1_row_extra(form, ms, out_k[3], k1_work(
                form, attempts=attempts, accepted=accepted, saves=saves,
                stores=stores, adaptive=kw.get("adaptive", True),
                hits=hits), dtype == f64, times["bytes"], hits=hits))
        elif mod is rb_kernel:
            rtab = get_rosenbrock_tableau(kw["alg"])
            per, jac, fact, save = rosenbrock_attempt_ops(
                rtab, n, OSC_RHS_OPS + LOOKUP_OPS[mode], 2)
            ops = (attempts * (per + jac + fact + LOOKUP_TANGENT_OPS)
                   + N * S * save)
            times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     pipe_name: ops / peak * 1e3}
            work = f"{attempts} attempts"
            # a lookup a stage: F0's (with the tangent) and s - 1 more
            sp_att, sp_fact, sp_save = rosenbrock_special_ops(
                rtab, n, lookups=rtab.stages)
            special = special_total([(attempts, sp_att), (attempts, sp_fact),
                                     (N * S, sp_save)])
            extra["bound_instr_ms"] = max(
                bound_instr_ms(ops, special, FP64_FAST), times["bytes"])
        else:
            if mod is sde_kernel:
                steps = kw["n_steps"] * N
                normals = steps
                ops = (steps * (GBM_RATE_STEP_OPS + LOOKUP_OPS["gather"])
                       + normals * NORMAL_FLOPS)
                work = f"{steps} steps, {normals} normals"
                extra.update(k4_row_extra(form, steps))
            else:
                depth = int(adaptive_args(
                    "em", "embedded", "diagonal", 1, t0=kw["t0"],
                    tf=kw["tf"], dt0=kw["dt0"], rtol=kw["rtol"],
                    atol=kw["atol"], seed=kw["seed"])["depth"])
                # depth normals a descent, W(T) once a trajectory
                normals = attempts * depth + N
                ops = (normals * BRIDGE_FLOPS_PER_NORMAL
                       + attempts * (GBM_RATE_ATTEMPT_OPS
                                     + LOOKUP_OPS["gather"]))
                work = f"{attempts} attempts, {normals} normals"
            alu_ops = normals * THREEFRY_ALU_OPS
            issued = normals * (THREEFRY_ALU_OPS + THREEFRY_ADD_OPS) + ops / 2
            times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     pipe_name: ops / peak * 1e3,
                     "int32_alu": alu_ops / (ALU_LANES_PER_SM
                                             * SM_LANE_CLOCKS_PER_S) * 1e3,
                     "issue": issued / (ISSUE_LANES_PER_SM
                                        * SM_LANE_CLOCKS_PER_S) * 1e3}
        # every operation of a data form is rounded on its own: its float
        # operations at half the peak, with the other limits
        unfused = max(max(times.values()), times[pipe_name] * 2)
        if form in K35_KEYS:
            extra["simt_efficiency"] = simt_efficiency(st[0] + st[1])
            extra["registers"] = row_registers(form)
        src, line = {erk_kernel: ("erk_ensemble.cu", ":461"),
                     rb_kernel: ("rosenbrock_ensemble.cu", ":491"),
                     sde_kernel: ("sde_ensemble.cu", ":533"),
                     k5: ("sde_adaptive_ensemble.cu", ":602")}[mod]
        kname = {erk_kernel: "erk_ensemble", rb_kernel: "rosenbrock_ensemble",
                 sde_kernel: "sde_ensemble",
                 k5: "sde_adaptive_ensemble"}[mod]
        row = _event_row(f"{kname}[{kw['alg']},{form.split('-1M-')[0]},"
                         f"{label},data-{mode}"
                         + (",level" if "event" in kw else "") + "]",
                         f"src/repro_torch/csrc/{src}",
                         f"src/repro/kernels/ensemble_kernel.py{line}",
                         launches, max_abs, ms, plain_ms, times,
                         bound_unfused_ms=unfused, front_door_ms=front_ms,
                         form=form, plain_lanes=n_plain, **extra)
        print(f"{form}: N={N} {label} status 0, launches {launches}; against "
              f"the plain version: {gate}"
              + (f"; vmap strategy {extra['vmap_ms']:.1f} ms"
                 if "vmap_ms" in extra else ""))
        _print_row(form, front_ms, row, work, times)
        if mod is sde_kernel:
            print(f"{form}: kernel / bound in instructions "
                  f"{ms / row['bound_instr_ms']:.2f}x")
        if form in K35_KEYS:
            b_instr = row.get("bound_instr_ms")
            print(f"{form}: "
                  + (f"bound in the card's instructions {b_instr:.4f} ms "
                     f"(kernel / it {ms / b_instr:.2f}x), " if b_instr
                     else "")
                  + f"SIMT efficiency {row['simt_efficiency']:.4f}, "
                  f"registers {row['registers']}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# gradients across the kernel boundary (`kernel_adjoint`, paper §6.6)
# ---------------------------------------------------------------------------

GRAD_N = 4096
# central differences of one lane's loss (of the whole loss for a table
# value), relative step GRAD_FD_EPS, against the adjoint within GRAD_FD_REL
GRAD_FD_EPS, GRAD_FD_REL = 1e-6, 1e-4
# The cuda route's gradient is the vjp of the replay at the cotangents of
# the kernel's outputs, the torch route's at those of the replay's own.  The
# two are bitwise equal where the kernel's outputs equal its plain
# version's bit for bit (every form that rounds each operation alone: K3,
# K5, the event and data forms); the no-event forms of K1 and K4 let nvcc
# contract into fused multiply-adds, so their outputs, and through the
# cotangents the gradients, differ by rounding: held within GRAD_TORCH_REL
# relative to the largest entry.  At the kernel's own cotangents the two
# routes run the same replay, so there every per-lane gradient is bitwise.
GRAD_TORCH_REL = 1e-10
# At full width the primal of K1's contracted form sits up to 3.3e-9 from
# its plain version's on 2^18 lanes of the f64 Lorenz row (every lane's
# counts equal: adaptive steps carry the rounding), and its gradient at the
# routes' own cotangents 1.7e-9 of the largest entry (an H100): a row whose
# primal is not bitwise is held there within its rtol, the solver's own
# accuracy; a fixed-dt row without one within GRAD_TORCH_REL.
# A table's gradient sums every lane's lookups with atomic adds, in no fixed
# order: on 2^20 lanes the two routes' f32 sums sat 9.0e-4 of the largest
# entry apart, and each as far from the f64 gradient (the f32 sum's own
# rounding, an H100); both held within GRAD_TABLE_REL, 11x that, where a
# gradient missing one of the replay's 15 segments would sit ~1/15 off.
GRAD_TABLE_REL = 1e-2
# full-size rows run at 2^20 lanes, a quarter of them at a time while the
# backward runs out of the card's memory (down to GRAD_MEM_N)
GRAD_MEM_N = 2 ** 16
# the torch route's whole gradient (the plain version of kernel_adjoint:
# the bounded loop forward and backward) is timed and compared on the first
# GRAD_PLAIN_N lanes, to keep the smoke's time down (its backward is the
# cuda route's); a table's gradient sums every lane, so that row's torch
# route runs on all of them
GRAD_PLAIN_N = 2 ** 18
# Under `torch.use_deterministic_algorithms` the table's sums take a fixed
# order and the two routes agree bit for bit; on 2^20 lanes that took
# minutes, so the smoke holds it on the first GRAD_DET_N lanes.
GRAD_DET_N = 2 ** 14
# the population fit of examples/parameter_estimation_torch.py: 4 guesses,
# every one within 0.2 of the true rho.  The example's 60 iterations are
# launch-bound at 4 lanes; a CPU run of the same fit ended within 0.078 of
# rho after 10 iterations (0.024 after 12), so the smoke runs 10.
FIT_ITERS, FIT_TOL = 10, 0.2


class _Steps(dict):
    """Seconds of each sub-step of a phase, summed by name."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def lap(self, name):
        now = time.perf_counter()
        self[name] = self.get(name, 0.0) + now - self._t
        self._t = now

    def __str__(self):
        return ", ".join(f"{k} {v:.1f} s" for k, v in self.items())


def lane_loss(res):
    """Each trajectory's share of sum(us^2) + sum(u_final^2), NaN lanes
    (the CRN sweep's, by design) masked to 0."""
    import torch
    per = (res.us ** 2).sum(dim=(1, 2)) + (res.u_final ** 2).sum(dim=1)
    return torch.where(torch.isfinite(per), per, torch.zeros_like(per))


def total_loss(res):
    """The gradient rows' default loss: every lane's `lane_loss` summed."""
    return lane_loss(res).sum()


def _with_table(prob, values):
    """`prob` with its one 1-D table's values replaced."""
    import dataclasses
    key = next(iter(prob.data))
    tab = prob.data[key]
    return dataclasses.replace(
        prob, data={key: type(tab)(values, tab.x0, tab.dx)})


def grad_run(ep, kw, wrt, *, backend="cuda", loss=None,
             deterministic=False, retain=False):
    """One gradient through the front door, timed: ``wrt`` holds "u0s",
    "ps" and/or "table".  Returns a namespace: the result, the gradients,
    the forward and backward ms, the backward's peak bytes and the inputs
    (``xs``).  ``retain=True`` keeps the graph for another backward.  A
    table's gradient sums every lane's lookups with atomic adds, in no
    fixed order; ``deterministic=True`` runs the gradient under
    `torch.use_deterministic_algorithms`."""
    import types
    import torch
    if deterministic:
        torch.use_deterministic_algorithms(True)
        try:
            return grad_run(ep, kw, wrt, backend=backend, loss=loss,
                            retain=retain)
        finally:
            torch.use_deterministic_algorithms(False)
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    loss = loss or total_loss
    u0s, ps = ep.materialize()
    u = u0s.detach().clone().requires_grad_("u0s" in wrt)
    p = ps.detach().clone().requires_grad_("ps" in wrt)
    prob, xs = ep.prob, {"u0s": u, "ps": p}
    if "table" in wrt:
        tab = prob.data[next(iter(prob.data))]
        xs["table"] = tab.values.detach().clone().requires_grad_(True)
        prob = _with_table(prob, xs["table"])
    dev = u.device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    sync(dev)
    ev[0].record()
    res = solve_ensemble_local(EnsembleProblem(prob, u.shape[0], u0s=u,
                                               ps=p), ensemble="kernel",
                               backend=backend, sensitivity="adjoint",
                               device=dev, **kw)
    ev[1].record()
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    L = loss(res)
    grads = dict(zip(wrt, torch.autograd.grad(L, [xs[k] for k in wrt],
                                              retain_graph=retain)))
    ev[2].record()
    sync(dev)
    return types.SimpleNamespace(
        res=res, grads=grads, fwd_ms=ev[0].elapsed_time(ev[1]),
        bwd_ms=ev[1].elapsed_time(ev[2]),
        peak=torch.cuda.max_memory_allocated(dev), xs=xs)


def loss_cotangents(res, loss=None):
    """The cotangents that ``loss`` (default `total_loss`) sends into a
    result's ``us`` and ``u_final`` at the result's own values (zeros where
    it reads none)."""
    import torch
    loss = loss or total_loss
    outs = [res.us.detach().requires_grad_(True),
            res.u_final.detach().requires_grad_(True)]
    cot = torch.autograd.grad(loss(res._replace(us=outs[0],
                                                u_final=outs[1])),
                              outs, allow_unused=True)
    return [torch.zeros_like(o) if c is None else c
            for o, c in zip(outs, cot)]


def grad_diff(name, ga, gb):
    """Two routes' gradients over ``gb``'s keys: (max |a - b| over the
    largest |b|, max |a - b|); 0.0 means bitwise.  NaN lanes (the CRN
    sweep's, by design) must sit in the same places."""
    import torch
    rel = worst = 0.0
    for k in gb:
        a, b = ga[k], gb[k]
        if not bool(torch.equal(torch.isnan(a), torch.isnan(b))):
            raise AssertionError(f"{name}: NaN placement of d/d{k}")
        fb = torch.nan_to_num(b)
        d = (torch.nan_to_num(a) - fb).abs().max()
        worst = max(worst, float(d))
        rel = max(rel, float(d / fb.abs().max().clamp_min(1e-300)))
    return rel, worst


def _nan_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _fd_entries(grads, fin):
    """Four (leaf, lane, column) entries for central differences: the
    largest gradient entries of ps (u0s for the SDE rows without ps
    gradients) on finite lanes, and two table values."""
    import torch
    leaf = "ps" if "ps" in grads else "u0s"
    g = torch.where(fin[:, None], grads[leaf].abs(), torch.zeros_like(
        grads[leaf]))
    top = torch.topk(g.flatten(), 4 if "table" not in grads else 2).indices
    out = [(leaf, int(i) // g.shape[1], int(i) % g.shape[1]) for i in top]
    if "table" in grads:
        tops = torch.topk(grads["table"].abs(), 2).indices
        out += [("table", None, int(k)) for k in tops]
    return out


def grad_fd(ep, kw, entry, sde: bool, eps: float = GRAD_FD_EPS) -> float:
    """Central difference of one lane's loss (the whole loss for a table
    value) with respect to one input, through the kernel without
    sensitivity, at the relative step ``eps``."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    leaf, i, j = entry
    u0s, ps = ep.materialize()
    prob = ep.prob
    if leaf == "table":
        vals = prob.data[next(iter(prob.data))].values
        base = float(vals[j])
    else:
        x = u0s if leaf == "u0s" else ps
        base = float(x[i, j])
        u0s, ps = u0s[i:i + 1], ps[i:i + 1]
    h = eps * max(1.0, abs(base))
    out = []
    for sgn in (1.0, -1.0):
        uu, pp, pr = u0s.clone(), ps.clone(), prob
        if leaf == "table":
            v = vals.clone()
            v[j] += sgn * h
            pr = _with_table(prob, v)
        elif leaf == "u0s":
            uu[0, j] += sgn * h
        else:
            pp[0, j] += sgn * h
        extra = dict(lane_offset=i) if (sde and leaf != "table") else {}
        res = solve_ensemble_local(EnsembleProblem(pr, uu.shape[0], u0s=uu,
                                                   ps=pp),
                                   ensemble="kernel", backend="cuda",
                                   device=uu.device, **dict(kw, **extra))
        out.append(float(lane_loss(res).sum()))
    return (out[0] - out[1]) / (2 * h)


def grad_parity_cases(device, N: int):
    """(name, kernel module, ensemble, front-door arguments, wrt) of the
    f64 gradient parity phase."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    f64 = torch.float64
    lor = lorenz_inputs(N, f64, device)
    lkw = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-8, atol=1e-8,
               saveat=[0.25, 0.5, 0.75, 1.0])
    rober = rober_inputs(N, device)
    # the stiff kernel inlines the lanes LU: the replay takes the same
    rkw = dict(t0=0.0, tf=10.0, dt0=1e-6, rtol=1e-6, atol=1e-8,
               saveat=[1.0, 10.0], linsolve="lanes")
    # Van der Pol on [0, 0.5]: each route replays the plain version
    # backward, a host loop of its bounded steps (24 s on [0, 1] on an
    # H100's host)
    vdp = ensemble_problem(dp.vdp_problem(), np.tile([2.0, 0.0], (N, 1)),
                           np.linspace(5.0, 20.0, N)[:, None], device=device)
    gbm = sde_inputs("gbm", N, f64, device)
    crn = sde_inputs("crn", N, f64, device)
    fixed = dict(t0=0.0, dt0=1.0 / 200, n_steps=200, save_every=50,
                 seed=SDE_SEED)
    adapt = dict(ADAPTIVE_SETTINGS["gbm"], adaptive=True, seed=SDE_SEED)
    adapt["saveat"] = list(adapt["saveat"])
    es = np.linspace(0.3, 0.9, N)
    ball = ensemble_problem(dp.bouncing_ball_problem(),
                            np.stack([np.full(N, 10.0), np.zeros(N)], 1),
                            np.stack([np.full(N, 9.8), es], 1),
                            device=device)
    both = ("u0s", "ps")
    return [
        ("tsit5 lorenz", erk_kernel, lor, dict(lkw, alg="tsit5"), both),
        ("dopri5 lorenz", erk_kernel, lor, dict(lkw, alg="dopri5"), both),
        ("rodas5p rober eager", rb_kernel, rober, dict(rkw, alg="rodas5p"),
         both),
        ("rodas5p rober lazyW", rb_kernel, rober,
         dict(rkw, alg="rodas5p", w_reuse=True), both),
        ("rosenbrock23 vdp", rb_kernel, vdp,
         dict(t0=0.0, tf=0.5, dt0=1e-3, rtol=1e-6, atol=1e-8,
              saveat=[0.25, 0.5], linsolve="lanes", alg="rosenbrock23"),
         both),
        ("em gbm fixed", sde_kernel, gbm, dict(fixed, alg="em"), both),
        ("platen_w2 gbm fixed", sde_kernel, gbm,
         dict(fixed, alg="platen_w2"), both),
        ("em crn fixed", sde_kernel, crn,
         dict(t0=0.0, dt0=0.1, n_steps=100, save_every=50, seed=SDE_SEED,
              alg="em"), both),
        ("em gbm adaptive embedded", k5, gbm,
         dict(adapt, alg="em", error_est="embedded"), both),
        ("em gbm adaptive doubling", k5, gbm,
         dict(adapt, alg="em", error_est="doubling"), both),
        ("tsit5 osc gather table", erk_kernel,
         osc_inputs(N, device, f64, mode="gather"),
         dict(TEXTURE_FIXED, alg="tsit5", saveat=[1.0]),
         ("u0s", "ps", "table")),
        ("tsit5 ball event", erk_kernel, ball,
         dict(t0=0.0, tf=2.0, dt0=1e-3, rtol=1e-9, atol=1e-9,
              saveat=[0.5, 1.0, 1.5, 2.0], event=dp.bouncing_ball_event(),
              alg="tsit5"), both),
    ]


def phase_grad_parity(device, N: int = GRAD_N):
    """f64, N lanes: every family's gradient through `kernel_adjoint` on
    backend="cuda".  Per case: the primal bitwise equal to the same call
    without sensitivity; the gradients against the torch route's (bitwise,
    or within GRAD_TORCH_REL where the kernel form contracts); central
    differences on four entries within GRAD_FD_REL; status 0."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.sensitivity import suggest_adjoint_steps
    t_phase = time.perf_counter()
    worst = {"torch_rel": 0.0, "fd_rel": 0.0}
    total = _Steps()
    for name, mod, ep, kw, wrt in grad_parity_cases(device, N):
        steps = _Steps()
        kw = dict(kw)
        sde = mod.__name__.endswith(("em.kernel", "em.adaptive"))
        fixed_dt = "n_steps" in kw or kw.get("adaptive") is False
        if not fixed_dt:
            kw["adjoint_steps"] = suggest_adjoint_steps(
                ep, ensemble="kernel", backend="cuda", device=device, **kw)
        plain = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                     device=device, **{
                                         k: v for k, v in kw.items()
                                         if k != "adjoint_steps"})
        steps.lap("bound and primal")
        mod.launches = 0
        cu = grad_run(ep, kw, wrt)
        res, g_cuda = cu.res, cu.grads
        if device.type == "cuda" and mod.launches < 1:
            raise AssertionError(f"grad {name}: no kernel launch")
        if int(res.status) != 0:
            raise AssertionError(f"grad {name}: status {int(res.status)}")
        for field in ("us", "u_final", "t_final", "naccept", "nreject"):
            if not _nan_equal(getattr(res, field).detach().double(),
                              getattr(plain, field).double()):
                raise AssertionError(f"grad {name}: primal {field} differs "
                                     "from the solve without sensitivity")
        steps.lap("cuda route")
        rel, _ = grad_diff(f"grad {name}", g_cuda,
                           grad_run(ep, kw, wrt, backend="torch").grads)
        if rel > GRAD_TORCH_REL:
            raise AssertionError(f"grad {name}: cuda vs torch route "
                                 f"{rel:.3e} > {GRAD_TORCH_REL}")
        steps.lap("torch route")
        fin = torch.isfinite(res.u_final.detach()).all(dim=1)
        fd_rel = 0.0
        for entry in _fd_entries(g_cuda, fin):
            leaf, i, j = entry
            g = float(g_cuda[leaf][j] if leaf == "table"
                      else g_cuda[leaf][i, j])
            fd = grad_fd(ep, {k: v for k, v in kw.items()
                              if k != "adjoint_steps"}, entry, sde)
            r = abs(g - fd) / max(abs(fd), 1e-300)
            fd_rel = max(fd_rel, r)
            if r > GRAD_FD_REL:
                raise AssertionError(f"grad {name}: d/d{leaf}[{i},{j}] "
                                     f"{g:.10e} vs FD {fd:.10e} ({r:.2e})")
        steps.lap("FD")
        worst["torch_rel"] = max(worst["torch_rel"], rel)
        worst["fd_rel"] = max(worst["fd_rel"], fd_rel)
        for k, v in steps.items():
            total[k] = total.get(k, 0.0) + v
        print(f"grad parity {name}: status 0, primal bitwise, cuda vs torch "
              f"route {'bitwise' if rel == 0.0 else f'max rel {rel:.3e}'}, FD "
              f"max rel {fd_rel:.2e}, bound "
              f"{kw.get('adjoint_steps', 'n_steps + 1')} ({steps})")
    print(f"grad parity: {N} lanes f64, worst cuda vs torch {worst['torch_rel']:.3e}, "
          f"worst FD {worst['fd_rel']:.2e} "
          f"({time.perf_counter() - t_phase:.1f} s: {total})")
    return worst


def _replay_meter():
    """Count the replay's checkpointed segments and the bytes of their
    input carries (`core.loops._remat` wrapped for the duration)."""
    import torch
    from repro_torch.core import loops
    real, meter = loops._remat, {"segments": 0, "carry_bytes": 0}

    def walk(x):
        if torch.is_tensor(x):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return 0

    def counting(fn, *args):
        meter["segments"] += 1
        meter["carry_bytes"] += walk(args)
        return real(fn, *args)

    def install():
        loops._remat = counting

    def remove():
        loops._remat = real

    return meter, install, remove


def _subset(ep, n):
    """The first n trajectories of an ensemble."""
    from repro_torch.core.problem import EnsembleProblem
    u0s, ps = ep.materialize()
    return EnsembleProblem(ep.prob, n, u0s=u0s[:n].contiguous(),
                           ps=ps[:n].contiguous())


def grad_full_forms(device, N: int):
    """(row, kernel module, ensemble, front-door arguments, wrt, loss,
    float operations of one replay attempt or step, peak rate) at N
    lanes: the five cells of the kernel rows, their settings kept."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.core.tableaus import get_rosenbrock_tableau, get_tableau
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.em import kernel as sde_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    f32, f64 = torch.float32, torch.float64
    fp64, fp32 = PEAK_FP64_UNFUSED_OPS, PEAK_FP32_FLOPS / 2
    host = __import__("repro_torch.configs.de_problems",
                      fromlist=["x"]).lorenz_ensemble(N, dtype=f64)
    lor = EnsembleProblem(host.prob, N, **dict(zip(
        ("u0s", "ps"), (x.to(device).contiguous()
                        for x in host.materialize()))))
    gbm = EnsembleProblem(
        dp.gbm_problem(r=1.5, v=0.2, dtype=f32), N,
        u0s=torch.full((N, 3), 0.1, dtype=f32, device=device),
        ps=torch.tensor([1.5, 0.2], dtype=f32,
                        device=device).expand(N, 2).contiguous())
    cfg = dict(ADAPTIVE_FULL)
    depth = cfg.pop("depth")
    cfg["saveat"] = list(cfg["saveat"])
    tsit5 = get_tableau("tsit5")
    rb_ops, rb_jac, rb_fact, _ = rosenbrock_attempt_ops(
        get_rosenbrock_tableau("rodas5p"), 3, *STIFF_RHS_OPS["rober"])
    uf_sum = lambda res: res.u_final.sum()
    # ops per replay attempt: an adaptive erk/rosenbrock attempt runs its
    # cascade twice (the adjoint-safe second pass); SDE attempts once
    return [
        ("grad-lorenz-1M-f64-tsit5", erk_kernel, lor,
         dict(alg="tsit5", t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-8, atol=1e-8,
              saveat=list(np.linspace(0.0, 1.0, 5))), ("u0s", "ps"), None,
         2 * attempt_flops(tsit5, 3, 9, True), fp64),
        ("grad-gbm-1M-em", sde_kernel, gbm,
         dict(alg="em", t0=0.0, dt0=1.0 / 200, n_steps=200, save_every=200,
              seed=SDE_SEED), ("u0s",), uf_sum,
         SDE_STEP_FLOPS[("gbm", "em")] + 3 * NORMAL_FLOPS, fp32),
        # the replay takes the kernel's own LU (lanes), not the library's
        ("grad-rober-1M-rodas5p", rb_kernel, rober_inputs(N, device),
         dict(ROBER_SETTINGS, alg="rodas5p", saveat=list(ROBER_SAVEAT),
              linsolve="lanes"),
         ("u0s", "ps"), None, 2 * (rb_ops + rb_jac + rb_fact), fp64),
        ("grad-gbm-1M-em-adaptive", k5, gbm,
         dict(cfg, alg="em", adaptive=True, error_est="embedded",
              brownian_depth=depth), ("u0s",), uf_sum,
         ADAPTIVE_ATTEMPT_FLOPS["embedded"]
         + 3 * depth * BRIDGE_FLOPS_PER_NORMAL, fp32),
        ("grad-osc-1M-f32-fixed-gather", erk_kernel,
         osc_inputs(N, device, f32, mode="gather"),
         dict(TEXTURE_FIXED, alg="tsit5", saveat=[1.0]), ("table",), None,
         attempt_flops(tsit5, 2, OSC_RHS_OPS + LOOKUP_OPS["gather"], False),
         fp32),
    ]


# ROBER's d/dk1 on 8 lanes against central differences.  The adaptive
# solver's output jumps by O(rtol) where a perturbation moves its step
# sequence, so differences taken at the row's rtol 1e-6 are noisy (up to
# 2.4e-4 from the adjoint, a CPU run on 64 lanes); taken at rtol 1e-9,
# atol 1e-11 with a relative step of 1e-5 they are the derivative within
# 5e-6 (the adjoint at those settings on the same lanes), and the row's own
# adjoint, which differentiates its realized steps, sat 6.3e-6 from them
# on 2^20 lanes of an H100.
ROBER_FD = dict(rtol=1e-9, atol=1e-11, eps=1e-5)


def rober_fd_check(ep, kw, g_row):
    """The worst relative difference of the row's d/dk1 from central
    differences at ROBER_FD's tolerances, on 8 lanes spread over the
    ensemble."""
    n = ep.materialize()[0].shape[0]
    fkw = {a: b for a, b in kw.items() if a != "adjoint_steps"}
    fkw.update(rtol=ROBER_FD["rtol"], atol=ROBER_FD["atol"])
    worst = 0.0
    for i in np.linspace(0, n - 1, 8).astype(int).tolist():
        fd = grad_fd(ep, fkw, ("ps", i, 0), False, eps=ROBER_FD["eps"])
        worst = max(worst, abs(float(g_row[i, 0]) - fd) / abs(fd))
    if worst > GRAD_FD_REL:
        raise AssertionError(f"ROBER d/dk1 against FD {worst:.2e}")
    return worst


def phase_grad_full_size(device, N: int = FULL_N):
    """The five gradient rows at full width, through `kernel_adjoint` on
    backend="cuda", each beside the torch route's gradient (the plain
    version: the bounded loop forward and backward) on shared lanes.  Per
    row: the cuda route's gradient bitwise equal to the torch route's at
    the kernel's own cotangents (a table's sums within GRAD_TABLE_REL, and
    of the f64 gradient); at the torch route's own cotangents bitwise where
    the primals are, else within the row's rtol; the row's own check; the kernel forward ms,
    the backward ms, the replay's bounded iterations, the backward's peak
    memory, and the bound."""
    import torch
    from repro_torch.core.sensitivity import suggest_adjoint_steps
    rows = []
    names = [form[0] for form in grad_full_forms(device, GRAD_MEM_N)]
    for k in range(len(names)):
        t_row = time.perf_counter()
        steps = _Steps()
        # ---- the main path at n_row lanes --------------------------------
        n_row = N
        while True:
            name, mod, ep, kw, wrt, loss, attempt_ops, peak_rate = \
                grad_full_forms(device, n_row)[k]
            kw = dict(kw)
            if not ("n_steps" in kw or kw.get("adaptive") is False):
                kw["adjoint_steps"] = suggest_adjoint_steps(
                    ep, ensemble="kernel", backend="cuda", device=device,
                    **kw)
            meter, install, remove = _replay_meter()
            mod.launches = 0
            install()
            try:
                run = grad_run(ep, kw, wrt, loss=loss)
                break
            except torch.cuda.OutOfMemoryError:
                if n_row <= GRAD_MEM_N:
                    raise
                n_row //= 4
            finally:
                remove()
            del ep
            torch.cuda.empty_cache()
        res, g = run.res, run.grads
        launches = mod.launches
        if (device.type == "cuda" and launches < 1) or int(res.status) != 0:
            raise AssertionError(f"{name}: launches {launches}, status "
                                 f"{int(res.status)}")
        for key, v in g.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{name}: non-finite d/d{key}")
        steps.lap("timed")
        # ---- against the torch route on the shared lanes -----------------
        table = "table" in wrt
        n_plain = n_row if table else min(n_row, GRAD_PLAIN_N)
        tr = grad_run(_subset(ep, n_plain), kw, wrt, loss=loss,
                      backend="torch", retain=True)
        plain_ms = tr.fwd_ms + tr.bwd_ms
        steps.lap("torch route")
        g_sh = {key: v if key == "table" else v[:n_plain]
                for key, v in g.items()}
        rel, max_abs = grad_diff(name, g_sh, tr.grads)
        primal_same = all(_nan_equal(getattr(res, f)[:n_plain].detach(),
                                     getattr(tr.res, f).detach())
                          for f in ("us", "u_final"))
        primal_rel = max(rel_err(getattr(res, f)[:n_plain].detach(),
                                 getattr(tr.res, f).detach())
                         for f in ("us", "u_final"))
        moved = int(((res.naccept[:n_plain] != tr.res.naccept)
                     | (res.nreject[:n_plain] != tr.res.nreject)).sum())
        # the vjp of the plain version at the kernel's own cotangents is
        # what kernel_adjoint computes: where the primals are bitwise, those
        # are the torch route's own cotangents
        if primal_same:
            rel_at = rel
        else:
            cot = [c[:n_plain] for c in loss_cotangents(res, loss)]
            g_at = dict(zip(wrt, torch.autograd.grad(
                [tr.res.us, tr.res.u_final], [tr.xs[key] for key in wrt],
                grad_outputs=cot)))
            rel_at, _ = grad_diff(name, g_sh, g_at)
            del g_at
        limit_at = GRAD_TABLE_REL if table else 0.0
        limit = limit_at if primal_same else kw.get("rtol", GRAD_TORCH_REL)
        if rel_at > limit_at or rel > limit:
            raise AssertionError(
                f"{name}: against the plain version {rel_at:.3e} at the "
                f"kernel's cotangents (limit {limit_at}), {rel:.3e} at its "
                f"own (limit {limit})")
        peak_t = tr.peak
        del tr
        steps.lap("compare")
        u0s, ps = ep.materialize()
        check, extra = "", {}
        if name.startswith("grad-gbm"):
            # GBM is linear: every path's dS_T/ds0 = S_T/s0 (f32: the
            # replay's product of 200 factors against the kernel's, each
            # rounded at 2^-24 twice a step, 2.4e-5; bar 1e-4)
            exact = res.u_final.detach() / u0s
            r = float(((g["u0s"] - exact).abs() / exact.abs()).max())
            if r > 1e-4:
                raise AssertionError(f"{name}: pathwise delta {r:.3e}")
            check = f"pathwise dS_T/ds0 = S_T/s0 on every lane, max rel {r:.3e}"
            if "n_steps" in kw:
                d = g["u0s"].double().flatten()
                want = (1.0 + 1.5 / 200) ** 200
                se = float(d.std() / np.sqrt(d.numel()))
                if abs(float(d.mean()) - want) > 4 * se:
                    raise AssertionError(f"{name}: mean delta "
                                         f"{float(d.mean())} vs {want}")
                check += (f"; mean delta {float(d.mean()):.5f} vs "
                          f"(1 + r dt)^n = {want:.5f} (SE {se:.2e})")
        elif name.startswith("grad-rober"):
            worst = rober_fd_check(ep, kw, g["ps"])
            check = (f"d/dk1 against FD (taken at rtol 1e-9) on 8 lanes, "
                     f"max rel {worst:.2e}")
        elif table:
            # the f64 gradient of the same row: how far the f32 sums sit
            # from a higher precision, beside the routes' atomic-order spread
            g64 = grad_run(osc_inputs(n_row, device, torch.float64,
                                      mode="gather"), kw, wrt,
                           loss=loss).grads["table"]
            f64_rel = float((g["table"].double() - g64).abs().max()
                            / g64.abs().max())
            if f64_rel > GRAD_TABLE_REL:
                raise AssertionError(f"{name}: {f64_rel:.3e} from the f64 "
                                     "table gradient")
            steps.lap("f64 control")
            # with a fixed order the two routes agree bit for bit
            ep_d = _subset(ep, GRAD_DET_N)
            g_d = grad_run(ep_d, kw, wrt, loss=loss,
                           deterministic=True).grads["table"]
            g_dt = grad_run(ep_d, kw, wrt, loss=loss, backend="torch",
                            deterministic=True).grads["table"]
            if not bool(torch.equal(g_d, g_dt)):
                raise AssertionError(f"{name}: table gradient not bitwise "
                                     "to the torch route under "
                                     "deterministic algorithms")
            extra = {"det_n": GRAD_DET_N,
                     "det_max_abs_err": float((g_d - g_dt).abs().max()),
                     "f64_control_rel": f64_rel}
            check = (f"d/d(64 table values) within {GRAD_TABLE_REL:g} of the "
                     f"largest entry ({rel:.3e}; the f32 gradient sits "
                     f"{f64_rel:.3e} from the f64 one), bitwise to "
                     "backend='torch' under deterministic algorithms on "
                     f"{GRAD_DET_N} lanes")
        else:
            check = "the row's own check is the torch route's above"
        steps.lap("row check")
        # ---- bound -------------------------------------------------------
        attempts = int((res.naccept.long() + res.nreject.long()).sum())
        ops = 3 * attempts * attempt_ops
        out_bytes = sum(v.numel() * v.element_size() for v in g.values())
        in_bytes = sum(x.numel() * x.element_size() for x in (u0s, ps))
        res_bytes = sum(x.numel() * x.element_size()
                        for x in (res.us, res.u_final))
        nbytes = 2 * meter["carry_bytes"] + in_bytes + res_bytes + out_bytes
        t_ops = ops / peak_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        iters = kw.get("adjoint_steps", kw.get("n_steps", 0) + 1)
        fwd_ms, bwd_ms, peak = run.fwd_ms, run.bwd_ms, run.peak
        row = {"name": f"kernel_adjoint[{name}]", "route": "cuda",
               "source": "src/repro_torch/kernels/ensemble_kernel.py",
               "replaces": "src/repro/kernels/ensemble_kernel.py:294",
               "launches": launches, "max_abs_err": max_abs,
               "ms": fwd_ms + bwd_ms, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
               "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None, "n": n_row, "plain_n": n_plain,
               "rel_err": rel, "lanes_counts_differ": moved, "primal_bitwise": primal_same,
               "primal_rel_err": primal_rel,
               "rel_err_at_kernel_cotangents": rel_at,
               "bound_steps": iters,
               "segments": meter["segments"],
               "peak_bytes": peak, "plain_peak_bytes": peak_t,
               "step_s": dict(steps), **extra}
        print(f"{name}: N={n_row} launches {launches}, forward {fwd_ms:.3f} "
              f"ms, backward {bwd_ms:.3f} ms (torch route {plain_ms:.3f} "
              f"ms on {n_plain} lanes), bound {iters} iterations in "
              f"{meter['segments']} "
              f"segments, backward peak {peak / 1e9:.3f} GB (torch route "
              f"{peak_t / 1e9:.3f} GB); bound {max(t_ops, t_bytes):.3f} "
              f"ms ({ops:.3e} ops, "
              f"{nbytes:.3e} bytes); cuda vs torch route on {n_plain} lanes: "
              f"at the kernel's cotangents "
              + ("bitwise" if rel_at == 0.0 else f"max rel {rel_at:.3e}")
              + f", at the route's own max abs {max_abs:.3e}, max rel "
              f"{rel:.3e} ({moved} lanes' counts differ; primal "
              + ("bitwise" if primal_same else f"max rel {primal_rel:.3e}")
              + f"); {check} ({time.perf_counter() - t_row:.1f} s: {steps})")
        rows.append(row)
        del ep, res, g, run
        torch.cuda.empty_cache()
    return rows


def phase_population_fit(device):
    """examples/parameter_estimation_torch.py's population fit on
    backend="cuda": four guesses, FIT_ITERS iterations, every one within
    FIT_TOL of the true rho."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "parameter_estimation_torch",
        ROOT / "examples" / "parameter_estimation_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    data = mod.make_data(device, "cuda")
    guesses = torch.tensor([8.0, 14.0, 22.0, 28.0], dtype=torch.float64)
    rhos, loss = mod.fit(guesses, data, iters=FIT_ITERS, device=device,
                         backend="cuda")
    err = float((rhos - mod.TRUE_RHO).abs().max())
    print(f"population fit: guesses {guesses.tolist()} -> "
          f"{[round(r, 4) for r in rhos.tolist()]} in {FIT_ITERS} "
          f"iterations, loss {loss:.3e} ({time.perf_counter() - t0:.1f} s)")
    if err > FIT_TOL:
        raise AssertionError(f"population fit: {err:.3f} from the true rho")
    return err


# ---------------------------------------------------------------------------
# flash attention (K7) and the dense-LM serving path it was written for
# ---------------------------------------------------------------------------

# Published H100 SXM dense BF16 tensor-core peak (NVIDIA data sheet): the
# bound of any attention kernel on bf16 inputs; PEAK_FP32_FLOPS is the
# ceiling of K7's CUDA-core form.
PEAK_BF16_TENSOR_FLOPS = 989e12
# K7's CUDA-core form against its plain version and the dense oracle:
# float32 and float64 inputs (both computed in float32) within 2e-5 of
# 1 + |value|, the reference's own bar against the oracle
# (tests/test_flashattn.py); bfloat16 inputs within 2 bfloat16 ulps
# (`flashattn.ref.bf16_ulps`: both round a float32 result once, which may
# straddle a rounding boundary, and the second ulp covers their float32
# difference where the ulp is measured at 2^-8 of the largest |value|).
FLASH_TOL = 2e-5
FLASH_BF16_ULPS = 2.0
# K7's tensor-core form (bf16 at hd 64 and 128) rounds P to bf16 before
# P V: that moves o by at most u sum_j p_j |v_j| / l <= u max|v| (u = 2^-8,
# bf16's unit roundoff), and each of the two output roundings (kernel and
# plain version) by u |o| <= u max|v|.  So it is held to the plain version
# and the oracle within 3 u max|v| elementwise and u by relative norm (two
# independent roundings of rms u / sqrt(3) give ~3.2e-3).
SM90_ELEM = 3 * 2.0 ** -8
SM90_REL = 2.0 ** -8
# (name, B, T, H, KV, hd, causal, block_q, block_k): the reference test's
# cases (each also in float64, its f64 case), T = 1000 ragged against every
# block, hd 64, 128 and 256, and g = H / KV = 1, 2, 8
FLASH_CASES = (
    ("causal-64-16-16", 2, 64, 4, 2, 32, True, 16, 16),
    ("causal-64-32-16", 2, 64, 4, 2, 32, True, 32, 16),
    ("causal-48-16-16", 2, 48, 4, 2, 32, True, 16, 16),
    ("causal-128-64-32", 2, 128, 4, 2, 32, True, 64, 32),
    ("gqa-4-4", 1, 32, 4, 4, 16, True, 16, 16),
    ("gqa-4-1", 1, 32, 4, 1, 16, True, 16, 16),
    ("gqa-8-2", 1, 32, 8, 2, 16, True, 16, 16),
    ("noncausal", 1, 32, 2, 2, 16, False, 16, 16),
    ("ragged-T-40", 1, 40, 2, 2, 16, True, 16, 16),
    ("ragged-1000-hd64-g1", 1, 1000, 4, 4, 64, True, 128, 128),
    ("ragged-1000-hd128-g2", 2, 1000, 16, 8, 128, True, 128, 128),
    ("ragged-1000-hd256-g8", 1, 1000, 8, 1, 256, True, 128, 128),
)
LM_ARCH = "internlm2-1.8b"
LM_SEED = 0
# row: (batch, prompt tokens, cache_len, greedy decode steps, q_chunk).
# serve: four 4096-token requests; prefill_32k: the reference's SHAPES
# cell (32,768 tokens) cut from a global batch of 32 to 1 on one card,
# q_chunk 512 as the reference's serve factory sets for cache_len >= 8192.
LM_ROWS = {
    "lm-internlm2-1.8b-serve": (4, 4096, 4160, 64, 0),
    "lm-internlm2-1.8b-prefill_32k": (1, 32768, 32784, 16, 512),
}
LM_K7_LAYERS = (0, 23)     # the layers whose q, k, v K7 is held on
LM_LAST_ROWS = 512         # at 32k the dense forms hold the last rows only
# timed runs of each LM figure after a warm-up, their median (two, to pay
# with the autotune phase's repetitions for `phase_serve_elastic`)
LM_REPS = 2
# Relative Frobenius norm of the bf16 model's logits over the true vocab
# against (a) an f32 run of the same weights (the reference's dense
# attention math) and (b) `forward` on T + 1 tokens against decode's logits
# at position T.  A bf16 operation rounds by at most its unit roundoff
# 2^-8 relative, rms 2^-8 / sqrt(3) = 2.3e-3; a layer rounds its residual
# stream about four times (norm, attention out, MLP out, the adds), so 24
# layers random-walk to ~sqrt(96) 2.3e-3 = 2.2e-2 for one bf16 run against
# exact, ~3.1e-2 for two independent ones: the bar 5e-2 leaves 1.6x (a bar
# above it would be a fault for ROADMAP queue 3).
LM_BF16_REL = 5e-2
# K7 (float32 scores; P rounded to bf16 for P V in the tensor-core form)
# against SDPA's bf16 flash path (P rounded to bf16 before P V, 2^-8
# relative) and against the model's own dense core (scores, exp and
# probabilities each rounded to bf16: scores of magnitude ~4 move by
# 4 2^-8, 1.6% in P), by relative norm.
K7_SDPA_REL = 1e-2
K7_CORE_REL = 3e-2


def flash_err(got, want) -> float:
    """max |got - want| / (1 + |want|)."""
    return float(((got.double() - want.double()).abs()
                  / (1.0 + want.double().abs())).max())


def rel_norm(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def flash_work(B, T, H, KV, hd, elem_bytes=2):
    """(useful causal flops, bytes of q, k, v read and o written)."""
    flops = 4 * B * H * hd * T * (T + 1) // 2
    nbytes = elem_bytes * (2 * B * T * H * hd + 2 * B * T * KV * hd)
    return flops, nbytes


def sm90_errs(got, want, v):
    """(max |got - want| / max |v|, relative norm): K7's tensor-core form
    against a float32-P attention, at SM90_ELEM and SM90_REL."""
    d = got.double() - want.double()
    return (float(d.abs().max() / v.double().abs().max()),
            float(d.norm() / want.double().norm()))


def phase_flash_parity(device):
    """K7 against its plain version (on the same padded inputs) and the
    dense oracle `ref_attention`, on FLASH_CASES in float32, bfloat16 and
    float64, one launch each: the tensor-core form (bf16 at hd 64, 128) at
    SM90_ELEM and SM90_REL, the CUDA-core form at FLASH_TOL and
    FLASH_BF16_ULPS."""
    import torch
    from repro_torch.kernels.flashattn import kernel as fk
    from repro_torch.kernels.flashattn.ops import (flash_attention,
                                                   pad_to_blocks)
    from repro_torch.kernels.flashattn.ref import bf16_ulps, ref_attention
    worst = {}
    for name, B, T, H, KV, hd, causal, bq, bk in FLASH_CASES:
        rng = np.random.default_rng(SEED)
        arrays = [rng.standard_normal(s) for s in
                  ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
        for dt in (torch.float32, torch.bfloat16, torch.float64):
            q, k, v = (torch.from_numpy(a).to(device=device, dtype=dt)
                       for a in arrays)
            form = fk.form_of(dt, hd)
            before = (fk.launches, fk.launches_sm90)
            got = flash_attention(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk)
            qp, kp, vp, bq_, bk_ = pad_to_blocks(q, k, v, causal=causal,
                                                 block_q=bq, block_k=bk)
            plain = fk.flash_attention_plain(qp, kp, vp, causal=causal,
                                             block_q=bq_, block_k=bk_)[:, :T]
            ref = ref_attention(q, k, v, causal=causal)
            sync(device)
            if (fk.launches, fk.launches_sm90) != (
                    before[0] + 1, before[1] + (form == "sm90")):
                raise AssertionError(f"flash {name}: K7's {form} form was "
                                     f"not launched alone")
            if got.dtype != dt or got.shape != q.shape:
                raise AssertionError(f"flash {name}: {got.dtype} "
                                     f"{tuple(got.shape)} out")
            tag = str(dt).split(".")[-1]
            if form == "sm90":
                tag += " sm90"
                errs = sm90_errs(got, plain, v) + sm90_errs(got, ref, v)
                bars = (SM90_ELEM, SM90_REL) * 2
            elif dt == torch.bfloat16:
                errs = (bf16_ulps(got, plain), bf16_ulps(got, ref))
                bars = (FLASH_BF16_ULPS,) * 2
            else:
                errs = (flash_err(got, plain), flash_err(got, ref))
                bars = (FLASH_TOL,) * 2
            if any(e > bar for e, bar in zip(errs, bars)):
                raise AssertionError(f"flash {name} {tag}: against the plain "
                                     f"version and the oracle {errs} > "
                                     f"{bars}")
            w = worst.setdefault(tag, [0.0] * len(errs) + [0])
            worst[tag] = [max(a, b) for a, b in zip(w, errs)] + [w[-1] + 1]
    for tag, w in worst.items():
        if tag.endswith("sm90"):
            what = (f"against the plain version {w[0]:.3e} of max|v|, "
                    f"{w[1]:.3e} by norm; against ref_attention {w[2]:.3e}, "
                    f"{w[3]:.3e} (bars {SM90_ELEM:.3e}, {SM90_REL:.3e})")
        else:
            unit = "bf16 ulps" if tag == "bfloat16" else "of 1 + |value|"
            bar = FLASH_BF16_ULPS if tag == "bfloat16" else FLASH_TOL
            what = (f"against the plain version {w[0]:.3e}, against "
                    f"ref_attention {w[1]:.3e} {unit} (bar {bar})")
        print(f"flash parity {tag}: {w[-1]} cases, K7 {what}")
    return worst


class FlashProbe:
    """An attention core that runs K7 (`flash_attention`) and, while
    `keep`, keeps the q, k, v of the chosen layers' calls."""

    def __init__(self, layers, n_layers):
        self.layers, self.n_layers = layers, n_layers
        self.calls, self.keep, self.kept = 0, False, {}

    def __call__(self, q, k, v, *, causal=True):
        from repro_torch.kernels.flashattn.ops import flash_attention
        layer = self.calls % self.n_layers
        self.calls += 1
        if self.keep and layer in self.layers:
            self.kept[layer] = (q, k, v)
        return flash_attention(q, k, v, causal=causal)


def kernel_modules():
    """Every wrapper module with a launch counter."""
    from repro_torch.kernels import interp
    from repro_torch.kernels.em import adaptive, kernel as em_kernel
    from repro_torch.kernels.flashattn import kernel as flash_kernel
    from repro_torch.kernels.lu import kernel as lu_kernel
    from repro_torch.kernels.rosenbrock import kernel as rb_kernel
    from repro_torch.kernels.tsit5 import kernel as erk_kernel
    return {"erk_ensemble": erk_kernel, "sde_ensemble": em_kernel,
            "sde_adaptive_ensemble": adaptive,
            "rosenbrock_ensemble": rb_kernel, "lu_solve": lu_kernel,
            "interp_lookup": interp, "flash_attention": flash_kernel}


def dense_last_rows(q, k, v, n):
    """The dense f32 oracle (`ref_attention`'s math) on the last n query
    rows of a causal attention."""
    import torch
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qf = q[:, T - n:].float().reshape(B, n, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / float(hd) ** 0.5
    rows = torch.arange(T - n, T, device=q.device)[:, None]
    s = s.masked_fill(torch.arange(S, device=q.device)[None, :] > rows,
                      -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, n, H, hd).to(q.dtype)


def lm_k7_row(device, name, kept, T, main_launches, layers=LM_K7_LAYERS):
    """K7 on the served model's roped q, k and v of `layers`: held
    against its plain version (every row; both on the blocks' padding, as
    `ops.flash_attention` pads), `ref_attention` and the model's own dense
    core (every row up to 4k, the last LM_LAST_ROWS at 32k), and SDPA;
    timed beside the plain version and SDPA on the same tensors."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashattn import kernel as fk
    from repro_torch.kernels.flashattn.ops import (flash_attention,
                                                   pad_to_blocks)
    from repro_torch.kernels.flashattn.ref import bf16_ulps, ref_attention
    from repro_torch.models.layers import attention_core
    ms, plain_ms, sdpa_ms, max_abs, checks = [], [], [], 0.0, {}
    for layer in layers:
        q, k, v = kept[layer]
        B, _, H, hd = q.shape
        KV = k.shape[2]
        form = fk.form_of(q.dtype, hd)
        qp, kp, vp, bq, bk = pad_to_blocks(q, k, v)

        def plain_fn():
            return fk.flash_attention_plain(qp, kp, vp, block_q=bq,
                                            block_k=bk)[:, :T]

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        got = flash_attention(q, k, v)
        plain = plain_fn()
        lib = sdpa()
        if T <= 4096:
            n = T
            ref = ref_attention(q, k, v)
            core = attention_core(q, k, v)
        else:
            n = LM_LAST_ROWS
            ref = dense_last_rows(q, k, v, n)
            core = attention_core(q[:, T - n:], k, v, q_offset=T - n)
        core = core.reshape(B, n, H, hd)
        sync(device)
        if form == "sm90":
            c = dict(zip(("plain_elem", "plain_rel", "ref_elem", "ref_rel"),
                         sm90_errs(got, plain, v)
                         + sm90_errs(got[:, T - n:], ref, v)))
            bars = {"plain_elem": SM90_ELEM, "plain_rel": SM90_REL,
                    "ref_elem": SM90_ELEM, "ref_rel": SM90_REL}
        else:
            c = {"plain_ulps": bf16_ulps(got, plain),
                 "ref_ulps": bf16_ulps(got[:, T - n:], ref)}
            bars = {"plain_ulps": FLASH_BF16_ULPS, "ref_ulps": FLASH_BF16_ULPS}
        c.update(sdpa_rel=rel_norm(got, lib),
                 core_rel=rel_norm(got[:, T - n:], core),
                 plain_max_abs=float((got.float() - plain.float()).abs().max()))
        bars.update(sdpa_rel=K7_SDPA_REL, core_rel=K7_CORE_REL)
        del plain, ref, core, lib
        for key, bar in bars.items():
            if not c[key] <= bar:
                raise AssertionError(f"{name} K7 layer {layer}: {key} "
                                     f"{c[key]:.3e} > {bar}")
        max_abs = max(max_abs, c["plain_max_abs"])
        checks[f"layer{layer}"] = c
        ms.append(cuda_ms(lambda: flash_attention(q, k, v), LM_REPS))
        sdpa_ms.append(cuda_ms(sdpa, LM_REPS))
        plain_ms.append(cuda_ms(plain_fn, 1))
        torch.cuda.empty_cache()
    flops, nbytes = flash_work(B, T, H, KV, hd)
    t_ops = flops / PEAK_BF16_TENSOR_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    fp32_ms = flops / PEAK_FP32_FLOPS * 1e3
    source = fk.SM90_SOURCE if form == "sm90" else fk.SOURCE
    row = {"name": f"flash_attention[bf16,hd={hd},{name}]", "route": "cuda",
           "source": f"src/repro_torch/csrc/{source}",
           "replaces": "src/repro/kernels/flashattn/kernel.py:76",
           "launches": main_launches, "max_abs_err": max_abs,
           "ms": statistics.median(ms), "plain_ms": statistics.median(plain_ms),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": statistics.median(sdpa_ms),
           "library": "torch.nn.functional.scaled_dot_product_attention",
           "form": form,
           "fp32_ceiling_ms": fp32_ms, "shape": [B, T, H, KV, hd],
           "layers": list(layers), "checks": checks}
    row["tflops"] = flops / row["ms"] / 1e9
    row["ms_over_bound"] = row["ms"] / row["bound_ms"]
    row["ms_over_library"] = row["ms"] / row["library_ms"]
    print(f"{name} K7 ({form} form): ({B}, {T}, {H}, {KV}, {hd}) bf16, layers "
          f"{list(layers)}: {row['ms']:.3f} ms (per layer "
          f"{[round(t, 3) for t in ms]}), {row['tflops']:.1f} TFLOP/s; SDPA "
          f"{row['library_ms']:.3f} ms, plain {row['plain_ms']:.1f} ms; "
          f"bound {row['bound_ms']:.4f} ms ({flops:.4e} useful flops at 989 "
          f"TFLOP/s bf16, {nbytes:.4e} bytes {t_bytes:.4f} ms), FP32 "
          f"CUDA-core ceiling {fp32_ms:.3f} ms; K7 / bound "
          f"{row['ms_over_bound']:.2f}x, K7 / SDPA "
          f"{row['ms_over_library']:.2f}x; holds "
          + json.dumps({k: {kk: float(f"{vv:.4g}") for kk, vv in d.items()}
                        for k, d in checks.items()}))
    return row


def phase_lm_serve(device):
    """The dense-LM serving path at internlm2-1.8b's full width in bf16,
    weights from a seeded generator, K7 as the attention core
    (`model.attn_core`): per LM_ROWS row, the main path once (prefill, then
    greedy decode steps through `make_serve_plan(mesh=None)`; every launch
    counter set to 0 before it, K7's tensor-core form launched once a
    layer and nothing else), its holds
    (decode at position T against `forward` on T + 1 tokens; the prefill's
    logits against an f32 run of the same weights on the reference's dense
    attention; finite logits and masked pad columns), its times (prefill
    with K7 and, at 4k, with the reference's dense bf16 core, decode per
    step, tokens/s; CUDA events, median of LM_REPS, the main path's run
    the warm-up) and peak memory, then K7's row on the model's own q, k,
    v (`lm_k7_row`)."""
    import torch
    from repro_torch.configs.archs import get_arch
    from repro_torch.models.lm import _logits
    from repro_torch.models.model import build_model
    from repro_torch.train.serve import make_serve_plan
    cfg = get_arch(LM_ARCH)
    V = cfg.vocab_size
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    model = build_model(cfg, torch.bfloat16, device=device).init_params(gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{LM_ARCH}: {n_params} parameters (vocab padded to "
          f"{cfg.vocab_padded}; {cfg.n_params()} with the true vocab), "
          f"bf16, drawn in {time.perf_counter() - t0:.1f} s")
    mods = kernel_modules()
    k7_rows, lm_rows = [], []
    for name, (B, T, cache_len, steps, q_chunk) in LM_ROWS.items():
        t_row = time.perf_counter()
        rng = np.random.default_rng(LM_SEED + T)
        toks = torch.from_numpy(rng.integers(0, V, (B, T))).to(device)
        batch = {"tokens": toks}
        probe = FlashProbe(LM_K7_LAYERS, cfg.n_layers)
        model.attn_core, model.q_chunk = probe, q_chunk
        plan = make_serve_plan(model, None, B, cache_len)
        # ---- the main path, once -----------------------------------------
        sync(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        for mod in mods.values():
            mod.launches = 0
        mods["flash_attention"].launches_sm90 = 0
        probe.keep = True
        logits, cache = plan.prefill_fn(batch)
        probe.keep = False
        cur = logits[..., :V].argmax(-1)
        first_tok, gen_toks = cur, []
        for s in range(steps):
            step_logits, cache = plan.decode_fn(cache, cur)
            if s == 0:
                first_logits = step_logits
            cur = step_logits[..., :V].argmax(-1)
            gen_toks.append(cur)
        sync(device)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        launches = {k: m.launches for k, m in mods.items()}
        k7_counts = (launches.pop("flash_attention"),
                     mods["flash_attention"].launches_sm90)
        if k7_counts != (cfg.n_layers,) * 2 or any(launches.values()):
            raise AssertionError(f"{name}: launches on the main path "
                                 f"{launches}, K7 (all, sm90) {k7_counts} "
                                 f"(want {cfg.n_layers} of the sm90 form)")
        gen_toks = torch.cat(gen_toks, dim=1)
        pad = logits[..., V:]
        if not (bool(torch.isfinite(logits[..., :V]).all())
                and bool(torch.isfinite(first_logits[..., :V]).all())
                and bool((pad == torch.finfo(torch.bfloat16).min / 8).all())
                and logits.shape == (B, 1, cfg.vocab_padded)
                and int(cache["pos"]) == T + steps
                and bool(((gen_toks >= 0) & (gen_toks < V)).all())):
            raise AssertionError(f"{name}: logits, cache or tokens malformed")
        steps_s = {"main path": time.perf_counter() - t_row}
        # ---- holds ---------------------------------------------------------
        with torch.inference_mode():
            x, _ = model.forward(torch.cat([toks, first_tok], dim=1))
            fwd = _logits(x[:, -1:], model, cfg)
            del x
            decode_rel = rel_norm(first_logits[..., :V], fwd[..., :V])
            # the same weights in f32, on the reference's dense attention
            model32 = build_model(cfg, torch.float32, device=device)
            model32.load_state_dict(model.state_dict())
            model32.q_chunk = q_chunk
            x, _ = model32.forward(toks)
            f32 = _logits(x[:, -1:], model32, cfg)
            del x
            f32_rel = rel_norm(logits[..., :V], f32[..., :V])
            del model32
        for what, err in (("decode at T against forward on T + 1",
                           decode_rel),
                          ("prefill against the f32 run", f32_rel)):
            if not err <= LM_BF16_REL:
                raise AssertionError(f"{name}: {what}: relative norm "
                                     f"{err:.3e} > {LM_BF16_REL}")
        torch.cuda.empty_cache()
        steps_s["holds"] = time.perf_counter() - t_row - sum(steps_s.values())
        # ---- times (the main path's prefill and decode were the warm-up) ----
        prefill_ms = cuda_ms(lambda: plan.prefill_fn(batch), LM_REPS,
                             warmup=0)
        torch.cuda.empty_cache()

        def decode_run():
            with torch.inference_mode():
                cache["pos"].fill_(T)
            tok = first_tok
            for _ in range(steps):
                out, _ = plan.decode_fn(cache, tok)
                tok = out[..., :V].argmax(-1)

        decode_ms = cuda_ms(decode_run, LM_REPS, warmup=0) / steps
        # the reference's dense bf16 core, for comparison, at 4k (at 32k
        # it took 5.97-8.80 s a run, PERF.md §5)
        dense_ms = None
        if T <= 4096:
            model.attn_core = None
            dense_ms = cuda_ms(lambda: plan.prefill_fn(batch), LM_REPS)
            torch.cuda.empty_cache()
        steps_s["times"] = time.perf_counter() - t_row - sum(steps_s.values())
        lm = {"name": name, "arch": LM_ARCH, "batch": B, "prompt": T,
              "cache_len": cache_len, "decode_steps": steps,
              "q_chunk": q_chunk, "prefill_ms": prefill_ms,
              "prefill_dense_core_ms": dense_ms,
              "decode_ms_per_step": decode_ms,
              "tokens_per_s": B / (decode_ms / 1e3), "peak_gb": peak_gb,
              "decode_vs_forward_rel": decode_rel,
              "prefill_vs_f32_rel": f32_rel, "bar": LM_BF16_REL}
        dense_txt = ("" if dense_ms is None else
                     f" ({dense_ms:.1f} ms with the dense bf16 core)")
        print(f"{name}: prefill {B} x {T} tokens {prefill_ms:.1f} ms with "
              f"K7{dense_txt}, decode "
              f"{decode_ms:.3f} ms a step ({lm['tokens_per_s']:.1f} generated "
              f"tokens/s over {steps} steps), peak {peak_gb:.3f} GB; decode "
              f"at T against forward on T + 1 {decode_rel:.3e}, prefill "
              f"against the f32 run {f32_rel:.3e} (bar {LM_BF16_REL}); K7 "
              f"launches on the main path {cfg.n_layers}, all of the sm90 "
              f"form, other kernels 0")
        k7 = lm_k7_row(device, name, probe.kept, T, cfg.n_layers)
        del probe, cache, logits, first_logits, fwd, f32
        torch.cuda.empty_cache()
        steps_s["K7 row"] = (time.perf_counter() - t_row
                             - sum(steps_s.values()))
        lm["step_s"] = {k: round(v, 1) for k, v in steps_s.items()}
        print("lm " + json.dumps(lm))
        k7["serve"] = lm
        k7_rows.append(k7)
        lm_rows.append(lm)
    model.attn_core = None
    return k7_rows


# The other five families on the serving path at full width, bf16.  row:
# (arch, requests, prompt tokens, cache_len, greedy decode steps, K7
# launches a prefill, all of its sm90 form; 0: no causal attention without
# window or softcap on the path).  deepseek: B T = 4096 is one MoE group;
# mamba2: 8 chunks of 256, so the inter-chunk recurrence runs;
# recurrentgemma: past the 2048 window and 3072 % 2048 != 0, so the
# prefill's ring cache rolls; whisper: 192 tokens over (4, 1500, 384)
# frames, K7 on the decoder's self-attention only (the encoder is
# non-causal); internvl2: 768 text tokens after 256 patches of width
# 3200 (T = 1024 on the LM).
LM_FAMILY_ROWS = {
    "lm-deepseek-moe-16b-serve": ("deepseek-moe-16b", 2, 2048, 2064, 16, 28),
    "lm-mamba2-2.7b-serve": ("mamba2-2.7b", 2, 2048, 2064, 16, 0),
    "lm-recurrentgemma-9b-serve": ("recurrentgemma-9b", 2, 3072, 3088, 16,
                                   0),
    "lm-whisper-tiny-serve": ("whisper-tiny", 4, 192, 224, 32, 4),
    "lm-internvl2-26b-serve": ("internvl2-26b", 2, 768, 1040, 16, 48),
}
# The holds at LM_BF16_REL: decode at position T against `forward` on
# T + 1, and the prefill against an f32 run of the same weights on the
# dense core.  Each runs on the whole model or on a copy of its first
# blocks (arch -> (decode hold's blocks, f32 hold's blocks), None: all):
#   - an f32 copy of deepseek (67.5 GB) or internvl2 (79.5 GB) does not fit
#     beside the bf16 model;
#   - Mamba-2's bf16 arithmetic moves its residual stream ~0.5% a layer
#     from f32, 29% over its 64 layers, and its bf16 decode and forward
#     part by 19% (the reference's bf16 drifts as much: 1.0e-2, 1.5e-2,
#     3.0e-2 at 1, 2, 4 layers of full width on the CPU);
#   - recurrentgemma's bf16 prefill sits 6.3e-2 from f32 over 38 layers
#     (held on its first period, R, R, A);
# `tools/lm_bf16_probe.py` measures each (PERF.md §6).
# On an MoE row the compared runs take the same experts (`RoutingReplay`):
# a top-6 near-tie that bf16 noise flips is a discrete change, not a fault
# (5-9% of deepseek's tokens a layer between bf16 and f32); the flips are
# counted and printed.
LM_HOLD_BLOCKS = {"deepseek-moe-16b": (None, 2), "mamba2-2.7b": (2, 2),
                  "recurrentgemma-9b": (None, 3), "whisper-tiny": (None, None),
                  "internvl2-26b": (None, 2)}


class RoutingReplay:
    """Smoke instrumentation of `models.moe.moe_route`: while recording it
    keeps each call's chosen experts; while replaying it gives each call,
    in order, the recorded experts on the rows `rows` selects (all when
    None), the top-k weights taken from that run's own probabilities, and
    counts the tokens whose choice differed."""

    def __init__(self):
        self.calls, self.mode, self.rows, self.i, self.flips = [], None, \
            None, 0, 0

    def __enter__(self):
        import repro_torch.models.moe as moe
        self.real, moe.moe_route = moe.moe_route, self
        return self

    def __exit__(self, *exc):
        import repro_torch.models.moe as moe
        moe.moe_route = self.real

    def __call__(self, x, router, **kw):
        import torch
        r = self.real(x, router, **kw)
        if self.mode == "record":
            self.calls.append(r.topi.clone())
        elif self.mode == "replay":
            want = self.calls[self.i]
            self.i += 1
            rows = (torch.arange(r.topi.shape[0], device=x.device)
                    if self.rows is None else self.rows)
            self.flips += int((r.topi[rows].sort(-1).values
                               != want.sort(-1).values).any(-1).sum())
            topi = r.topi.clone()
            topi[rows] = want
            topv = r.probs.gather(1, topi)
            topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
            r = r._replace(topi=topi, topv=topv)
        return r


def family_batch(cfg, B, T, device, seed):
    """Tokens (B, T) and the stub frontends' inputs (frames, patches) from
    a numpy seed, on the card."""
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, T))).to(device)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32)).to(device)
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vis_seq, cfg.vis_dim), dtype=np.float32)).to(device)
    return batch


def family_forward_last(model, cfg, batch):
    """`forward`'s logits at the last position: over the multimodal
    embeddings (VLM), with the frames (whisper), with no MoE drops."""
    import torch
    from repro_torch.models.lm import _logits
    with torch.inference_mode():
        if cfg.family == "vlm":
            h0 = model._embed_multimodal(batch["tokens"], batch["patches"])
            x, _ = model.lm.forward(None, h0=h0)
            return _logits(x[:, -1:], model.lm, cfg)
        if cfg.family == "encdec":
            x = model.forward(batch["tokens"], batch["frames"])
        elif cfg.family == "moe":
            # with no drops the routing is a token's own, whatever the
            # groups: one group of all B (T + 1) tokens
            kept = model.moe_cf, model.moe_group
            model.moe_cf, model.moe_group = None, batch["tokens"].numel()
            x, _ = model.forward(batch["tokens"])
            model.moe_cf, model.moe_group = kept
        elif cfg.family == "ssm":
            # T + 1 tokens in the largest chunk <= 1024 that divides them
            n = batch["tokens"].shape[1]
            chunk, model.ssd_chunk = model.ssd_chunk, max(
                d for d in range(1, 1025) if n % d == 0)
            x = model.forward(batch["tokens"])
            model.ssd_chunk = chunk
        else:
            x = model.forward(batch["tokens"])
        return _logits(x[:, -1:], model, cfg)


def family_copy(model, cfg, blocks, dtype, core):
    """`model` itself (blocks None, the same dtype), or a copy of its first
    `blocks` blocks (embeddings, norms and projector with them) in
    `dtype`, with attention core `core`."""
    import torch
    from repro_torch.models.model import build_model
    if blocks is None and dtype == model.dtype:
        return model, cfg
    small = cfg if blocks is None else dataclasses.replace(cfg,
                                                           n_layers=blocks)
    m = build_model(small, dtype)
    sd = model.state_dict()
    with torch.no_grad():
        m.load_state_dict({k: sd[k] for k in m.state_dict()})
    if hasattr(m, "attn_core"):
        m.attn_core = core
    return m, small


def family_holds(model, cfg, arch, batch, cache_len, logits, first_tok,
                 first_logits, replay, core):
    """(decode at T against forward on T + 1, the bf16 prefill against the
    f32 one on the dense core), by relative norm over the true vocab, each
    on the blocks LM_HOLD_BLOCKS gives, and each hold's count of tokens
    routed to other experts (replayed); `replay` holds the main path's
    first decode step's routing (MoE rows)."""
    import torch
    V = cfg.vocab_size
    dec_blocks, f32_blocks = LM_HOLD_BLOCKS[arch]
    full = dict(batch, tokens=torch.cat([batch["tokens"], first_tok], dim=1))
    B, T1 = full["tokens"].shape
    with torch.inference_mode(), RoutingReplay() as rr:
        # ---- decode at T against forward on T + 1 ----------------------
        m, small = family_copy(model, cfg, dec_blocks, model.dtype, core)
        if m is model:
            rr.calls = replay
        else:
            rr.mode = "record"
            _, cache = m.prefill(batch, cache_len)
            first_logits, _ = m.decode_step(cache, first_tok)
            del cache
        if rr.calls:
            # the last token of each request takes the decode's experts
            rr.mode, rr.i = "replay", 0
            rr.rows = torch.arange(B, device=first_tok.device) * T1 + T1 - 1
        fwd = family_forward_last(m, small, full)
        decode_rel = rel_norm(first_logits[..., :V], fwd[..., :V])
        flips = [rr.flips]
        del m, fwd
        # ---- the prefill against f32 ----------------------------------
        rr.calls, rr.mode, rr.rows, rr.i, rr.flips = [], "record", None, 0, 0
        mb, small = family_copy(model, cfg, f32_blocks, model.dtype, core)
        if mb is not model:
            logits = mb.prefill(batch, cache_len)[0]
        del mb
        m32, _ = family_copy(model, cfg, f32_blocks, torch.float32, None)
        rr.mode = "replay" if rr.calls else None
        want = m32.prefill(batch, cache_len)[0]
        f32_rel = rel_norm(logits[..., :V], want[..., :V])
        flips.append(rr.flips)
        del m32, want
    torch.cuda.empty_cache()
    return decode_rel, f32_rel, flips


def phase_lm_families(device):
    """The MoE, Mamba-2, RecurrentGemma, Whisper and InternVL2 serving
    paths at full width in bf16 (LM_FAMILY_ROWS), each model from
    `build_model(cfg, torch.bfloat16)` on the default device, its weights
    from a seeded generator, K7 as the attention core where the path has
    causal attention without window or softcap.  Per row: the main path
    once (prefill, then greedy decode steps through
    `make_serve_plan(mesh=None)`; every launch counter set to 0 before
    it: K7's sm90 form launched once an attention layer, nothing else);
    the holds (decode at position T against `forward` on T + 1; the
    prefill against an f32 run on the dense core; finite logits, masked
    pad columns, pos and tokens), all at LM_BF16_REL; the weights' draw
    seconds, prefill ms (median of LM_REPS after the main path's),
    decode ms a step, tokens/s, peak GB; then K7's row on the first
    layer's q, k, v (`lm_k7_row`).  Each model is deleted after its
    row."""
    import torch
    from repro_torch.configs.archs import get_arch
    from repro_torch.kernels.flashattn.ops import flash_attention
    from repro_torch.models.model import build_model
    from repro_torch.train.serve import make_serve_plan
    mods = kernel_modules()
    k7_rows = []
    for i, (name, (arch, B, T, cache_len, steps, n_k7)) in enumerate(
            LM_FAMILY_ROWS.items()):
        t_row = time.perf_counter()
        steps_s = {}
        cfg = get_arch(arch)
        V = cfg.vocab_size
        sync(device)
        model = build_model(cfg, torch.bfloat16).init_params(
            torch.Generator(device).manual_seed(LM_SEED + i))
        sync(device)
        draw_s = time.perf_counter() - t_row
        T_lm = T + (cfg.vis_seq if cfg.family == "vlm" else 0)
        batch = family_batch(cfg, B, T, device, LM_SEED + i)
        probe = None
        if n_k7:
            probe = FlashProbe((0,), cfg.n_layers)
            model.attn_core = probe
        plan = make_serve_plan(model, None, B, cache_len)
        steps_s["draw"] = time.perf_counter() - t_row
        # ---- the main path, once -----------------------------------------
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        for mod in mods.values():
            mod.launches = 0
        mods["flash_attention"].launches_sm90 = 0
        if probe:
            probe.keep = True
        logits, cache = plan.prefill_fn(batch)
        if probe:
            probe.keep = False
        cur = logits[..., :V].argmax(-1)
        first_tok, gen_toks = cur, []
        for s in range(steps):
            if s == 0:
                # an MoE row keeps the first step's experts for its hold
                with RoutingReplay() as replay:
                    replay.mode = "record"
                    step_logits, cache = plan.decode_fn(cache, cur)
                first_logits = step_logits
            else:
                step_logits, cache = plan.decode_fn(cache, cur)
            cur = step_logits[..., :V].argmax(-1)
            gen_toks.append(cur)
        sync(device)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        launches = {k: m.launches for k, m in mods.items()}
        k7_counts = (launches.pop("flash_attention"),
                     mods["flash_attention"].launches_sm90)
        if k7_counts != (n_k7, n_k7) or any(launches.values()):
            raise AssertionError(f"{name}: launches on the main path "
                                 f"{launches}, K7 (all, sm90) {k7_counts} "
                                 f"(want {n_k7} of the sm90 form)")
        gen_toks = torch.cat(gen_toks, dim=1)
        pad = logits[..., V:]
        if not (bool(torch.isfinite(logits[..., :V]).all())
                and bool(torch.isfinite(first_logits[..., :V]).all())
                and bool((pad == torch.finfo(torch.bfloat16).min / 8).all())
                and logits.shape == (B, 1, cfg.vocab_padded)
                and int(cache["pos"]) == T_lm + steps
                and bool(((gen_toks >= 0) & (gen_toks < V)).all())):
            raise AssertionError(f"{name}: logits, cache or tokens malformed")
        steps_s["main path"] = time.perf_counter() - t_row - sum(
            steps_s.values())
        # ---- holds ---------------------------------------------------------
        decode_rel, f32_rel, flips = family_holds(
            model, cfg, arch, batch, cache_len, logits, first_tok,
            first_logits, replay.calls, flash_attention if n_k7 else None)
        del replay
        for what, err in (("decode at T against forward on T + 1",
                           decode_rel),
                          ("prefill against the f32 run", f32_rel)):
            if not err <= LM_BF16_REL:
                raise AssertionError(f"{name}: {what}: relative norm "
                                     f"{err:.3e} > {LM_BF16_REL}")
        steps_s["holds"] = time.perf_counter() - t_row - sum(steps_s.values())
        # ---- times (the main path's prefill and decode were the warm-up) --
        prefill_ms = cuda_ms(lambda: plan.prefill_fn(batch), LM_REPS,
                             warmup=0)

        def decode_run():
            with torch.inference_mode():
                cache["pos"].fill_(T_lm)
            tok = first_tok
            for _ in range(steps):
                out, _ = plan.decode_fn(cache, tok)
                tok = out[..., :V].argmax(-1)

        decode_ms = cuda_ms(decode_run, 1, warmup=0) / steps
        steps_s["times"] = time.perf_counter() - t_row - sum(steps_s.values())
        lm = {"name": name, "arch": arch, "family": cfg.family, "batch": B,
              "prompt": T, "lm_tokens": T_lm, "cache_len": cache_len,
              "decode_steps": steps, "draw_s": draw_s,
              "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
              "tokens_per_s": B / (decode_ms / 1e3), "peak_gb": peak_gb,
              "k7_launches": k7_counts[0], "k7_sm90_launches": k7_counts[1],
              "decode_vs_forward_rel": decode_rel,
              "prefill_vs_f32_rel": f32_rel,
              "hold_blocks": [b or cfg.n_layers for b in LM_HOLD_BLOCKS[arch]],
              "routing_flips": flips, "bar": LM_BF16_REL}
        print(f"{name}: weights drawn in {draw_s:.1f} s; prefill {B} x {T} "
              f"tokens {prefill_ms:.1f} ms, decode {decode_ms:.3f} ms a step "
              f"({lm['tokens_per_s']:.1f} generated tokens/s over {steps} "
              f"steps), peak {peak_gb:.3f} GB; decode at T against forward "
              f"on T + 1 {decode_rel:.3e}, prefill against the f32 run "
              f"{f32_rel:.3e} (on {lm['hold_blocks']} blocks; {flips} "
              f"tokens took other experts, replayed; bar {LM_BF16_REL}); K7 "
              f"launches "
              f"on the main path {n_k7}, all of the sm90 form, other "
              f"kernels 0")
        if n_k7:
            k7 = lm_k7_row(device, name, probe.kept,
                           probe.kept[0][0].shape[1], n_k7, layers=(0,))
            k7["serve"] = lm
            k7_rows.append(k7)
        del probe, plan, cache, logits, first_logits, batch, model
        torch.cuda.empty_cache()
        steps_s["K7 row"] = (time.perf_counter() - t_row
                             - sum(steps_s.values()))
        lm["step_s"] = {k: round(v, 1) for k, v in steps_s.items()}
        print("lm " + json.dumps(lm))
    return k7_rows


# ---- LM training on one card (phase_lm_train) -------------------------------
# lm-internlm2-1.8b-train: internlm2-1.8b at full width and depth, bf16
# parameters, f32 AdamW state, remat=True; 4 x 4096 tokens a step from
# `DataPipeline(seed=0)` (the reference's train_4k sequence, its global
# batch of 256 cut to 4 for one card; `pick_accum` gives 2), its first two
# batches in turns (step % 2), AdamW as the reference's launcher sets it
# (`launch/train.py`: cosine_schedule(3e-4, 20, 200) at its default --lr
# and --steps, weight decay 0.1, clip 1.0; a constant 1e-3, the reduced
# model's rate in tests/test_trainer.py, diverged at this width in f32 as
# in bf16: PERF.md §6).  Holds: the first step's ce within
# LM_TRAIN_CE of ln V (tests/test_models_smoke.py:29), the last loss below
# the first (tests/test_trainer.py::test_loss_decreases_over_steps), every
# gradient finite.  Step seconds: the median of steps 3-6.
LM_TRAIN_ARCH = "internlm2-1.8b"
LM_TRAIN_BATCH = (4, 4096)
LM_TRAIN_STEPS = 6
LM_TRAIN_LR = (3e-4, 20, 200)
LM_TRAIN_CE = 2.0
# the bf16 gradient against an f32 one on the same weights and batch, by
# relative norm over the model's first blocks (printed, not gated)
LM_TRAIN_GRAD_BLOCKS = 2
# accumulation at full width on 2 layers in f32: accum=2 against accum=1
# on one batch of 8 x 512, parameters within 1e-4 after the step (the
# reference's test_grad_accum_equivalence bar)
LM_TRAIN_ACCUM = (2, 8, 512, 1e-4)
# the card against the CPU: internlm2-1.8b-smoke in f32, three steps of
# 4 x 64 tokens, losses and grad_norm within 1e-5 relative
LM_TRAIN_CPU = (3, 4, 64, 1e-5)
# every other family's -smoke config, one step of 2 x 32 tokens on the card
LM_TRAIN_FAMILIES = ("deepseek-moe-16b", "mamba2-2.7b", "recurrentgemma-9b",
                     "whisper-tiny", "internvl2-26b")


def train_flops(cfg, B, T, remat=True):
    """Model flops of one training step of a dense decoder on B x T
    tokens: 6 N T B for the matmuls (N the parameters that enter one: all
    but the embedding table, which is a gather, and the norms), plus the
    dense core's attention, 4 B H hd T^2 a layer forward (it computes every
    score, then masks), three times (forward and backward), plus remat's
    recompute of every block's forward."""
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    block = D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F
    head = D * cfg.vocab_padded
    attn = 4 * B * H * hd * T * T * L
    tokens = B * T
    flops = 6 * (L * block + head) * tokens + 3 * attn
    if remat:
        flops += 2 * L * block * tokens + attn
    return flops


def train_rel_grads(model, cfg, batch, blocks):
    """The bf16 gradient against an f32 one of the same weights (the
    model's first `blocks` blocks with its embeddings and norms) on the
    same batch (one microbatch of the main path's), by relative norm over
    every leaf; and the three leaves that carry most of the difference,
    with their own."""
    import torch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import make_train_step
    grads = {}
    for dtype in (model.dtype, torch.float32):
        m, _ = family_copy(model, cfg, blocks, dtype, None)
        _, _, g = make_train_step(m, AdamW(lr=0.0)).grad_fn(batch)
        grads[dtype] = {n: t.float() for n, t in g.items()}
        del m, g
    want = grads.pop(torch.float32)
    got = grads.pop(model.dtype)
    nums = {n: float((got[n] - want[n]).double().square().sum())
            for n in want}
    den = sum(float(want[n].double().square().sum()) for n in want)
    # the leaves that carry most of the difference, each with its own
    # relative norm
    top = {n: round((nums[n] / float(want[n].double().square().sum()))
                    ** 0.5, 4)
           for n in sorted(nums, key=nums.get, reverse=True)[:3]}
    return (sum(nums.values()) / den) ** 0.5, top


def train_collectives(grads):
    """`dist.collectives` on the step's gradients (in float32): each leaf's
    int8 error within scale/2 (plus the product's own rounding, an ulp of
    the leaf's largest value), and the buckets' round trip bitwise.  Returns (the
    worst error over scale, buckets)."""
    import torch
    from repro_torch.dist.collectives import bucketize, ef_compress, ef_init
    worst = 0.0
    for name, g in grads.items():
        g = g.float()
        deq, _ = ef_compress({name: g}, ef_init({name: g}))
        amax = float(g.abs().max())
        scale = amax / 127.0 if amax > 0 else 1.0
        err = float((deq[name] - g).abs().max())
        if not err <= scale / 2 + torch.finfo(g.dtype).eps * amax:
            raise AssertionError(f"lm-train: ef_compress on {name}: error "
                                 f"{err:.3e} > scale/2 {scale / 2:.3e}")
        worst = max(worst, err / scale)
        del deq
    buckets, unpack = bucketize(grads, bucket_bytes=64 << 20)
    out = unpack(buckets)
    if not all(torch.equal(out[n], g) for n, g in grads.items()):
        raise AssertionError("lm-train: bucketize did not round-trip")
    n = len(buckets)
    del buckets, out
    return worst, n


def train_accum_check(device, cfg):
    """accum=2 against accum=1 at full width on 2 layers in f32."""
    import torch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import make_train_step
    accum, B, T, bar = LM_TRAIN_ACCUM
    small = dataclasses.replace(cfg, n_layers=2)
    batch = synth_batch(small, 1, 0, B, T)
    models = []
    for a in (1, accum):
        m = build_model(small, torch.float32).init_params(
            torch.Generator(device).manual_seed(LM_SEED))
        opt = AdamW(lr=1e-3, weight_decay=0.0)
        make_train_step(m, opt, accum=a).step_fn(opt.init(m), batch)
        models.append(m)
    d = max(float((p - q).abs().max()) for p, q in
            zip(models[0].parameters(), models[1].parameters()))
    if not d < bar:
        raise AssertionError(f"lm-train: accum={accum} moved the update by "
                             f"{d:.3e} (bar {bar})")
    return d


def train_cpu_check(device):
    """internlm2-1.8b-smoke in f32: the card's three steps against the
    CPU's, from the same weights and batches."""
    import torch
    from repro_torch.configs.archs import get_arch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import make_train_step
    steps, B, T, bar = LM_TRAIN_CPU
    cfg = get_arch(LM_TRAIN_ARCH + "-smoke")
    cpu = build_model(cfg, torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(LM_SEED))
    card = build_model(cfg, torch.float32)
    card.load_state_dict(cpu.state_dict())
    runs = []
    for m in (card, cpu):
        opt = AdamW(lr=cosine_schedule(1e-3, 1, 10))
        plan = make_train_step(m, opt, accum=2)
        st, run = opt.init(m), []
        for s in range(steps):
            st, met = plan.step_fn(st, synth_batch(cfg, 0, s, B, T))
            run.append((float(met["loss"]), float(met["grad_norm"])))
        runs.append(run)
    worst = max(abs(a - b) / abs(b) for ra, rb in zip(*runs)
                for a, b in zip(ra, rb))
    if not worst <= bar:
        raise AssertionError(f"lm-train: the card's steps against the "
                             f"CPU's: {runs} ({worst:.3e} > {bar})")
    return worst


def train_families(device):
    """Every other family's -smoke config, one step on the card: the loss
    and every gradient finite, ce within LM_TRAIN_CE of ln V."""
    import torch
    from repro_torch.configs.archs import get_arch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import make_train_step
    out = {}
    for i, arch in enumerate(LM_TRAIN_FAMILIES):
        cfg = get_arch(arch + "-smoke")
        model = build_model(cfg, torch.float32, remat=True).init_params(
            torch.Generator(device).manual_seed(LM_SEED + i))
        opt = AdamW(lr=1e-3)
        plan = make_train_step(model, opt)
        batch = synth_batch(cfg, 0, 0, 2, 32)
        loss, met, grads = plan.grad_fn(batch)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        _, m = plan.step_fn(opt.init(model), batch)
        ce = float(met["ce"])
        if not (finite and math.isfinite(float(m["loss"]))
                and abs(ce - math.log(cfg.vocab_size)) < LM_TRAIN_CE):
            raise AssertionError(f"lm-train {arch}-smoke: loss {float(loss)}"
                                 f", ce {ce} (ln V "
                                 f"{math.log(cfg.vocab_size):.3f}), "
                                 f"gradients finite {finite}")
        out[arch] = {"loss": float(loss), "ce": ce,
                     "ln_V": math.log(cfg.vocab_size),
                     "aux": float(met["aux"])}
        del model, plan, grads
    return out


def train_resume_check(device):
    """Two steps, a save through `TrainSupervisor`, a restore into a fresh
    model, step 3: bitwise an uninterrupted step 3 (parameters, moments,
    loss, the data cursor), under `torch.use_deterministic_algorithms`.
    Then which ops of the step give other bits run to run without it."""
    import os
    import tempfile
    import torch
    from repro_torch.configs.archs import get_arch
    from repro_torch.data.pipeline import DataPipeline, synth_batch
    from repro_torch.dist.fault import TrainSupervisor
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import (load_params, make_train_step,
                                           train_state)
    cfg = get_arch(LM_TRAIN_ARCH + "-smoke")

    def fresh():
        m = build_model(cfg, torch.float32).init_params(
            torch.Generator(device).manual_seed(LM_SEED))
        opt = AdamW(lr=cosine_schedule(1e-3, 1, 10))
        return m, opt, make_train_step(m, opt, accum=2)

    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            model, opt, plan = fresh()
            st = opt.init(model)
            pipe = DataPipeline(cfg, batch=4, seq_len=64, seed=0)
            sup = TrainSupervisor(tmp, save_every=2, device=device)
            for step in (1, 2):
                st, _ = plan.step_fn(st, next(pipe))
                sup.maybe_save(step, train_state(model, st),
                               {"cursor": pipe.cursor()})
            st, m3 = plan.step_fn(st, next(pipe))
            pipe.close()
            model2, opt2, plan2 = fresh()
            like = train_state(model2, opt2.init(model2))
            step, state, extra = sup.resume_or_init(lambda: like, like)
            load_params(model2, state["params"])
            pipe2 = DataPipeline(cfg, batch=4, seq_len=64, seed=0,
                                 start_step=extra["cursor"])
            st2, m3b = plan2.step_fn(state["opt"], next(pipe2))
            pipe2.close()
        same = (step == 2 and extra["cursor"] == 2
                and torch.equal(m3["loss"], m3b["loss"])
                and all(torch.equal(a, b) for a, b in
                        zip(model.parameters(), model2.parameters()))
                and all(torch.equal(st.mu[n], st2.mu[n])
                        and torch.equal(st.nu[n], st2.nu[n]) for n in st.mu))
        if not same:
            raise AssertionError("lm-train: the resumed step 3 is not "
                                 "bitwise the uninterrupted one")
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    # without the mode: the backward of the embedding lookup (the models'
    # `F.embedding`), of the loss's `take_along_dim`, and the whole step 3
    # from the saved state, each run twice
    g = torch.Generator(device).manual_seed(1)
    toks = synth_batch(cfg, 0, 0, 4, 4096)["tokens"].to(device)
    table = torch.randn(cfg.vocab_padded, 256, generator=g, device=device,
                        requires_grad=True)
    up = torch.randn(*toks.shape, 256, generator=g, device=device)
    logits = torch.randn(*toks.shape, 512, generator=g, device=device,
                         requires_grad=True)

    def twice(fn):
        a, b = fn(), fn()
        return bool(torch.equal(a, b))

    probes = {
        "embedding backward": twice(lambda: torch.autograd.grad(
            (torch.nn.functional.embedding(toks, table) * up).sum(),
            table)[0]),
        "take_along_dim backward (scatter_add)": twice(
            lambda: torch.autograd.grad(torch.take_along_dim(
                logits, (toks % 512)[..., None], dim=-1).sum(), logits)[0]),
    }
    runs = []
    for _ in range(2):
        m, o, p = fresh()
        load_params(m, state["params"])
        s3 = type(state["opt"])(state["opt"].step.clone(),
                                {n: t.clone() for n, t in
                                 state["opt"].mu.items()},
                                {n: t.clone() for n, t in
                                 state["opt"].nu.items()})
        pipe3 = DataPipeline(cfg, batch=4, seq_len=64, seed=0, start_step=2)
        p.step_fn(s3, next(pipe3))
        pipe3.close()
        runs.append([t.detach().clone() for t in m.parameters()])
    probes["the whole step 3"] = all(torch.equal(a, b)
                                     for a, b in zip(*runs))
    return probes


def phase_lm_train(device):
    """LM training on one card through `make_train_step(mesh=None)`:
    lm-internlm2-1.8b-train (full width and depth, bf16, remat, 4 x 4096
    tokens, accum from `pick_accum`) for LM_TRAIN_STEPS steps, every launch
    counter 0 over them (the training path reaches no hand kernel: the
    reference trains on its dense attention core); then the step's
    gradients through `dist.collectives`, the bf16 gradient against f32 on
    the first blocks, accumulation at full width, the card against the
    CPU, one step of every other family, a bitwise resume, and K7's
    refusal to train."""
    import torch
    from repro_torch.configs.archs import get_arch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.flashattn.ops import flash_attention
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import make_train_step, pick_accum
    t0 = time.perf_counter()
    steps_s = {}
    mods = kernel_modules()
    cfg = get_arch(LM_TRAIN_ARCH)
    B, T = LM_TRAIN_BATCH
    accum = pick_accum(cfg, B, T)
    model = build_model(cfg, torch.bfloat16, remat=True).init_params(
        torch.Generator(device).manual_seed(LM_SEED))
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(lr=cosine_schedule(*LM_TRAIN_LR))
    plan = make_train_step(model, opt, accum=accum)
    st = opt.init(model)
    pipe = DataPipeline(cfg, batch=B, seq_len=T, seed=0)
    batches = [next(pipe), next(pipe)]
    pipe.close()
    sync(device)
    steps_s["draw"] = time.perf_counter() - t0
    # ---- the main path --------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    for mod in mods.values():
        mod.launches = 0
    mods["flash_attention"].launches_sm90 = 0
    losses, ces, gnorms, secs = [], [], [], []
    for s in range(LM_TRAIN_STEPS):
        t = time.perf_counter()
        st, m = plan.step_fn(st, batches[s % 2])
        sync(device)
        secs.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if "ce" in m:
            ces.append(float(m["ce"]))
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    launches = {k: mod.launches for k, mod in mods.items()}
    if any(launches.values()):
        raise AssertionError(f"lm-train: hand kernels launched on the "
                             f"training path: {launches}")
    steps_s["main path"] = time.perf_counter() - t0 - sum(steps_s.values())
    # ---- holds ----------------------------------------------------------
    V = cfg.vocab_size
    _, _, grads = plan.grad_fn(batches[0])
    # the first step's ce: with accumulation the step's metrics carry the
    # loss only, which is the ce for the dense family (aux 0)
    first_ce = ces[0] if ces else losses[0]
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    if not (abs(first_ce - math.log(V)) < LM_TRAIN_CE
            and losses[-1] < losses[0] and finite
            and all(map(math.isfinite, losses + gnorms))):
        raise AssertionError(f"lm-train: losses {losses} (ln V "
                             f"{math.log(V):.3f}), grad norms {gnorms}, "
                             f"gradients finite {finite}, step s {secs}, "
                             f"peak {peak_gb:.2f} GB")
    ef_worst, n_buckets = train_collectives(grads)
    del grads
    torch.cuda.empty_cache()
    grad_rel, grad_top = train_rel_grads(
        model, cfg, {k: v[:B // accum] for k, v in batches[0].items()},
        LM_TRAIN_GRAD_BLOCKS)
    # K7 refuses to train: the step refuses the model, the kernel the grad
    model.attn_core = flash_attention
    try:
        plan.step_fn(st, batches[0])
        raise AssertionError("lm-train: a model with attn_core = K7 trained")
    except ValueError:
        pass
    model.attn_core = None
    q = torch.randn(1, 128, 2, 64, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        flash_attention(q, q.detach(), q.detach())
        raise AssertionError("lm-train: K7 took an input needing a gradient")
    except RuntimeError as e:
        if "dense attention core" not in str(e):
            raise
    del plan, st, model, batches
    torch.cuda.empty_cache()
    steps_s["holds"] = time.perf_counter() - t0 - sum(steps_s.values())
    # ---- the smaller checks ---------------------------------------------
    accum_d = train_accum_check(device, cfg)
    cpu_rel = train_cpu_check(device)
    families = train_families(device)
    probes = train_resume_check(device)
    torch.cuda.empty_cache()
    steps_s["checks"] = time.perf_counter() - t0 - sum(steps_s.values())
    step_s = statistics.median(secs[2:])
    flops = train_flops(cfg, B, T)
    row = {"name": "lm-internlm2-1.8b-train", "arch": LM_TRAIN_ARCH,
           "params": n_params, "batch": B, "seq": T, "accum": accum,
           "dtype": "bfloat16", "remat": True, "steps": LM_TRAIN_STEPS,
           "losses": losses, "grad_norms": gnorms, "step_s": secs,
           "median_step_s": step_s, "tokens_per_s": B * T / step_s,
           "peak_gb": peak_gb, "model_flops": flops,
           "peak_share": flops / step_s / PEAK_BF16_TENSOR_FLOPS,
           "launches": launches, "bf16_vs_f32_grad_rel": grad_rel,
           "bf16_vs_f32_grad_top_leaves": grad_top,
           "grad_blocks": LM_TRAIN_GRAD_BLOCKS,
           "ef_worst_err_over_scale": ef_worst, "buckets": n_buckets,
           "accum_max_abs": accum_d, "card_vs_cpu_rel": cpu_rel,
           "families": families, "nondeterministic_bitwise": probes,
           "phase_s": {k: round(v, 1) for k, v in steps_s.items()}}
    print(f"lm-internlm2-1.8b-train: {n_params / 1e9:.3f} B parameters, "
          f"bf16, remat, {B} x {T} tokens a step in {accum} microbatches; "
          f"losses {[round(x, 4) for x in losses]} (ln V "
          f"{math.log(V):.4f}); step {step_s:.3f} s (median of steps 3-"
          f"{LM_TRAIN_STEPS}), {B * T / step_s:.0f} tokens/s, peak "
          f"{peak_gb:.2f} GB, {flops:.4e} model flops a step, "
          f"{row['peak_share']:.3f} of the 989 TFLOP/s bf16 peak; launch "
          f"counters {launches}; bf16 gradient against f32 on the first "
          f"{LM_TRAIN_GRAD_BLOCKS} blocks {grad_rel:.3e} by norm (most in "
          f"{grad_top}); int8 error "
          f"feedback worst {ef_worst:.4f} of a scale, {n_buckets} buckets "
          f"bitwise; accum 2 against 1 on 2 layers {accum_d:.3e}; the card "
          f"against the CPU {cpu_rel:.3e}; families {families}; bitwise "
          f"run to run without deterministic algorithms: {probes}")
    print("lm_train " + json.dumps(row))
    return row


# timed runs a candidate in the autotune phase (after one untimed run):
# kernel/cuda wins by 100-1000x on both rows on an H100, so one run
# decides it (the seconds saved pay for `phase_serve_elastic`)
AUTOTUNE_REPEATS = 1


def phase_autotune(device, N: int = FULL_N):
    """``ensemble="auto"`` (`repro_torch.core.autotune`) on
    lorenz-1M-f32-adaptive and rober-1M-rodas5p: `resolve_auto` tunes each
    into a fresh cache file (each candidate's median printed, the winner,
    the key), a second call is a pure cache hit (no `measure` call), and
    the front door's ``"auto"`` solve, which finds the entry in the same
    file, is bitwise the explicit winner's."""
    import os
    import tempfile
    import torch
    from repro_torch.configs.de_problems import lorenz_ensemble
    from repro_torch.core import autotune as at
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.methods import get_method
    from repro_torch.core.problem import EnsembleProblem
    host = lorenz_ensemble(N, dtype=torch.float32)
    lor = EnsembleProblem(host.prob, N, **dict(zip(
        ("u0s", "ps"), (x.to(device).contiguous()
                        for x in host.materialize()))))
    cases = {
        "lorenz-1M-f32-adaptive": (lor, dict(
            alg="tsit5", t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6,
            saveat=torch.linspace(0.0, 1.0, 5))),
        "rober-1M-rodas5p": (rober_inputs(N, device), dict(
            ROBER_SETTINGS, alg="rodas5p",
            saveat=torch.tensor(ROBER_SAVEAT, dtype=torch.float64))),
    }
    calls = {"n": 0}
    real = at.measure

    def counting(fn, *a, **k):
        calls["n"] += 1
        return real(fn, *a, **k)

    out = {}
    old_env = os.environ.get(at.CACHE_ENV)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "autotune.json")
        os.environ[at.CACHE_ENV] = path
        at.measure = counting
        try:
            for name, (ep, kw) in cases.items():
                spec = get_method(kw["alg"])
                rkw = {k: v for k, v in kw.items() if k != "alg"}
                at.clear_memory_cache()
                t = time.perf_counter()
                dec = at.resolve_auto(ep, spec, device=device,
                                      repeats=AUTOTUNE_REPEATS, **rkw)
                tune_s = time.perf_counter() - t
                n_timed = calls["n"]
                t = time.perf_counter()
                hit = at.resolve_auto(ep, spec, device=device, **rkw)
                hit_s = time.perf_counter() - t
                r_auto = solve_ensemble_local(ep, ensemble="auto",
                                              device=device, **kw)
                if dec.source != "tuned" or hit.source != "cache" or \
                        calls["n"] != n_timed:
                    raise AssertionError(
                        f"autotune {name}: sources {dec.source}, "
                        f"{hit.source}; {calls['n'] - n_timed} timings on "
                        "the cached calls")
                r_exp = solve_ensemble_local(
                    ep, ensemble=dec.strategy, backend=dec.backend,
                    lane_tile=dec.lane_tile, device=device, **kw)
                bitwise = same_run(r_auto, r_exp)
                medians = {label: round(sec * 1e3, 3)
                           for label, sec in dec.timings}
                out[name] = dict(winner=dec.strategy + "/" + dec.backend
                                 + ("" if dec.lane_tile is None
                                    else f"/t{dec.lane_tile}"),
                                 key=dec.key, medians_ms=medians,
                                 tune_s=tune_s, cache_hit_s=hit_s,
                                 timed=n_timed, bitwise=bitwise)
                print(f"autotune {name}: candidates' medians (ms, "
                      f"{AUTOTUNE_REPEATS} timed runs each on "
                      f"{min(N, at.TUNE_MAX_N)} lanes) "
                      + json.dumps(medians) + f"; winner {out[name]['winner']}"
                      f" (tuned in {tune_s:.1f} s, {n_timed} candidates); "
                      f"second call a cache hit in {hit_s * 1e3:.3f} ms; "
                      f"auto bitwise the explicit winner {bitwise}; key "
                      f"{dec.key}")
                calls["n"] = 0
                if not bitwise:
                    raise AssertionError(f"autotune {name}: auto not bitwise "
                                         "the explicit winner")
        finally:
            at.measure = real
            at.clear_memory_cache()
            if old_env is None:
                os.environ.pop(at.CACHE_ENV, None)
            else:
                os.environ[at.CACHE_ENV] = old_env
    return out


# the sharded solve on one card: two ranks over gloo (NCCL refuses two ranks
# on one device), each case held bitwise to the local solve on DIST_N lanes
DIST_N = 2 ** 16
DIST_TIMEOUT_S = 600
DIST_WORKER = r"""
import json, sys, time, traceback
import torch
import torch.distributed as dist
sys.path.insert(0, "src")
from repro_torch.configs import de_problems as dp
from repro_torch.core.api import solve_ensemble
from repro_torch.core.ensemble import solve_ensemble_local
from repro_torch.core.problem import EnsembleProblem
from repro_torch.kernels.em import adaptive as k5
from repro_torch.kernels.em import kernel as k4
from repro_torch.kernels.tsit5 import kernel as k1
from repro_torch.launch.mesh import make_local_group

N, out = int(sys.argv[1]), sys.argv[2]
g = make_local_group("gloo")
rank = dist.get_rank()
dev = torch.device("cuda", 0)
F64 = torch.float64


def lorenz():
    host = dp.lorenz_ensemble(N, dtype=F64)
    u0s, ps = host.materialize()
    return EnsembleProblem(host.prob, N, u0s=u0s.to(dev), ps=ps.to(dev))


def gbm():
    return EnsembleProblem(dp.gbm_problem(r=1.5, v=0.2, dtype=F64), N,
                           u0s=torch.full((N, 3), 0.1, dtype=F64, device=dev),
                           ps=torch.tensor([1.5, 0.2], dtype=F64,
                                           device=dev).expand(N, 2))


def osc():
    prob = dp.forced_oscillator_problem(dtype=F64)
    u0s = torch.stack([prob.u0] * N) * torch.linspace(
        0.5, 1.5, N, dtype=F64)[:, None]
    return EnsembleProblem(prob, N, u0s=u0s.to(dev),
                           ps=torch.stack([prob.p] * N).to(dev))


SDE = dict(alg="em", t0=0.0, tf=1.0, seed=3)
CASES = {
    "K1 lorenz tsit5 adaptive": (k1, lorenz, dict(
        alg="tsit5", t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-8, atol=1e-8,
        saveat=[0.25, 0.5, 1.0])),
    "K1 lorenz tsit5 fixed": (k1, lorenz, dict(
        alg="tsit5", t0=0.0, tf=1.0, dt0=1e-3, adaptive=False,
        save_every=250)),
    "K4 gbm em fixed": (k4, gbm, dict(SDE, dt0=0.025, save_every=40)),
    "K5 gbm em embedded": (k5, gbm, dict(SDE, dt0=0.05, adaptive=True,
                                         rtol=1e-3, atol=1e-5,
                                         error_est="embedded")),
    "K1 osc data adaptive": (k1, osc, dict(
        alg="tsit5", saveat=torch.linspace(0.0, 5.0, 6, dtype=F64),
        dt0=1e-2, rtol=1e-7, atol=1e-7)),
}
FIELDS = ("us", "u_final", "t_final", "naccept", "nreject", "nf", "status",
          "njac", "nfact")
res = {}
for name, (mod, make, kw) in CASES.items():
    t = time.perf_counter()
    try:
        ep = make()
        kw = dict(kw, ensemble="kernel", backend="cuda", device=dev)
        mod.launches = 0
        sharded = solve_ensemble(ep, g, **kw)
        torch.cuda.synchronize()
        launches = mod.launches
        local = solve_ensemble_local(ep, **kw)
        for k in FIELDS:
            a, b = getattr(sharded, k), getattr(local, k)
            if not torch.equal(torch.as_tensor(a).cpu(),
                               torch.as_tensor(b).cpu()):
                raise AssertionError(f"{k} differs from the local solve")
        if sharded.us.device.type != "cuda" or launches < 1:
            raise AssertionError(f"launches {launches} on this rank")
        if mod is not k1:
            half = N // 2
            if torch.equal(sharded.u_final[:half], sharded.u_final[half:]):
                raise AssertionError("the two ranks' paths are the same")
        res[name] = dict(ok=True, launches=launches,
                         s=time.perf_counter() - t)
    except Exception:
        res[name] = dict(ok=False, error=traceback.format_exc(),
                         s=time.perf_counter() - t)
with open(out, "w") as fh:
    json.dump(res, fh)
dist.destroy_process_group()
"""


def phase_distributed(device, N: int = DIST_N):
    """The sharded solve (`repro_torch.core.api.solve_ensemble`) over two
    processes on the one card, a gloo group (NCCL refuses two ranks on one
    device): K1 (Lorenz f64, adaptive and fixed dt), K4 (GBM em, the
    counter stream), K5 (GBM, the em pair) and K1's data form (the forced
    oscillator's table), each on N lanes bitwise the local solve, the two
    ranks' SDE paths distinct, each rank's kernels launched on the card.
    Prints each rank's launches and seconds a case and the phase's wall
    time."""
    import os
    import socket
    import tempfile
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2")
        procs = [subprocess.Popen(
            [sys.executable, "-c", DIST_WORKER, str(N),
             os.path.join(d, f"rank{r}.json")], cwd=str(ROOT),
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        got = []
        for r, p in enumerate(procs):
            path = os.path.join(d, f"rank{r}.json")
            if p.returncode != 0 or not os.path.exists(path):
                raise AssertionError(f"distributed rank {r} exited "
                                     f"{p.returncode}: {logs[r][-3000:]}")
            with open(path) as fh:
                got.append(json.load(fh))
    for name in got[0]:
        per = [g[name] for g in got]
        bad = [f"rank {r}: {x['error']}" for r, x in enumerate(per)
               if not x["ok"]]
        if bad:
            raise AssertionError(f"distributed {name}: " + "\n".join(bad))
        print(f"distributed {name}: {N} lanes over 2 ranks, bitwise the "
              f"local solve; launches a rank {[x['launches'] for x in per]}, "
              f"seconds a rank {[round(x['s'], 2) for x in per]}")
    print(f"distributed: two gloo ranks on one card, {wall:.1f} s wall")
    return {"n": N, "wall_s": wall,
            "cases": {name: [g[name]["launches"] for g in got]
                      for name in got[0]}}


# The serving and elastic layers on the card (`repro_torch.serve`,
# `repro_torch.dist.elastic`): cells serve-mixed-1M and
# elastic-lorenz-rober-256k (PERF.md §4).  Slot pools run the lanes engine;
# the non-resumable requests and one-shot tiles run K3 and K5.
SERVE_WIDTH = 2 ** 16
SERVE_SEGMENT = 64
# (requests, lanes a request) of each traffic class
SERVE_LORENZ = (64, 2 ** 14)      # tsit5 f64, rtol 1e-8, tf over [0.5, 1]
SERVE_GBM = (16, 2 ** 14)         # em f32 fixed dt, n_steps over 100..200
SERVE_ROBER = (8, 2 ** 15)        # rodas5p f64, backend="cuda" (K3)
SERVE_GBM_ADAPTIVE = (4, 2 ** 16)  # em pair f32, backend="cuda" (K5)
# requests of each slot pool held bitwise to their fresh torch-route solve
SERVE_CHECK = 8
ELASTIC_N, ELASTIC_TILE, ELASTIC_SHARDS = 2 ** 18, 2 ** 15, 4
ELASTIC_SEGMENT = 32
ELASTIC_ROBER_TILE = 2 ** 16
ELASTIC_LORENZ = dict(t0=0.0, tf=1.0, dt0=1e-3, rtol=1e-6, atol=1e-6)
SERVE_ROBER_KW = dict(ROBER_SETTINGS, tf=1e2)


def _same_lanes(served, fresh, fields=("u_final", "t_final", "naccept",
                                       "nreject")) -> bool:
    """A served (or elastic) result's `fields` bit for bit a fresh
    solve's."""
    for k in fields:
        a, b = getattr(served, k), getattr(fresh, k)
        b = b.detach().cpu().numpy()
        if not np.array_equal(np.asarray(a), np.broadcast_to(b, np.shape(a))
                              .astype(np.asarray(a).dtype)):
            return False
    return True


def _timed_pumps(classes):
    """Wrap each class's `pump` to sum its seconds by (kind, method);
    returns (seconds dict, restore())."""
    secs = {}
    saved = {cls: cls.pump for cls in classes}

    def wrap(cls, orig):
        def pump(self):
            t = time.perf_counter()
            try:
                return orig(self)
            finally:
                what = (self.spec.name if hasattr(self, "spec")
                        else self.family)
                key = f"{cls.__name__}:{what}"
                secs[key] = secs.get(key, 0.0) + time.perf_counter() - t
        return pump

    for cls, orig in saved.items():
        cls.pump = wrap(cls, orig)

    def restore():
        for cls, orig in saved.items():
            cls.pump = orig
    return secs, restore


def serve_mixed(device):
    """serve-mixed-1M: 92 requests of four classes through one
    `EnsembleService` of slot width 2^16, drained; the gates and the
    figures of `phase_serve_elastic`'s first half."""
    import torch
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.rosenbrock import kernel as k3
    from repro_torch.serve import EnsembleService
    from repro_torch.serve.slots import BatchPool, SlotPool
    f32, f64 = torch.float32, torch.float64

    def split(ep, n_req, n):
        u0s, ps = (x.cpu() for x in ep.materialize())
        return [EnsembleProblem(ep.prob, n, u0s=u0s[i * n:(i + 1) * n],
                                ps=ps[i * n:(i + 1) * n])
                for i in range(n_req)]

    nl, ll = SERVE_LORENZ
    ng, lg = SERVE_GBM
    nr, lr = SERVE_ROBER
    na, la = SERVE_GBM_ADAPTIVE
    lor = split(lorenz_inputs(nl * ll, f64, "cpu"), nl, ll)
    gbm = split(sde_inputs("gbm", ng * lg, f32, "cpu"), ng, lg)
    rob = split(rober_inputs(nr * lr, "cpu"), nr, lr)
    gba = split(sde_inputs("gbm", na * la, f32, "cpu", seed=SEED + 1), na,
                la)
    lor_tf = [0.5 + 0.5 * i / (nl - 1) for i in range(nl)]
    gbm_steps = [100 + round(100 * i / (ng - 1)) for i in range(ng)]
    lkw = dict(alg="tsit5", t0=0.0, dt0=1e-3, rtol=1e-8, atol=1e-8)
    gkw = dict(alg="em", t0=0.0, dt0=1.0 / 200)
    rkw = dict(SERVE_ROBER_KW, alg="rodas5p")
    akw = dict(alg="em", adaptive=True, t0=0.0, tf=ADAPTIVE_FULL["tf"],
               dt0=ADAPTIVE_FULL["dt0"], rtol=ADAPTIVE_FULL["rtol"],
               atol=ADAPTIVE_FULL["atol"])
    svc = EnsembleService(seed=SDE_SEED, max_pending=128,
                          slot_width=SERVE_WIDTH,
                          segment_steps=SERVE_SEGMENT, device=device)
    tickets = {"lorenz": [], "gbm": [], "rober": [], "gbm-adaptive": []}
    secs, restore = _timed_pumps((SlotPool, BatchPool))
    k3.launches = k5.launches = 0
    sync(device)
    t = time.perf_counter()
    try:
        # interleaved arrival: the classes share the service from the
        # start, each spread evenly over the Lorenz requests
        for i in range(nl):
            tickets["lorenz"].append(svc.submit(
                lor[i], tenant="lorenz", tf=lor_tf[i], **lkw))
            if i % (nl // ng) == 0:
                j = i // (nl // ng)
                tickets["gbm"].append(svc.submit(
                    gbm[j], tenant="gbm", tf=gbm_steps[j] / 200,
                    n_steps=gbm_steps[j], **gkw))
            if i % (nl // nr) == 0:
                tickets["rober"].append(svc.submit(
                    rob[i // (nl // nr)], tenant="rober", backend="cuda",
                    **rkw))
            if i % (nl // na) == 0:
                tickets["gbm-adaptive"].append(svc.submit(
                    gba[i // (nl // na)], tenant="gbm-adaptive",
                    backend="cuda", **akw))
        svc.drain()
        sync(device)
    finally:
        restore()
    wall = time.perf_counter() - t
    launches = {"rosenbrock_ensemble": k3.launches,
                "sde_adaptive_ensemble": k5.launches}
    segments = sum(p.segments for p in svc._pools.values()
                   if isinstance(p, SlotPool))
    # ---- gates -------------------------------------------------------------
    bad = [(c, i, tk.error) for c, tks in tickets.items()
           for i, tk in enumerate(tks) if not tk.done or tk.error is not None
           or tk.result is None]
    if bad:
        raise AssertionError(f"serve: tickets failed {bad[:4]}")
    failures = {k: v["failures"] for k, v in svc.accounting.items()}
    if any(failures.values()):
        last = [v["last_error"] for v in svc.accounting.values()]
        raise AssertionError(f"serve: failures {failures}; last errors "
                             f"{last}")
    if device.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"serve: kernel launches {launches}")
    t_check = time.perf_counter()
    step = max(1, nl // SERVE_CHECK)
    checked = {}
    for i in range(0, nl, step)[:SERVE_CHECK]:
        fresh = solve_ensemble_local(lor[i], ensemble="kernel",
                                     backend="torch", tf=lor_tf[i],
                                     device=device, **lkw)
        if not _same_lanes(tickets["lorenz"][i].result, fresh):
            raise AssertionError(f"serve lorenz request {i}: not bitwise its "
                                 "fresh torch-route solve")
    checked["lorenz"] = len(range(0, nl, step)[:SERVE_CHECK])
    step = max(1, ng // SERVE_CHECK)
    for i in range(0, ng, step)[:SERVE_CHECK]:
        n = gbm_steps[i]
        tk = tickets["gbm"][i]
        fresh = solve_ensemble_local(
            gbm[i], ensemble="kernel", backend="torch", tf=n / 200,
            n_steps=n, save_every=n, seed=SDE_SEED,
            lane_offset=tk._req.lane_offset, device=device, **gkw)
        # t_final aside: a fixed-dt fresh solve reports t0 + n_steps dt
        # rounded once, the resumable carry the step times it accumulated,
        # in both packages
        if not _same_lanes(tk.result, fresh, ("u_final", "naccept",
                                              "nreject")):
            raise AssertionError(f"serve gbm request {i}: not bitwise its "
                                 "fresh torch-route solve")
    checked["gbm"] = len(range(0, ng, step)[:SERVE_CHECK])
    for cls, subs, kw in (("rober", rob, rkw), ("gbm-adaptive", gba, akw)):
        for i, tk in enumerate(tickets[cls]):
            extra = (dict(seed=SDE_SEED, lane_offset=tk._req.lane_offset)
                     if cls == "gbm-adaptive" else {})
            fresh = solve_ensemble_local(subs[i], ensemble="kernel",
                                         backend="cuda", device=device,
                                         **kw, **extra)
            if not _same_lanes(tk.result, fresh):
                raise AssertionError(f"serve {cls} request {i}: not bitwise "
                                     "its own fresh backend='cuda' solve")
        checked[cls] = len(tickets[cls])
    check_s = time.perf_counter() - t_check
    n_req = sum(len(v) for v in tickets.values())
    lanes = nl * ll + ng * lg + nr * lr + na * la
    print(f"serve-mixed-1M: {n_req} requests, {lanes} lanes through slot "
          f"width {SERVE_WIDTH}, drained in {wall:.2f} s: "
          f"{n_req / wall:.2f} requests/s, {lanes / wall:.4g} lanes/s, "
          f"{segments} segments; pool seconds "
          + json.dumps({k: round(v, 3) for k, v in secs.items()})
          + f"; launches on the serving path {json.dumps(launches)}")
    print(f"serve-mixed-1M: every ticket done, no error, failures "
          f"{json.dumps(failures)}; bitwise their fresh solves "
          f"{json.dumps(checked)} requests ({check_s:.1f} s)")
    return dict(wall_s=wall, requests=n_req, lanes=lanes,
                requests_per_s=n_req / wall, lanes_per_s=lanes / wall,
                segments=segments, pool_s=secs, launches=launches,
                checked=checked, check_s=check_s)


def elastic_runs(device):
    """elastic-lorenz-rober-256k: Lorenz tsit5 f64 in segment mode (one
    kill, one checkpoint-write crash) and ROBER rodas5p in one-shot mode on
    K3 (one kill), each bitwise its clean run and one local solve."""
    import os
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.dist.chaos import ChaosMonkey
    from repro_torch.dist.elastic import ElasticSupervisor
    from repro_torch.kernels.rosenbrock import kernel as k3
    f64 = torch.float64
    snap = {"s": 0.0, "n": 0, "bytes": 0}
    real_save = ckpt_lib.save

    def timed_save(ckpt_dir, step, tree, **kw):
        t = time.perf_counter()
        out = real_save(ckpt_dir, step, tree, **kw)
        snap["s"] += time.perf_counter() - t
        snap["n"] += 1
        d = os.path.join(ckpt_dir, f"step_{step}")
        snap["bytes"] += sum(os.path.getsize(os.path.join(d, f))
                             for f in os.listdir(d))
        return out

    cases = {
        "lorenz tsit5 segment": (
            lorenz_inputs(ELASTIC_N, f64, "cpu", seed=SEED + 2), "tsit5",
            dict(ELASTIC_LORENZ, tile_width=ELASTIC_TILE,
                 segment_steps=ELASTIC_SEGMENT),
            [(2, 1, "kill"), (2, -1, "ckpt_crash")],
            dict(lane_tile=ELASTIC_TILE, backend="torch")),
        "rober rodas5p one-shot": (
            rober_inputs(ELASTIC_N, "cpu"), "rodas5p",
            dict(SERVE_ROBER_KW, tile_width=ELASTIC_ROBER_TILE,
                 backend="cuda"),
            [(1, 1, "kill")], dict(backend="cuda")),
    }
    out = {}
    ckpt_lib.save = timed_save
    try:
        for name, (ep, alg, kw, schedule, local_kw) in cases.items():
            runs = {}
            k3.launches = 0
            for tag, chaos in (("clean", None),
                               ("chaos", ChaosMonkey(schedule=schedule))):
                with tempfile.TemporaryDirectory() as d:
                    t = time.perf_counter()
                    runs[tag] = ElasticSupervisor(
                        ep, alg, ckpt_dir=d, n_shards=ELASTIC_SHARDS,
                        chaos=chaos, backoff_base=0.0, device=device,
                        **kw).run()
                    runs[tag + "_s"] = time.perf_counter() - t
            launches = k3.launches
            lkw = {k: v for k, v in kw.items()
                   if k not in ("tile_width", "segment_steps", "backend")}
            t = time.perf_counter()
            local = solve_ensemble_local(ep, alg=alg, ensemble="kernel",
                                         device=device, **lkw, **local_kw)
            local_s = time.perf_counter() - t
            rep = runs["chaos"].report
            kinds = sorted(f["kind"] for f in rep["failures"])
            if kinds != sorted(k for _, _, k in schedule):
                raise AssertionError(f"elastic {name}: failures "
                                     f"{rep['failures']}, injected "
                                     f"{schedule}")
            for tag in ("clean", "chaos"):
                r = runs[tag]
                if (r.status != 0).any():
                    raise AssertionError(f"elastic {name} {tag}: status "
                                         f"{np.unique(r.status)}")
                if not _same_lanes(r, local):
                    raise AssertionError(f"elastic {name} {tag}: not bitwise "
                                         "one solve_ensemble_local call")
            if device.type == "cuda" and alg == "rodas5p" and launches < 1:
                raise AssertionError(f"elastic {name}: K3 never launched")
            out[name] = dict(mode=rep["mode"], clean_s=runs["clean_s"],
                             chaos_s=runs["chaos_s"], local_s=local_s,
                             epochs=rep["epochs"], snapshots=rep["snapshots"],
                             reshards=rep["reshards"],
                             failures=rep["failures"], k3_launches=launches)
            print(f"elastic {name}: {ELASTIC_N} lanes, tile "
                  f"{kw['tile_width']}, {ELASTIC_SHARDS} shards, mode "
                  f"{rep['mode']}; clean {runs['clean_s']:.2f} s, with "
                  f"{kinds} {runs['chaos_s']:.2f} s ({rep['epochs']} epochs, "
                  f"{rep['snapshots']} snapshots, {rep['reshards']} "
                  f"re-shards, {rep['restored_tiles']} tiles restored), "
                  f"local solve {local_s:.2f} s; both bitwise the local "
                  f"solve; K3 launches {launches}")
    finally:
        ckpt_lib.save = real_save
    print(f"elastic snapshots: {snap['n']} in {snap['s']:.2f} s, "
          f"{snap['bytes']} bytes ({snap['bytes'] / max(snap['n'], 1):.4g} "
          "bytes a snapshot)")
    out["snapshots"] = snap
    return out


def phase_serve_elastic(device):
    """The serving layer (`EnsembleService`: slot pools on the lanes
    engine, `BatchPool` on K3 and K5) and the elastic supervisor (segment
    mode, and one-shot tiles on K3) on the card; every gate raises."""
    serve = serve_mixed(device)
    elastic = elastic_runs(device)
    return {"serve": serve, "elastic": elastic}


def timed(phase, *args):
    """phase(*args), its seconds kept in PHASE_S under its name."""
    t = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_S[phase.__name__.removeprefix("phase_")] = round(
            time.perf_counter() - t, 1)


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
    prepared = timed(phase_build, device)
    worst, k2_row = timed(phase_parity, device)
    translate = timed(phase_translate, device, prepared)
    rows = timed(phase_full_size, device)
    for r in rows:
        r["parity_f64_rel_err"] = worst
    rows.append(k2_row)
    max_dz = timed(phase_sde_rng, device)
    sde_worst = timed(phase_sde_parity, device, max_dz)
    sde_rows = timed(phase_sde_full_size, device)
    for r in sde_rows:
        r["parity_f64_rel_err"] = sde_worst
    rows += sde_rows
    adaptive = timed(phase_sde_adaptive_parity, device)
    adaptive_rows = timed(phase_sde_adaptive_full_size, device)
    for r in adaptive_rows:
        r["parity_f64"] = adaptive
    rows += adaptive_rows
    stiff = timed(phase_stiff_parity, device)
    lu_rows = timed(phase_lu, device)
    (f_launches, r_launches, one_shot), lu_path = timed(
        phase_array_linsolve_cuda, device)
    for r in lu_rows:
        # the stiff path solves ROBER's 3 x 3 systems: no path launches n = 8
        r["launches"] = 0
        if r["n"] == 3:
            r["launches"] = {"lu_factor": f_launches,
                             "lu_resolve": r_launches}.get(
                                 r["name"].split("[")[0], one_shot)
            r.update(lu_path)
    stiff_rows = timed(phase_stiff_full_size, device)
    for r in stiff_rows:
        r["parity_f64"] = stiff
    rows += stiff_rows + lu_rows
    event_parity = timed(phase_event_parity, device)
    event_rows = (timed(phase_event_ball, device)
                  + timed(phase_event_rober, device)
                  + timed(phase_event_barrier, device))
    for r in event_rows:
        r["parity_f64"] = event_parity
    rows += event_rows
    data_parity = timed(phase_data_parity, device)
    lookup_row = timed(phase_interp_lookup, device)
    data_rows = timed(phase_data_full_size, device)
    for r in data_rows:
        r["parity_f64"] = data_parity
    rows += data_rows + [lookup_row]
    translate_rows = timed(phase_translate_rows, device, rows)
    for r in translate_rows:
        r["parity_f64"] = translate
    rows += translate_rows
    timed(phase_autotune, device)
    timed(phase_distributed, device)
    timed(phase_serve_elastic, device)
    grad = timed(phase_grad_parity, device)
    grad_rows = timed(phase_grad_full_size, device)
    for r in grad_rows:
        r["parity_f64"] = grad
    rows += grad_rows
    timed(phase_population_fit, device)
    flash_parity = timed(phase_flash_parity, device)
    k7_rows = timed(phase_lm_serve, device)
    k7_rows += timed(phase_lm_families, device)
    timed(phase_lm_train, device)
    for r in k7_rows:
        r["parity"] = flash_parity
    rows += k7_rows
    for r in rows:
        if r["name"].startswith(("erk_ensemble", "run_ensemble_kernel_staged",
                                 "rosenbrock_ensemble", "sde_ensemble",
                                 "sde_adaptive_ensemble")):
            r.setdefault("functor", "hand-written")
    print("seconds a phase: " + json.dumps(PHASE_S))
    print("seconds inside them of the fp64 and f32 probes, the register "
          "reports and K6 at 2^16: "
          + json.dumps({k: round(v, 1) for k, v in REPORT_S.items()}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
