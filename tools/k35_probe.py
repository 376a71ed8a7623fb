#!/usr/bin/env python3
"""Measures the adaptive ensemble kernels K3 (stiff Rosenbrock) and K5
(adaptive SDE) on their million-trajectory rows, on one NVIDIA H100.

    python3 tools/k35_probe.py [--n N] [--variants 96:0,128:0,256:0,128:4]
    python3 tools/k35_probe.py --variants none

For each variant `B:M` the tool copies this checkout's `src/repro_torch/
csrc` into `build/k35_probe/`, sets the kernels' block size to B threads
(`constexpr int kBlock`) and, for M > 0, their launch bounds to
`__launch_bounds__(kBlock, M)` (a register cap of 65536 / (B·M)), and
builds `rosenbrock_ensemble.cu` and `sde_adaptive_ensemble.cu`, every nvcc
started together.  Then, per row of `chip_smoke.py` (`K35_KEYS`:
rober-1M-rodas5p, -rodas4-eager, -rodas4-lazyW, -rodas5p-event,
osc-1M-rosenbrock23-data; gbm-1M-em-adaptive, -doubling, -barrier,
gbm-rate-1M-em-adaptive), it prints:

- the SIMT efficiency Σ attempts / Σ over warps of 32·max attempts, from
  the kernel's own stats on all N lanes, warps of 32 consecutive lanes
  (`repro_torch.kernels.queue.simt_efficiency`);
- the instantiation's registers and spills (nvcc -Xptxas=-v), its FP64-pipe
  and MUFU instructions in the SASS, and its occupancy in blocks and warps
  a scheduler, from the driver's `cuOccupancyMaxActiveBlocksPerMultiprocessor`
  on the built cubin;
- the kernel's ms in each variant (CUDA events, median of `--reps`);

and the FP64-pipe instructions on the fast path of one f64 division, sqrt
and pow (`chip_smoke.fp64_fast_paths`).  With `--variants none` it
measures the checkout's kernels as they are built (no copies, no
occupancy).  Then the card's name and power limit and one JSON object.
Exits non-zero where CUDA is absent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("rosenbrock_ensemble.cu", "sde_adaptive_ensemble.cu")
BODIES = {"rosenbrock_ensemble.cu": "rosenbrock_body.cuh",
          "sde_adaptive_ensemble.cu": "sde_adaptive_body.cuh"}


def cuobjdump() -> str:
    from repro_torch.kernels.build import nvcc
    return str(Path(nvcc()).with_name("cuobjdump"))


class Occupancy:
    """cuOccupancyMaxActiveBlocksPerMultiprocessor on a library's cubins,
    through the driver API (the runtime's primary context is current)."""

    def __init__(self):
        self.cu = ctypes.CDLL("libcuda.so.1")
        self.modules = {}

    def _modules(self, lib: Path):
        if lib not in self.modules:
            tmp = Path(tempfile.mkdtemp(dir=lib.parent))
            subprocess.run([cuobjdump(), "-xelf", "all", str(lib)], cwd=tmp,
                           check=True, capture_output=True, timeout=300)
            mods = []
            for cubin in sorted(tmp.glob("*.cubin")):
                mod = ctypes.c_void_p()
                if self.cu.cuModuleLoad(ctypes.byref(mod),
                                        str(cubin).encode()) == 0:
                    mods.append(mod)
            shutil.rmtree(tmp, ignore_errors=True)
            self.modules[lib] = mods
        return self.modules[lib]

    def blocks(self, lib: Path, name: str, block: int) -> int:
        for mod in self._modules(lib):
            fn = ctypes.c_void_p()
            if self.cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                           name.encode()):
                continue
            nb = ctypes.c_int()
            rc = self.cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                ctypes.byref(nb), fn, ctypes.c_int(block),
                ctypes.c_size_t(0))
            if rc:
                raise RuntimeError(f"cuOccupancyMaxActiveBlocksPer"
                                   f"Multiprocessor: {rc}")
            return nb.value
        raise RuntimeError(f"{name} is in no cubin of {lib.name}")


def variant_dir(block: int, minb: int) -> Path:
    from repro_torch.kernels import build
    d = build.BUILD_DIR.parent / "k35_probe" / f"b{block}m{minb}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", d)
    for src in SOURCES:
        # the kernels' bodies (block size and launch bounds) are in headers
        p = d / BODIES[src]
        text, k = re.subn(r"constexpr int kBlock = \d+;",
                          f"constexpr int kBlock = {block};", p.read_text())
        if k != 1:
            raise AssertionError(f"{src}: {k} kBlock definitions")
        if minb:
            text, k = re.subn(r"__launch_bounds__\(kBlock\)",
                              f"__launch_bounds__(kBlock, {minb})", text)
            if k < 1:
                raise AssertionError(f"{src}: no __launch_bounds__(kBlock)")
        p.write_text(text)
    return d


def build_all(variants):
    """{(variant, source): (library, ptxas report)} and {variant: csrc},
    every nvcc process started together."""
    from repro_torch.kernels import build
    procs, dirs = {}, {}
    for v in variants:
        build.CSRC = dirs[v] = variant_dir(*v)
        for src in SOURCES:
            lib = build.library_path(src)
            lib.parent.mkdir(parents=True, exist_ok=True)
            procs[(v, src)] = (lib, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(build.CSRC / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        out[key] = (lib, log)
    return out, dirs


def rows(cs, dev, N):
    """{row: kernel()} calling the wrappers on the smoke's inputs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.convert import ensemble_problem
    from repro_torch.core.problem import EnsembleProblem
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.rosenbrock import kernel as k3

    out = {}
    ep = cs.rober_inputs(N, dev)
    u0, p = (x.T.contiguous() for x in ep.materialize())
    sv = torch.tensor(cs.ROBER_SAVEAT, dtype=torch.float64, device=dev)
    for row, alg, wr, ev in (
            ("rober-1M-rodas5p", "rodas5p", False, None),
            ("rober-1M-rodas4-eager", "rodas4", False, None),
            ("rober-1M-rodas4-lazyW", "rodas4", True, None),
            ("rober-1M-rodas5p-event", "rodas5p", False,
             dp.rober_half_event())):
        kargs = dict(jac=ep.prob.jac, t0=0.0, tf=1e4, dt0=1e-6, rtol=1e-6,
                     atol=1e-8, max_iters=100_000, w_reuse=wr, event=ev)
        out[row] = (lambda rtab=get_rosenbrock_tableau(alg), kargs=kargs:
                    k3.rosenbrock_ensemble(ep.prob.f, rtab, u0, p, sv,
                                           **kargs))
    big = dp.forced_oscillator_problem()
    osc = cs.osc_inputs(N, dev, torch.float64, prob=dataclasses.replace(
        big, tspan=(0.0, 3.0)), p=(50.0, 2.0))
    out["osc-1M-rosenbrock23-data"] = cs._data_kernel_fns(
        "osc-1M-rosenbrock23-data", osc,
        dict(cs.OSC_STIFF_ROW, alg="rosenbrock23"), 1)[0]

    f32 = torch.float32
    prob = dp.gbm_problem(r=1.5, v=0.2, dtype=f32)
    gbm = EnsembleProblem(
        prob, N, u0s=torch.full((N, 3), 0.1, dtype=f32, device=dev),
        ps=torch.tensor([1.5, 0.2], dtype=f32,
                        device=dev).expand(N, 2).contiguous())
    gu0, gp = (x.T.contiguous() for x in gbm.materialize())
    cfg = dict(cs.ADAPTIVE_FULL)
    depth, seed = cfg.pop("depth"), cfg.pop("seed")
    saveat = torch.tensor(cfg.pop("saveat"), dtype=f32, device=dev)
    for row, est, ev in (("gbm-1M-em-adaptive", "embedded", None),
                         ("gbm-1M-em-adaptive-doubling", "doubling", None),
                         ("gbm-1M-em-adaptive-barrier", "embedded",
                          dp.gbm_barrier_event())):
        args = dict(cs.adaptive_args("em", est, "diagonal", 3, seed=seed,
                                     depth=depth, **cfg), event=ev)
        out[row] = (lambda args=args: k5.sde_adaptive_ensemble(
            prob.f, prob.g, "em", gu0, gp, saveat, **args))
    rate = ensemble_problem(dp.gbm_rate_problem(dtype=f32), np.ones((N, 1)),
                            np.full((N, 1), 0.2), device=dev, dtype=f32)
    out["gbm-rate-1M-em-adaptive"] = cs._data_kernel_fns(
        "gbm-rate-1M-em-adaptive", rate,
        dict(cs.RATE_ADAPTIVE, alg="em", error_est="embedded"), 1)[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="96:0,128:0,256:0,128:4",
                    help="comma-separated block:minBlocksPerSM (0: none), "
                         "or 'none': the checkout's kernels as they are")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k35_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.em import adaptive as k5
    from repro_torch.kernels.queue import simt_efficiency
    from repro_torch.kernels.rosenbrock import kernel as k3

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    here = build.CSRC
    if args.variants == "none":
        variants = [None]
        for src in SOURCES:
            build.library_path(src).unlink(missing_ok=True)
        logs = build.build(list(SOURCES))
        libs = {(None, src): (build.library_path(src), logs[src])
                for src in SOURCES}
        dirs = {None: here}
    else:
        variants = [tuple(int(x) for x in v.split(":"))
                    for v in args.variants.split(",")]
        libs, dirs = build_all(variants)
    fast = cs.fp64_fast_paths()
    print("fp64 fast paths (FP64-pipe instructions, MUFU, all up to EXIT): "
          + json.dumps(fast))
    occ = Occupancy()
    funcs = {key: cs.sass_listings(lib) for key, (lib, _) in libs.items()}
    fns = rows(cs, dev, args.n)
    report = {"fp64_fast_path": fast, "rows": {}}
    for row, keys in cs.K35_KEYS.items():
        src = SOURCES[0] if keys[0].startswith("rosenbrock") else SOURCES[1]
        entry = {"variants": {}}
        for v in variants:
            lib, log = libs[(v, src)]
            build.CSRC = dirs[v]
            build.load.cache_clear()
            for b in (k3._bind, k5._bind):
                b.cache_clear()
            names = [f for f in funcs[(v, src)] if all(k in f for k in keys)]
            if len(names) != 1:
                raise AssertionError(f"{len(names)} kernels match {keys}")
            ops = [r[2] for r in funcs[(v, src)][names[0]]]
            got = {"ptxas": cs.ptxas_entry(log, keys),
                   "fp64_pipe_instructions": sum(ops.count(o)
                                                 for o in cs.FP64_PIPE),
                   "mufu": ops.count("MUFU")}
            res = fns[row]()
            torch.cuda.synchronize(dev)
            st = res[3].long()
            got["simt_efficiency"] = simt_efficiency(st[0] + st[1])
            got["ms"] = cs.cuda_ms(fns[row], args.reps)
            label, occ_text = "as built", ""
            if v is not None:
                label = f"{v[0]}:{v[1]}"
                nb = occ.blocks(lib, names[0], v[0])
                got["blocks_per_sm"] = nb
                got["warps_per_scheduler"] = nb * (v[0] // 32) / 4
                occ_text = (f", {nb} blocks/SM = "
                            f"{got['warps_per_scheduler']:g} warps a "
                            "scheduler")
            entry["variants"][label] = got
            entry["attempts"] = int((st[0] + st[1]).sum())
            print(f"{row} [{label}]: {got['ms']:.3f} ms, SIMT efficiency "
                  f"{got['simt_efficiency']:.4f}, {got['ptxas']}{occ_text}; "
                  f"SASS FP64-pipe {got['fp64_pipe_instructions']}, MUFU "
                  f"{got['mufu']}", flush=True)
            del res
        report["rows"][row] = entry
    build.CSRC = here
    print(cs.gpu_line())
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
