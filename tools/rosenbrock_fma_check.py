#!/usr/bin/env python3
"""Rounding check of the fused Rosenbrock kernel on one NVIDIA H100.

    python3 tools/rosenbrock_fma_check.py [--n N] [--reps R]

Builds `src/repro_torch/csrc/rosenbrock_ensemble.cu` two ways: as the
port builds it (every add, multiply and divide rounded on its own by the
`_rn` intrinsics, nvcc's default flags otherwise), and with `--fmad=false`
on top, which leaves the `_rn` operations as they are and changes how the
rest, the library's pow above all, is compiled.  Each build runs
`chip_smoke.py`'s f64 stiff parity cases (ROBER with rodas5p, rodas4 and
rosenbrock23, eager and lazy W; OREGO with rodas5p; Van der Pol with
rodas4; N = 4096) against the twin on the same card and prints, per case,
the share of lanes whose step counts equal the twin's, the worst per-lane
error on those lanes and on all lanes, and whether every lane is within
the ROBER bar; then the same on the 2^20-trajectory ROBER forms (rodas5p
eager, rodas4 lazy W) with the lanes not bit-for-bit equal to the twin's,
and each build's kernel time (CUDA events, median of --reps).  Last,
double pow compiled with nvcc's defaults and with `--fmad=false`, against
`torch.pow`, on 2^22 arguments log-uniform over [1e-10, 1e10] at the
controller's exponents; the card's name and power limit; one JSON object
with the numbers.  Exits non-zero where CUDA is absent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "rosenbrock_ensemble.cu"
POW_CU = r"""
#include <cuda_runtime.h>
#include <cmath>
__global__ void pow_kernel(const double* x, double y, int n, double* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pow(x[i], y);
}
extern "C" int pow_launch(const void* x, double y, int n, void* out) {
  pow_kernel<<<(n + 127) / 128, 128>>>(static_cast<const double*>(x), y, n,
                                      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def pow_check(torch, build, dev):
    """Arguments on which nvcc's pow differs from torch.pow, per build."""
    src = build.BUILD_DIR / "pow_check.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(POW_CU)
    x = torch.from_numpy(10.0 ** np.random.default_rng(0).uniform(
        -10, 10, 2 ** 22)).to(dev)
    out = {}
    for label, extra in (("default", ()), ("fmad_false", ("--fmad=false",))):
        lib_path = build.BUILD_DIR / f"pow_check_{label}.so"
        flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
        subprocess.run([build.nvcc(), *flags, *extra, "-o", str(lib_path),
                        str(src)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(lib_path)).pow_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for y in (-0.14, 0.08, -0.175, 0.1, -0.7 / 3, 0.4 / 3):
            got = torch.empty_like(x)
            if fn(x.data_ptr(), y, x.numel(), got.data_ptr()) != 0:
                raise RuntimeError("pow_check launch failed")
            torch.cuda.synchronize(dev)
            out[f"{label} y={y:.6f}"] = int((got != x ** y).sum())
    print("pow against torch.pow, arguments that differ of 2^22: "
          + json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096,
                    help="trajectories of the parity cases (default 4096)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs of each full-size form (default 5)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rosenbrock_fma_check: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core.ensemble import solve_ensemble_local
    from repro_torch.core.tableaus import get_rosenbrock_tableau
    from repro_torch.kernels import build
    from repro_torch.kernels.rosenbrock import kernel as K

    dev = torch.device("cuda", 0)
    cases = cs.stiff_parity_cases(dev, args.n)
    twins = {name: solve_ensemble_local(ep, ensemble="kernel",
                                        backend="torch", linsolve="lanes",
                                        device=dev, **kw)
             for name, ep, kw, _ in cases}
    full = cs.rober_inputs(cs.FULL_N, dev)
    u0s, ps = full.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    sv = torch.tensor(cs.ROBER_SAVEAT, dtype=torch.float64, device=dev)
    forms = {}
    for form, alg, wr in (("rober-1M-rodas5p", "rodas5p", False),
                          ("rober-1M-rodas4-lazyW", "rodas4", True)):
        kw = dict(jac=full.prob.jac, t0=0.0, tf=1e4, dt0=1e-6, rtol=1e-6,
                  atol=1e-8, max_iters=100_000, w_reuse=wr)
        rtab = get_rosenbrock_tableau(alg)
        forms[form] = (rtab, kw, cs.lanes_first(K._plain(
            full.prob.f, rtab, u0_l, p_l, sv, **kw)))

    base, report = build.NVCC_FLAGS, {}
    for label, extra in (("port", ()), ("fmad_false", ("--fmad=false",))):
        build.NVCC_FLAGS = base + extra
        build.load.cache_clear()
        K._bind.cache_clear()
        rows = {}
        for name, ep, kw, _ in cases:
            rk = solve_ensemble_local(ep, ensemble="kernel", backend="cuda",
                                      device=dev, **kw)
            share, worst_same, worst, bar = cs.stiff_metrics(rk, twins[name])
            rows[name] = {"same_counts": share, "worst_same": worst_same,
                          "worst": worst, "all_in_bar": bool(bar.all()),
                          "status": int(rk.status)}
            print(f"{label} {name}: " + json.dumps(rows[name]))
        for form, (rtab, kw, want) in forms.items():
            def kernel():
                return K.rosenbrock_ensemble(full.prob.f, rtab, u0_l, p_l,
                                             sv, **kw)
            got = cs.lanes_first(kernel())
            bitwise = (got == want).reshape(got.shape[0], -1).all(dim=1)
            bar = cs.within_rober_bar(got, want)
            rows[form] = {"lanes_not_bitwise": int((~bitwise).sum()),
                          "lanes_beyond_bar": int((~bar).sum()),
                          "ms": cs.cuda_ms(kernel, args.reps)}
            print(f"{label} {form}: " + json.dumps(rows[form]))
        report[label] = rows
    build.NVCC_FLAGS = base
    build.load.cache_clear()
    K._bind.cache_clear()
    report["pow"] = pow_check(torch, build, dev)
    print(cs.gpu_line())
    print(json.dumps({"n": args.n, "builds": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
