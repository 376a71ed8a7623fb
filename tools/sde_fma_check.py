#!/usr/bin/env python3
"""Rounding check of the fixed-dt SDE kernel on one NVIDIA H100.

    python3 tools/sde_fma_check.py [--case crn|barrier] [--src DIR] [--n N]

Runs one of `chip_smoke.py`'s float32 forms through the kernel built twice
from `src/repro_torch/csrc/sde_ensemble.cu` (or from DIR, another
checkout's `src/repro_torch/csrc`): as the port builds it, where nvcc may
contract a multiply and an add into one fma wherever the source lets it,
and with `--fmad=false`, where every product and sum is rounded on its own,
as the plain PyTorch version rounds them (its general-noise contraction
g·dW too: the products rounded one by one, then summed left to right,
which is how the kernel writes it).  Each build is held against the plain
version on the same inputs and the same counter stream.

  crn      crn-1M-em: the CRN Table-4 sweep, EM, t in [0, 100], dt = 0.1,
           1000 steps, a save every 100 (the no-event form).
  barrier  gbm-1M-em-barrier: GBM, EM, dt = 1/200, 200 steps, with the
           terminal knock-out barrier u0 = 0.18 (the event form).

Prints, per build, the per-lane error max |a - b| / (1 + |b|) over the
lane's saves and final state (median, 99.9th percentile, maximum, the
maximum on the lanes whose step counts agree), the lanes above 1e-3 and
1e-2, the lanes that end at another step, the lanes equal to the plain
version's bitwise, and the build's normals against the plain stream; then
the card's name and power limit, and one JSON object with the numbers.
Exits non-zero where CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def case_inputs(cs, case: str, n: int, dev):
    """(kernel, plain, m): the case's two closures, each returning the
    kernel's four outputs (us, u_final, t_final, stats), and its noise
    dimension."""
    import torch
    from repro_torch.configs import de_problems as dp
    from repro_torch.kernels.em import kernel as K
    if case == "crn":
        ep = cs.sde_inputs("crn", n, torch.float32, dev)
        prob, m = ep.prob, ep.prob.noise_dim()
        u0s, ps = ep.materialize()
        kargs = dict(t0=0.0, dt=0.1, n_steps=1000, save_every=100,
                     seed=cs.SDE_SEED, lane_offset=0)
    else:
        prob, m = dp.gbm_problem(r=1.5, v=0.2, dtype=torch.float32), 3
        u0s = torch.full((n, 3), 0.1, dtype=torch.float32, device=dev)
        ps = torch.tensor([1.5, 0.2], dtype=torch.float32,
                          device=dev).expand(n, 2).contiguous()
        kargs = dict(t0=0.0, dt=1.0 / 200, n_steps=200, save_every=200,
                     seed=cs.SDE_SEED, lane_offset=0,
                     event=dp.gbm_barrier_event())
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()

    def kernel():
        return K.sde_ensemble(prob.f, prob.g, "em", u0_l, p_l,
                              noise=prob.noise, m_noise=m, **kargs)

    def plain():
        return K._plain(prob.f, prob.g, "em", prob.noise, m, u0_l, p_l,
                        table=None, **kargs)

    return kernel, plain, m


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=("crn", "barrier"), default="crn")
    ap.add_argument("--src", type=Path, default=None,
                    help="another checkout's src/repro_torch/csrc to build")
    ap.add_argument("--n", type=int, default=2 ** 20,
                    help="trajectories (default 2^20, the smoke's size)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sde_fma_check: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.em import kernel as K

    dev = torch.device("cuda", 0)
    kernel, plain, m = case_inputs(cs, args.case, args.n, dev)
    ref = plain()
    ref_l = cs.lanes_first(ref)
    rng_block = (cs.SDE_SEED, 0, 16, m, 8192)
    wp, zp = K._plain_normals(*rng_block, 0, dev)

    base, here, report = build.NVCC_FLAGS, build.CSRC, {}
    if args.src is not None:
        build.CSRC = args.src.resolve()
    for label, extra in (("fma", ()), ("fmad_false", ("--fmad=false",))):
        build.NVCC_FLAGS = base + extra
        build.load.cache_clear()
        K._bind.cache_clear()
        K._bind_event.cache_clear()
        raw = kernel()
        out = cs.lanes_first(raw)
        wk, zk = K.sde_normals(*rng_block, device=dev)
        torch.cuda.synchronize(dev)
        normals = {"normal_words_differ": int((wk != wp).sum()),
                   "normals_max_diff": float((zk - zp).abs().max())}
        mism, max_abs, e = cs.lane_errors(out, ref_l)
        same = (raw[3] == ref[3]).all(dim=0)
        # e holds the lanes finite in both, in order
        fin = cs.torch_isfinite_lanes(out) & cs.torch_isfinite_lanes(ref_l)
        bitwise = ((out == ref_l) | (out.isnan() & ref_l.isnan())).reshape(
            args.n, -1).all(dim=1)
        report[label] = {
            "median": float(e.median()),
            "q999": float(e.quantile(0.999)), "max": float(e.max()),
            "max_same_steps": float(e[same[fin]].max()),
            "max_abs": max_abs,
            "lanes_above_1e-3": int((e > 1e-3).sum()),
            "lanes_above_1e-2": int((e > 1e-2).sum()),
            "lanes_other_steps": int((~same).sum()),
            "lanes_bitwise_equal": int(bitwise.sum()),
            "lanes_finite_in_one_only": mism, **normals}
        print(f"{label}: " + json.dumps(report[label]))
    build.NVCC_FLAGS, build.CSRC = base, here
    build.load.cache_clear()
    K._bind.cache_clear()
    K._bind_event.cache_clear()
    print(cs.gpu_line())
    print(json.dumps({"case": args.case, "n": args.n,
                      "src": str(args.src) if args.src else "checkout",
                      "builds": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
