#!/usr/bin/env python3
"""Rounding check of the fixed-dt SDE kernel on one NVIDIA H100.

    python3 tools/sde_fma_check.py [--n N]

Runs `chip_smoke.py`'s crn-1M-em form (the CRN Table-4 sweep, float32, EM,
t in [0, 100], dt = 0.1, 1000 steps, a save every 100) through the kernel
built twice from `src/repro_torch/csrc/sde_ensemble.cu`: as the port builds
it, where nvcc contracts a multiply and an add into one fma, and with
`--fmad=false`, where every product and sum is rounded on its own, as the
plain PyTorch twin rounds them (its general-noise contraction g·dW too:
the products rounded one by one, then summed left to right, which is how
the kernel writes it).  Each build is held against the twin on the same
inputs and the same counter stream.  Prints, per
comparison, the per-lane error max |a - b| / (1 + |b|) over the lane's
saves and final state (median, 99.9th percentile, maximum), the lanes above
1e-3 and 1e-2, the lanes equal to the twin's bitwise, and the build's
normals against the plain stream; then the card's name and power limit, and
one JSON object with the numbers.
Exits non-zero where CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    ep = cs.sde_inputs("crn", args.n, torch.float32, dev)
    prob, m = ep.prob, ep.prob.noise_dim()
    u0s, ps = ep.materialize()
    u0_l, p_l = u0s.T.contiguous(), ps.T.contiguous()
    kargs = dict(t0=0.0, dt=0.1, n_steps=1000, save_every=100,
                 seed=cs.SDE_SEED, lane_offset=0)

    def twin():
        return cs.lanes_first(K._plain(prob.f, prob.g, "em", prob.noise, m,
                                       u0_l, p_l, table=None, **kargs))

    ref = twin()
    rng_block = (cs.SDE_SEED, 0, 16, m, 8192)
    wp, zp = K._plain_normals(*rng_block, 0, dev)

    base, report = build.NVCC_FLAGS, {}
    for label, extra in (("fma", ()), ("fmad_false", ("--fmad=false",))):
        build.NVCC_FLAGS = base + extra
        build.load.cache_clear()
        K._bind.cache_clear()
        out = cs.lanes_first(K.sde_ensemble(prob.f, prob.g, "em", u0_l, p_l,
                                            noise=prob.noise, m_noise=m,
                                            **kargs))
        wk, zk = K.sde_normals(*rng_block, device=dev)
        torch.cuda.synchronize(dev)
        normals = {"normal_words_differ": int((wk != wp).sum()),
                   "normals_max_diff": float((zk - zp).abs().max())}
        mism, max_abs, e = cs.lane_errors(out, ref)
        same = ((out == ref) | (out.isnan() & ref.isnan())).reshape(
            args.n, -1).all(dim=1)
        report[label] = {
            "median": float(e.median()),
            "q999": float(e.quantile(0.999)), "max": float(e.max()),
            "max_abs": max_abs,
            "lanes_above_1e-3": int((e > 1e-3).sum()),
            "lanes_above_1e-2": int((e > 1e-2).sum()),
            "lanes_bitwise_equal": int(same.sum()),
            "lanes_finite_in_one_only": mism, **normals}
        print(f"{label}: " + json.dumps(report[label]))
    build.NVCC_FLAGS = base
    print(cs.gpu_line())
    print(json.dumps({"n": args.n, "builds": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
