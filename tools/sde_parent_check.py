#!/usr/bin/env python3
"""Holds the fixed-dt SDE kernel bit for bit to an earlier build of it, on
one NVIDIA H100.

    python3 tools/sde_parent_check.py --parent DIR [--n N]

DIR holds another checkout's `src/repro_torch/csrc` (for example the parent
commit's, unpacked with `git archive <commit> src/repro_torch/csrc`).  The
tool builds `sde_ensemble.cu` from DIR and from this checkout, runs both
builds on the same inputs (GBM with every stepper, the CRN sweep with em
and heun_strat; float32 and float64; the counter stream and a noise table;
N trajectories, `chip_smoke.py`'s full-size step counts) and prints, per
case, whether us, u_final, t_final and the stats are bitwise equal, then
the card's name and power limit and one JSON object.  Exits non-zero where
CUDA is absent or any case differs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the earlier checkout's src/repro_torch/csrc")
    ap.add_argument("--n", type=int, default=2 ** 16,
                    help="trajectories per case (default 2^16)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sde_parent_check: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.em import kernel as K

    dev = torch.device("cuda", 0)
    cases = [("gbm", alg, 200, 200) for alg in ("em", "heun_strat",
                                                 "platen_w2", "milstein")]
    cases += [("crn", alg, 1000, 100) for alg in ("em", "heun_strat")]

    def run_all():
        outs = {}
        for dtype in (torch.float32, torch.float64):
            for name, alg, n_steps, save_every in cases:
                ep = cs.sde_inputs(name, args.n, dtype, dev)
                prob, m = ep.prob, ep.prob.noise_dim()
                u0s, ps = ep.materialize()
                dt = 1.0 / 200 if name == "gbm" else 0.1
                gen = torch.Generator().manual_seed(cs.SEED)
                table = torch.randn((n_steps, m, args.n), generator=gen,
                                    dtype=dtype).to(dev)
                for src in ("rng", "table"):
                    outs[(str(dtype)[6:], name, alg, src)] = K.sde_ensemble(
                        prob.f, prob.g, alg, u0s.T.contiguous(),
                        ps.T.contiguous(), noise=prob.noise, m_noise=m,
                        t0=0.0, dt=dt, n_steps=n_steps,
                        save_every=save_every, seed=cs.SDE_SEED,
                        table=table if src == "table" else None)
        torch.cuda.synchronize(dev)
        return outs

    here = build.CSRC
    results = {}
    for label, csrc in (("parent", args.parent.resolve()), ("this", here)):
        build.CSRC = csrc
        build.load.cache_clear()
        K._bind.cache_clear()
        results[label] = run_all()
    build.CSRC = here
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
    print(cs.gpu_line())
    print(json.dumps({"n": args.n, "bitwise_equal": report, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
