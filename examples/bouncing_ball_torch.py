"""Event handling (paper §6.6 / Fig. 8) on the PyTorch port: an ensemble of
bouncing balls with per-trajectory coefficients of restitution, through the
front door with per-lane event detection and root finding on the dense
output.  The twin of examples/bouncing_ball.py.

    PYTHONPATH=src python examples/bouncing_ball_torch.py [--device cpu] [--n 8]

On a CUDA device (the default) the solve runs the explicit-RK kernel's
event form (`backend="cuda"`); with ``--device cpu`` it runs the same
kernel's plain version.
"""
import argparse
import math

import torch

from repro_torch.configs.de_problems import (bouncing_ball_event,
                                             bouncing_ball_problem)
from repro_torch.core import EnsembleProblem, solve_ensemble_local


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8)
    args = ap.parse_args(argv)
    B = args.n
    f64 = torch.float64
    # restitution sweep; kept >= 0.75 so the Zeno accumulation point (total
    # bounce time t1 (1 + 2e / (1 - e))) stays beyond tf, as in the paper's
    # demo regime
    es = torch.linspace(0.75, 0.95, B, dtype=f64)
    ps = torch.stack([torch.full((B,), 9.8, dtype=f64), es], 1)
    u0s = torch.stack([torch.full((B,), 10.0, dtype=f64),
                       torch.zeros(B, dtype=f64)], 1)
    ens = EnsembleProblem(bouncing_ball_problem(), B, u0s=u0s, ps=ps)
    saveat = torch.linspace(0.0, 8.0, 81, dtype=f64)
    res = solve_ensemble_local(ens, alg="tsit5", ensemble="kernel",
                               backend="cuda", t0=0.0, tf=8.0, dt0=1e-3,
                               saveat=saveat, rtol=1e-9, atol=1e-9,
                               max_iters=200_000,
                               event=bouncing_ball_event(),
                               device=args.device)
    t1 = math.sqrt(2 * 10 / 9.8)
    print(f"first impact (analytic): t = {t1:.4f}s  — all lanes share it")
    print("\n  t      " + "  ".join(f"e={float(e):.2f}" for e in es))
    xs = res.us[:, :, 0].T.cpu()            # (S, B) heights
    for i in range(0, len(saveat), 8):
        bar = "  ".join(f"{float(xs[i, j]):6.2f}" for j in range(B))
        print(f"{float(saveat[i]):5.2f}  {bar}")
    print("\nHigher restitution => more bounces survive (paper Fig. 8 "
          "dynamics);\nheights never go negative — events clamp at the "
          "surface.")
    assert float(xs.min()) > -1e-3
    return res


if __name__ == "__main__":
    main()
