"""Independent oracle for the fused-integration kernel: the scalar-mode
reference solver run trajectory by trajectory (a control-flow path apart
from the lanes engine the kernel's plain twin uses)."""
from __future__ import annotations

import torch

from repro_torch.core.solvers import solve_one
from repro_torch.core.tableaus import Tableau


def ref_solve(f, tab: Tableau, u0s, ps, t0, tf, dt0, saveat, rtol, atol,
              adaptive=True, max_iters=100_000):
    """u0s (N,n), ps (N,m) -> (us (N,S,n), uf (N,n), t_final (N,),
    naccept (N,), nreject (N,))."""
    rs = [solve_one(f, tab, u0, p, t0, tf, dt0, saveat=saveat, rtol=rtol,
                    atol=atol, adaptive=adaptive, max_iters=max_iters)
          for u0, p in zip(u0s, ps)]
    stack = lambda name: torch.stack([getattr(r, name) for r in rs])
    return (stack("us"), stack("u_final"), stack("t_final"),
            stack("naccept"), stack("nreject"))
