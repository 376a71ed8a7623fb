#!/usr/bin/env python3
"""Where the contracted tsit5 gradient leaves its bar: the smoke's "tsit5
lorenz" gradient case (`chip_smoke.grad_parity_cases`: 4096 lanes, f64,
rtol = atol = 1e-8, loss sum(us^2) + sum(u_final^2)) on a span and a save
grid of the caller's, on one NVIDIA H100.

    python3 tools/grad_span_probe.py [--spans 0.5,1.0] [--n 4096]
                                     [--out FILE]

For each span [0, tf] (saves at tf/4, tf/2, 3tf/4, tf, as the smoke's
[0, 1] case has them), the probe runs:

  * the forward solve on K1 (`backend="cuda"`) and on its plain version
    (`backend="torch"`), both with ``sensitivity="adjoint"`` (the bound of
    `suggest_adjoint_steps`), and compares their per-lane naccept and
    nreject and outputs;
  * the gradient on both routes (`chip_smoke.grad_run`): the cuda route
    replays the plain version backward at the cotangents of the kernel's
    outputs, the torch route at the replay's own;
  * per lane, the largest gradient difference over the largest gradient
    entry, and whether that lane's counts differ between the kernel and
    its plain version.

It prints, per span, the worst relative gradient difference (the smoke's
GRAD_TORCH_REL measure), the lanes whose counts differ with their counts
and output differences, and the worst gradient difference over the lanes
whose counts agree, and the worst lane's end times, counts, output
differences per save and the plain version's step ends nearest each save;
then one JSON object (also to FILE with --out).  Exits non-zero where CUDA
is absent.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def plain_step_ends(ep, lane, kw, dev):
    """The plain version's accepted step ends of one lane (the lanes loop
    on that lane alone, the same per-lane arithmetic): their count, the
    last one, and each save point minus the step end nearest it (a step
    ending within 1e-7 max(|t|, 1) below a save writes it at theta = 1;
    one ending there below tf ends the lane)."""
    import torch
    from repro_torch.core import solvers
    from repro_torch.core.tableaus import get_tableau
    u0s, ps = ep.materialize()
    ends = []
    orig = solvers._make_adaptive_body

    def hooked(*a, **k):
        body = orig(*a, **k)

        def b(c):
            out = body(c)
            if bool((out["naccept"] > c["naccept"]).all()):
                ends.append(float(out["t"][0]))
            return out
        return b

    solvers._make_adaptive_body = hooked
    try:
        solvers.solve_adaptive(
            ep.prob.f, get_tableau("tsit5"),
            u0s[lane:lane + 1].T.contiguous(),
            ps[lane:lane + 1].T.contiguous(), kw["t0"], kw["tf"], kw["dt0"],
            saveat=torch.tensor(kw["saveat"], dtype=torch.float64,
                                device=dev),
            opts=solvers.AdaptiveOptions(rtol=kw["rtol"], atol=kw["atol"]),
            lanes=True)
    finally:
        solvers._make_adaptive_body = orig
    near = {}
    for s in kw["saveat"]:
        d = min((s - t for t in ends), key=abs)
        near[str(s)] = d
    return dict(n=len(ends), last=ends[-1] if ends else None,
                save_minus_nearest_end=near)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("grad_span_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.sensitivity import suggest_adjoint_steps

    ap = argparse.ArgumentParser()
    ap.add_argument("--spans", default="0.5,1.0")
    ap.add_argument("--n", type=int, default=cs.GRAD_N)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    ep = cs.lorenz_inputs(args.n, torch.float64, dev)
    out = {"gpu": cs.gpu_line(), "n": args.n, "spans": {}}
    for tf in (float(x) for x in args.spans.split(",")):
        kw = dict(alg="tsit5", t0=0.0, tf=tf, dt0=1e-3, rtol=1e-8,
                  atol=1e-8, saveat=[tf / 4, tf / 2, 3 * tf / 4, tf])
        kw["adjoint_steps"] = suggest_adjoint_steps(
            ep, ensemble="kernel", backend="cuda", device=dev, **kw)
        cu = cs.grad_run(ep, kw, ("u0s", "ps"))
        to = cs.grad_run(ep, kw, ("u0s", "ps"), backend="torch")
        rel, _ = cs.grad_diff("probe", cu.grads, to.grads)
        scale = max(float(to.grads[k].abs().max()) for k in to.grads)
        lane_rel = torch.stack([
            (cu.grads[k] - to.grads[k]).abs().amax(dim=1)
            for k in ("u0s", "ps")]).amax(dim=0) / scale
        rk, rt = cu.res, to.res
        moved = ((rk.naccept != rt.naccept) | (rk.nreject != rt.nreject))
        out_diff = torch.maximum(
            (rk.us - rt.us).abs().flatten(1).amax(dim=1),
            (rk.u_final - rt.u_final).abs().amax(dim=1)).detach()
        lanes = moved.nonzero().flatten().tolist()
        same = ~moved
        worst_same = float(lane_rel[same].max()) if bool(same.any()) else 0.0
        rows = [dict(lane=i, kernel=[int(rk.naccept[i]), int(rk.nreject[i])],
                     plain=[int(rt.naccept[i]), int(rt.nreject[i])],
                     out_abs=float(out_diff[i]), grad_rel=float(lane_rel[i]))
                for i in lanes]
        top = torch.topk(lane_rel, min(5, args.n))
        w = int(top.indices[0])
        detail = dict(
            lane=w, t_final=[float(rk.t_final[w]), float(rt.t_final[w])],
            counts=[[int(rk.naccept[w]), int(rk.nreject[w])],
                    [int(rt.naccept[w]), int(rt.nreject[w])]],
            d_us=[float(x) for x in
                  (rk.us[w] - rt.us[w]).abs().amax(dim=1).detach()],
            d_u_final=float((rk.u_final[w] - rt.u_final[w]).abs().max()),
            plain_step_ends=plain_step_ends(ep, w, kw, dev))
        out["spans"][str(tf)] = dict(
            bound=kw["adjoint_steps"], grad_rel=rel, lanes_moved=rows,
            worst_grad_rel_counts_equal=worst_same,
            worst_out_abs_counts_equal=float(out_diff[same].max()),
            top_lanes=[dict(lane=int(i), grad_rel=float(v),
                            moved=bool(moved[i]))
                       for v, i in zip(top.values, top.indices)],
            worst_lane=detail)
        print(f"span [0, {tf}]: bound {kw['adjoint_steps']}, cuda vs torch "
              f"route max rel {rel:.3e}; lanes whose counts differ between "
              f"K1 and its plain version: {len(rows)} {rows[:8]}; worst "
              f"gradient rel over the lanes whose counts agree "
              f"{worst_same:.3e}, their outputs within "
              f"{out['spans'][str(tf)]['worst_out_abs_counts_equal']:.3e}; "
              f"worst lane {json.dumps(detail)}")
    print(out["gpu"])
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
