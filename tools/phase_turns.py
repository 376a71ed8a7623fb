#!/usr/bin/env python3
"""Seconds of `chip_smoke.py` phases as another commit's chip_smoke.py
runs them and as this checkout's does, in turns (parent, change, change,
parent), after one `phase_build` of this checkout, on one NVIDIA H100:
what a cut to a phase saves, measured in one call.

    mkdir -p build/parent && git show <commit>:chip_smoke.py \\
        > build/parent/chip_smoke.py
    python3 tools/phase_turns.py --parent build/parent/chip_smoke.py \\
        [--phases full_size,sde_full_size,sde_adaptive_full_size,stiff_full_size,data_full_size]

Both scripts drive this checkout's `src/repro_torch` (the parent's phases
run on it: compare phases whose port code the change left alone).  Prints
the card's name and power limit, then a line ``TURNS {phase: {parent:
[s, s], change: [s, s]}}`` after each turn.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--phases", default="full_size,sde_full_size,"
                    "sde_adaptive_full_size,stiff_full_size,data_full_size")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("phase_turns: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    spec = importlib.util.spec_from_file_location("parent_smoke",
                                                  args.parent)
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    cs.phase_build(dev)
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    # what phase_build measured, for the parent's rows too
    for name in ("FP64_FAST", "F32_FAST", "BUILD_LOGS"):
        getattr(ps, name).update(getattr(cs, name))
    out = {}
    for label, mod in (("parent", ps), ("change", cs), ("change", cs),
                       ("parent", ps)):
        for ph in args.phases.split(","):
            t = time.perf_counter()
            getattr(mod, "phase_" + ph)(dev)
            out.setdefault(ph, {}).setdefault(label, []).append(
                round(time.perf_counter() - t, 1))
            torch.cuda.empty_cache()
        print("TURNS " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
