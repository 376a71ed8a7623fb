#!/usr/bin/env python3
"""Probes of the LM training path on one NVIDIA H100 (the port only),
each printing the card's name and power limit first:

    python3 tools/train_probe.py --what phase,lr,profile,embed

``phase``: `chip_smoke.phase_lm_train` alone (it needs no kernel build),
with its seconds.  ``lr``: six steps of internlm2-1.8b at full width
(remat, 4 x 4096 tokens, 2 microbatches, `chip_smoke`'s two batches in
turns) at a constant learning rate, f32 at 1e-3 and bf16 at 1e-4: the
losses, grad norms and seconds of each step, and the peak memory.
``profile``: one step of lm-internlm2-1.8b-train (after two warm-up
steps) under `torch.profiler`: its wall time and the 40 largest device
times by op and kernel (ops and their kernels both listed).  ``embed``:
a bf16 embedding table's gradient on the smoke's Zipf tokens through
indexing (``table[tokens]``) and through `F.embedding`, each against
f64 by relative norm, and whether each is bitwise run to run.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def model_and_plan(cfg, dtype, lr):
    import torch
    import chip_smoke as cs
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import make_train_step, pick_accum
    B, T = cs.LM_TRAIN_BATCH
    model = build_model(cfg, dtype, remat=True).init_params(
        torch.Generator("cuda").manual_seed(cs.LM_SEED))
    # a constant rate as tests/test_trainer.py's _setup; a schedule as
    # the reference's launcher (its default decay and clipping)
    opt = (AdamW(lr=lr, weight_decay=0.0) if isinstance(lr, float)
           else AdamW(lr=lr))
    return model, opt, make_train_step(model, opt,
                                       accum=pick_accum(cfg, B, T))


def batches(cfg):
    import chip_smoke as cs
    from repro_torch.data.pipeline import synth_batch
    B, T = cs.LM_TRAIN_BATCH
    return [synth_batch(cfg, 0, s, B, T) for s in range(2)]


def what_lr():
    import torch
    from repro_torch.configs.archs import get_arch
    cfg = get_arch("internlm2-1.8b")
    data = batches(cfg)
    for dtype, lr in ((torch.float32, 1e-3), (torch.bfloat16, 1e-4)):
        model, opt, plan = model_and_plan(cfg, dtype, lr)
        st, out = opt.init(model), []
        for s in range(6):
            t = time.perf_counter()
            st, m = plan.step_fn(st, data[s % 2])
            torch.cuda.synchronize()
            out.append((round(float(m["loss"]), 4),
                        round(float(m["grad_norm"]), 2),
                        round(time.perf_counter() - t, 3)))
        print(dtype, lr, out, f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
        del model, plan, st
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def what_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.configs.archs import get_arch
    from repro_torch.optim.adamw import cosine_schedule
    cfg = get_arch(cs.LM_TRAIN_ARCH)
    model, opt, plan = model_and_plan(cfg, torch.bfloat16,
                                      cosine_schedule(*cs.LM_TRAIN_LR))
    st, batch = opt.init(model), batches(cfg)[0]
    for _ in range(2):
        st, _ = plan.step_fn(st, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        st, _ = plan.step_fn(st, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    print(f"step wall {wall * 1e3:.1f} ms (ops and their kernels both "
          f"listed: their device times overlap)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:40]:
        print(f"{e.self_device_time_total / 1e3:10.1f} ms  {e.count:6d}  "
              f"{e.key[:110]}")


def what_embed():
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.archs import get_arch
    from repro_torch.data.pipeline import synth_batch
    cfg = get_arch("internlm2-1.8b")
    toks = synth_batch(cfg, 0, 0, 2, 4096)["tokens"].cuda()
    up = torch.randn(*toks.shape, cfg.d_model, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))

    def grads(dtype, how):
        w = torch.zeros(cfg.vocab_padded, cfg.d_model, dtype=dtype,
                        device="cuda", requires_grad=True)
        x = w[toks] if how == "index" else F.embedding(toks, w)
        (x * up.to(dtype)).sum().backward()
        return w.grad.double()

    ref = grads(torch.float64, "index")
    for how in ("index", "embedding"):
        got = grads(torch.bfloat16, how)
        again = grads(torch.bfloat16, how)
        print(how, "rel", float((got - ref).norm() / ref.norm()),
              "row 0 rel", float((got[0] - ref[0]).norm() / ref[0].norm()),
              "bitwise run to run", bool(torch.equal(got, again)))


def what_phase():
    import torch
    import chip_smoke as cs
    t = time.perf_counter()
    cs.phase_lm_train(torch.device("cuda", 0))
    print(f"phase {time.perf_counter() - t:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="phase")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for w in args.what.split(","):
        {"phase": what_phase, "lr": what_lr, "profile": what_profile,
         "embed": what_embed}[w]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
