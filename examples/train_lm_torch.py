"""End-to-end LM training on the PyTorch port — the twin of
examples/train_lm.py: data pipeline -> trainer (accum, AdamW, cosine) ->
checkpointing -> restart.

Default preset trains a ~13M-param internlm2-family model for 120 steps
(on the CPU: minutes); --arch selects any zoo member (reduced with
-smoke), and the same path is `python -m repro_torch.launch.train`'s.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 120 \\
        [--device cpu]
    PYTHONPATH=src python examples/train_lm_torch.py --resume  # restart
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs.archs import get_arch
from repro_torch.data.pipeline import DataPipeline
from repro_torch.dist.fault import TrainSupervisor
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import (load_params, make_train_step,
                                       train_state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm_torch"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    # widen the smoke config to ~13M params for a real-ish loss curve
    if args.arch.endswith("-smoke"):
        cfg = dataclasses.replace(cfg, d_model=256, d_ff=1024, n_layers=6,
                                  vocab_size=4096)
    device = torch.device(args.device)
    model = build_model(cfg, dtype=torch.float32, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, 20, args.steps),
                weight_decay=0.01)
    plan = make_train_step(model, opt, mesh=None, accum=args.accum,
                           donate=True)

    sup = TrainSupervisor(args.ckpt_dir, save_every=args.save_every,
                          device=device)
    model.init_params(torch.Generator(device).manual_seed(0))
    state = train_state(model, opt.init(model))
    start_step, state, extra = (sup.resume_or_init(lambda: state, state)
                                if args.resume else (0, state, {}))
    load_params(model, state["params"])
    opt_state = state["opt"]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name}  params={n_params/1e6:.1f}M  "
          f"start_step={start_step}")

    pipe = DataPipeline(cfg, batch=args.batch, seq_len=args.seq,
                        start_step=extra.get("cursor", 0))
    t0 = time.perf_counter()
    losses = []
    for step in range(start_step + 1, args.steps + 1):
        opt_state, m = plan.step_fn(opt_state, next(pipe))
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == 1:
            tok_s = args.batch * args.seq * 10 / max(
                time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.2f}  ~{tok_s:,.0f} tok/s")
        sup.maybe_save(step, train_state(model, opt_state),
                       {"cursor": pipe.cursor()})
    pipe.close()
    print("done. checkpoints in", args.ckpt_dir,
          "(rerun with --resume to continue).")
    return losses


if __name__ == "__main__":
    main()
