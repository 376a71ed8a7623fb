"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``, the counterpart of `repro.launch.train`.

It trains on one device (the card unless ``--device cpu``): the model in
float32, as the reference builds it without a mesh; ``--smoke`` selects
the reduced same-family config.  ``--production-mesh`` (the reference's
16 x 16 mesh) waits for the sharded train plan, ROADMAP queue 1 item 16.
Fault-tolerant by construction: it resumes from the latest checkpoint
under ``--ckpt-dir``, data cursor included (`dist/fault.py`).
"""
from __future__ import annotations

import argparse
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
                                       pick_accum, train_state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=0, help="0 = auto")
    ap.add_argument("--shard-mode", default="fsdp",
                    choices=["fsdp", "zero1", "tp"],
                    help="the sharded plan's layout (with a mesh only)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh (needs the sharded train plan)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh needs the sharded train plan "
            "(models/sharding.py), ROADMAP queue 1 item 16; the port trains "
            "on one device")
    cfg = get_arch(args.arch + ("-smoke" if args.smoke else ""))
    device = torch.device(args.device)
    model = build_model(cfg, dtype=torch.float32, device=device)
    accum = args.accum or pick_accum(cfg, args.batch, args.seq)
    opt = AdamW(lr=cosine_schedule(args.lr, 20, args.steps))
    plan = make_train_step(model, opt, mesh=None, accum=accum, donate=True)

    sup = TrainSupervisor(os.path.join(args.ckpt_dir, cfg.name),
                          save_every=args.save_every, device=device)
    model.init_params(torch.Generator(device).manual_seed(0))
    state = train_state(model, opt.init(model))
    start, state, extra = sup.resume_or_init(lambda: state, state)
    load_params(model, state["params"])
    opt_state = state["opt"]
    pipe = DataPipeline(cfg, batch=args.batch, seq_len=args.seq,
                        start_step=extra.get("cursor", 0))
    print(f"training {cfg.name} from step {start} "
          f"(accum={accum}, shard={args.shard_mode}, mesh=None, "
          f"device={device})")
    m = {}
    for step in range(start + 1, args.steps + 1):
        t0 = time.perf_counter()
        opt_state, m = plan.step_fn(opt_state, next(pipe))
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                  f"{time.perf_counter() - t0:.2f}s/step", flush=True)
        sup.maybe_save(step, train_state(model, opt_state),
                       {"cursor": pipe.cursor()})
    pipe.close()
    return m


if __name__ == "__main__":
    main()
