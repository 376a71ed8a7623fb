"""Training step factory: microbatch gradient accumulation, bf16 compute +
f32 optimizer, remat through the model — the counterpart of
`repro.train.trainer` for ``mesh=None`` (one device).

`make_train_step` returns a `TrainPlan` whose ``step_fn(opt_state,
batch) -> (opt_state, metrics)`` runs the model's loss and its gradient
and the AdamW update.  The port's model holds its weights, so the step
writes them in place: that is the port's donation (the reference donates
its params and state to a jit'd step).  The step runs eagerly, in the
reference's order: with ``accum > 1`` the microbatches (the batch's rows
cut into `accum` equal blocks, as the reference's reshape) run one after
another, their gradients summed in float32 buffers and divided by
`accum`, as the reference's scan.

Training runs on the dense attention core: a model with ``attn_core`` set
(K7, which is forward only, as the reference's Pallas kernel) is refused.
A device mesh (the reference's sharded plan on `models/sharding.py`)
waits for ROADMAP queue 1 item 16.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamW, named_params


@dataclasses.dataclass
class TrainPlan:
    """The step, and the loss-and-gradient it takes (``grad_fn(batch) ->
    (loss, metrics, grads)``, grads keyed by parameter name: float32 with
    ``accum > 1``, else in each parameter's dtype).  The reference's plan
    also carries its sharding trees, which a plan without a mesh lacks."""
    step_fn: Callable[..., Any]
    grad_fn: Callable[..., Any]


def pick_accum(cfg: ModelConfig, per_dev_batch: int, seq: int,
               budget_bytes: float = 8e9) -> int:
    """Gradient-accumulation factor so the two dominant per-microbatch
    residents fit the budget:
      * layer-boundary activations remat keeps: L * mb * T * D * 2B
      * full-vocab logits (+grad +exp):       ~3 * mb * T * Vp * 2B
    (the logits term dominates for small-D/large-V archs — gemma3, whisper)."""
    per_mb = (cfg.n_layers * per_dev_batch * seq * cfg.d_model * 2
              + 3 * per_dev_batch * seq * cfg.vocab_padded * 2)
    accum = 1
    while per_mb / accum > budget_bytes and accum < per_dev_batch:
        accum *= 2
    return min(accum, per_dev_batch)


def make_train_step(model, opt: AdamW, mesh: Optional[Any] = None,
                    accum: int = 1, donate: bool = True) -> TrainPlan:
    """The train step of `model` (its weights updated in place) under
    `opt`.  ``mesh`` must be None.  `donate` lets the step write the
    optimizer state it is given in place; without it the step returns a
    new state and leaves the given one as it was."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step runs on one device (mesh=None); a device mesh "
            "(the sharded train plan on models/sharding.py) waits for "
            "ROADMAP queue 1 item 16")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    params = named_params(model)
    device = next(iter(params.values())).device

    def value_and_grad(batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    materialize_grads=True)
        return loss.detach(), metrics, dict(zip(params, grads))

    def grad_fn(batch):
        if getattr(model, "attn_core", None) is not None:
            raise ValueError(
                "make_train_step trains on the dense attention core: set "
                "model.attn_core = None (flash_attention, K7, is forward "
                "only, as the reference's Pallas kernel)")
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        with torch.enable_grad():
            if accum == 1:
                loss, metrics, grads = value_and_grad(batch)
                return loss, {k: v.detach() for k, v in metrics.items()}, \
                    grads
            B = next(iter(batch.values())).shape[0]
            if B % accum:
                raise ValueError(f"batch {B} is not divisible by accum "
                                 f"{accum}")
            mb = B // accum
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=device)
                    for n, p in params.items()}
            lsum = None
            for i in range(accum):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, _, grads = value_and_grad(part)
                for n, g in grads.items():
                    gsum[n] += g.float()
                del grads
                lsum = loss if lsum is None else lsum + loss
            for g in gsum.values():
                g.div_(accum)
            return lsum / accum, {}, gsum

    def step_fn(opt_state, batch):
        loss, metrics, grads = grad_fn(batch)
        _, opt_state, om = opt.update(grads, opt_state, params,
                                      donate=donate)
        return opt_state, {"loss": loss, **metrics, **om}

    return TrainPlan(step_fn, grad_fn)


def train_state(model, opt_state):
    """The checkpointable training state: the model's parameters by name
    (detached views: a save copies them to the host) and the optimizer
    state."""
    return {"params": {n: p.detach() for n, p in model.named_parameters()},
            "opt": opt_state}


@torch.no_grad()
def load_params(model, params):
    """Copy parameters keyed by name (a restored `train_state`'s) into
    `model`."""
    for n, p in model.named_parameters():
        p.copy_(params[n])
