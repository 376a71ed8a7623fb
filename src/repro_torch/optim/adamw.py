"""AdamW + global-norm clip + LR schedules — the counterpart of
`repro.optim.adamw`.

The reference's semantics, on tensors: the optimizer state (`mu`, `nu`) is
float32 whatever the parameters' dtype, the update math is float32
(float64 parameters too: they are read as float32, as the reference's
``p.astype(float32)``), and each parameter is cast back to its own dtype.
This is not `torch.optim.AdamW`, which keeps bfloat16 state for bfloat16
parameters and applies the decay in another form.

Parameters, gradients and the state are dicts keyed by parameter name
(`dict(model.named_parameters())`), so the state follows the model's
layout; `repro_torch.convert.adamw_state` carries the reference's state
across.  `update` writes the parameters in place (the port's model holds
its weights; in-place is its donation) and the state in place too unless
told not to.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Union

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    mu: Tensors          # float32, one a parameter
    nu: Tensors          # float32, one a parameter


def named_params(params) -> Tensors:
    """`params` as a dict name -> tensor: a module's named parameters, or
    the dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]]  # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero float32 moments shaped as `params` (a module or a dict),
        step 0, on the parameters' device."""
        params = named_params(params)
        z = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
        device = next(iter(params.values())).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          z, {n: t.clone() for n, t in z.items()})

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, donate: bool = True):
        """One step: returns (params, new state, metrics {grad_norm (before
        clipping), lr}).  `params` (a module or a dict) is written in place;
        the state too with `donate`, else the new state is a copy."""
        params = named_params(params)
        if not donate:
            state = AdamWState(state.step.clone(),
                               {n: t.clone() for n, t in state.mu.items()},
                               {n: t.clone() for n, t in state.nu.items()})
        gnorm = global_norm(grads[n] for n in params)
        scale = (torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
                 if self.clip_norm else 1.0)
        step = state.step + 1
        b1c = 1.0 - torch.pow(self.b1, step.float())
        b2c = 1.0 - torch.pow(self.b2, step.float())
        lr = self._lr(step)
        for name, p in params.items():
            m, v = state.mu[name], state.nu[name]
            g = grads[name].float() * scale
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * (1 - self.b2) * g)
            del g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        state.step.copy_(step)
        return params, state, {"grad_norm": gnorm, "lr": lr}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32, the leaves
    summed one after another as the reference's Python `sum`."""
    total = None
    for x in tensors:
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """step (a tensor) -> lr, float32: linear warm-up to `peak_lr` over
    `warmup` steps, then a cosine down to ``floor_frac * peak_lr`` at
    `total`."""
    def lr(step):
        s = step.float()
        warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return torch.where(s < warmup, warm, peak_lr * cos)

    return lr
