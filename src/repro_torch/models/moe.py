"""Mixture-of-Experts FFN: grouped capacity-based top-k routing + always-on
shared experts — the counterpart of `repro.models.moe`.

Covers both MoE architectures of the zoo:
  grok-1        — 8 experts, top-2, no shared experts (expert d_ff 32768).
  deepseek-moe  — 64 fine-grained routed experts top-6 + 2 shared experts
                  (expert d_ff 1408).

The function is the reference's: tokens are processed in groups of
`group_size`; within a group each token's top-k experts give it a slot,
ranked token-major then by k-slot, up to capacity
C = int(g·topk/E · cf) (C = g when the factor is None: no drops); a slot
≥ C drops that (token, expert) pair.  The router runs in float32 whatever
the model's dtype and returns the Switch load-balance aux loss over the
routing before drops.

The reference moves tokens with one-hot (G, g, E, C) dispatch and combine
tensors (4.3 GB a group of 4096 tokens at deepseek's width with no drops);
here the kept (token, expert) pairs are sorted by expert, each expert
that holds tokens runs its FFN on the rows it was given, and each token
sums its k weighted outputs.  An empty slot adds an exact zero in the
reference, so the sum is the same function.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import NORMAL, draw


def moe_spec(D, F_, n_experts, n_shared, dtype):
    """The router (D, E) in float32, the expert stacks (E, D, F) and
    (E, F, D), and the shared experts' (S, …), each drawn at
    N(0, 1/shape[-2])."""
    def stack(shape):
        return (shape, dtype, ("normal", 1.0 / math.sqrt(shape[-2])))

    spec = {"router": ((D, n_experts), torch.float32, NORMAL),
            "wi": stack((n_experts, D, F_)),
            "wg": stack((n_experts, D, F_)),
            "wo": stack((n_experts, F_, D))}
    if n_shared:
        spec.update(s_wi=stack((n_shared, D, F_)),
                    s_wg=stack((n_shared, D, F_)),
                    s_wo=stack((n_shared, F_, D)))
    return spec


def moe_params(generator, D, F_, n_experts, n_shared, dtype, device=None):
    return draw(generator, moe_spec(D, F_, n_experts, n_shared, dtype), device)


class Routing(NamedTuple):
    """One call's routing, groups flattened token-major: probs (N, E)
    float32, the renormalised top-k weights topv (N, k) float32, the chosen
    experts topi (N, k), each pair's slot in its expert's queue (N, k), the
    capacity keep mask (N, k) and the capacity C."""
    probs: torch.Tensor
    topv: torch.Tensor
    topi: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def moe_route(x, router, *, topk: int, n_experts: int,
              capacity_factor=1.25, group_size: int = 4096) -> Routing:
    """The reference's routing (`moe.py:57-79`) of x (B, T, D)."""
    B, T, D = x.shape
    N = B * T
    g = min(group_size, N)
    if N % g:
        raise ValueError(f"tokens {N} not divisible by MoE group size {g}")
    G = N // g
    E = n_experts
    if capacity_factor is None:
        C = g
    else:
        C = max(1, int((g * topk / E) * capacity_factor))
    logits = x.reshape(N, D).float() @ router
    probs = torch.softmax(logits, dim=-1)                       # (N, E)
    topv, topi = probs.topk(topk, dim=-1)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    # slot of each (token, k-slot) pair in its expert's queue, token-major
    # within its group (the reference's exclusive cumsum of the one-hot)
    oh = F.one_hot(topi.reshape(G, g * topk), E).int()         # (G, g*k, E)
    before = oh.cumsum(dim=1) - oh
    slot = before.gather(2, topi.reshape(G, g * topk, 1)).reshape(N, topk)
    return Routing(probs, topv, topi, slot, slot < C, C)


def moe_ffn(x, p, *, topk: int, n_experts: int, capacity_factor=1.25,
            group_size: int = 4096):
    """x (B, T, D) -> (out (B, T, D), aux_loss float32 scalar).

    capacity_factor=None => no-drop (C = g): used for inference paths where
    token dropping would make prefill/decode inconsistent.  One host read a
    call (how many pairs each expert holds); the experts that hold none are
    not run."""
    B, T, D = x.shape
    N = B * T
    E = n_experts
    r = moe_route(x, p["router"], topk=topk, n_experts=E,
                  capacity_factor=capacity_factor, group_size=group_size)
    xf = x.reshape(N, D)
    # kept pairs sorted by expert (token-major within one); the dropped
    # ones under the key E, last
    key = torch.where(r.keep, r.topi, E).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=E + 1).tolist()
    kept = order[:N * topk - counts[E]]
    xs = xf[torch.div(kept, topk, rounding_mode="floor")]
    # each pair's expert output at its (token, k-slot); a dropped pair's 0
    ypair = torch.zeros((N * topk, D), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(counts[:E]):
        if n:
            xe = xs[start:start + n]
            ypair[kept[start:start + n]] = (
                F.silu(xe @ p["wg"][e]) * (xe @ p["wi"][e])) @ p["wo"][e]
            start += n
    # the combine: weights rounded to x's dtype, the products summed over
    # the k-slots in float32 (or wider), as the reference's einsum
    acc = torch.promote_types(torch.float32, x.dtype)
    w = (r.topv * r.keep).to(x.dtype).to(acc)
    y = (ypair.view(N, topk, D).to(acc) * w[..., None]).sum(dim=1)
    y = y.to(x.dtype)
    if "s_wi" in p:   # shared experts: always-on, plain FFN sum
        sg = torch.einsum("nd,sdf->nsf", xf, p["s_wg"])
        si = torch.einsum("nd,sdf->nsf", xf, p["s_wi"])
        y = y + torch.einsum("nsf,sfd->nd", F.silu(sg) * si, p["s_wo"])
    # Switch-style load-balance aux: E * sum_e f_e * P_e
    f_e = torch.bincount(r.topi.reshape(-1), minlength=E).float() / N
    P_e = r.probs.mean(dim=0)
    aux = E * (f_e * P_e).sum()
    return y.reshape(B, T, D), aux
