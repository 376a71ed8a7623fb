"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) — the
counterpart of `repro.models.rglru`.

The gated diagonal linear recurrence
    a_t = exp(-c · softplus(Λ) · r_t),   r_t, i_t = σ(linear(x_t))
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
runs over a whole sequence as an associative scan over time (`assoc_scan`:
the reference's `jax.lax.associative_scan` recursion, about log2(T) levels
of torch ops, in its order of operations), and one step at a time in
decode.  The gates, b_r, b_i and Λ are float32 whatever the model's dtype,
as the reference's.

Block structure (Griffin): y = W_out[ RG-LRU(conv4(W_x x)) ⊙ GeLU(W_g x) ].
"""
from __future__ import annotations

import torch

from .layers import NORMAL, draw, gelu
from .ssm import _causal_conv, softplus

_C = 8.0


def rglru_spec(D, W, K, dtype):
    f32 = torch.float32
    return {
        "w_x": ((D, W), dtype, NORMAL),
        "w_gate": ((D, W), dtype, NORMAL),
        "w_r": ((W, W), dtype, NORMAL),
        "w_i": ((W, W), dtype, NORMAL),
        "b_r": ((W,), f32, 0.0),
        "b_i": ((W,), f32, 0.0),
        "lam": ((W,), f32, 0.65),   # a ~ 0.94^r at init
        "conv_w": ((K, W), dtype, ("normal", 0.5)),
        "w_out": ((W, D), dtype, NORMAL),
    }


def rglru_params(generator, D, W, K, dtype, device=None):
    return draw(generator, rglru_spec(D, W, K, dtype), device)


def _gates(xb, p):
    r = torch.sigmoid((xb @ p["w_r"]).float() + p["b_r"])
    i = torch.sigmoid((xb @ p["w_i"]).float() + p["b_i"])
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xb.float())
    return a, gated


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def assoc_scan(a, b):
    """The inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1, as
    (prod a, h): `jax.lax.associative_scan(combine, (a, b), axis=1)`'s
    odd/even recursion, level by level."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, scan the pairs, then fill in the evens
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2], out_b[:, 2::2] = ea, eb
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    return out_a, out_b


def rglru_train(x, p, state=None):
    """x (B,T,D) -> (y (B,T,D), state dict(h (B,W) f32, conv))."""
    xb = x @ p["w_x"]
    xb, conv_new = _causal_conv(xb, p["conv_w"],
                                None if state is None else state["conv"])
    a, gated = _gates(xb, p)               # (B,T,W) f32
    if state is not None:
        # fold carried state into step 0: h_0 = a_0 h_in + gated_0
        gated = gated.clone()
        gated[:, 0] += a[:, 0] * state["h"]
    _, hh = assoc_scan(a, gated)
    y = (hh.to(x.dtype) * gelu(x @ p["w_gate"])) @ p["w_out"]
    return y, {"h": hh[:, -1], "conv": conv_new}


def rglru_decode(x, p, state):
    """x (B,1,D), state dict(h (B,W) f32, conv (B,K-1,W))."""
    xb = x @ p["w_x"]
    xb, conv_new = _causal_conv(xb, p["conv_w"], state["conv"])
    a, gated = _gates(xb, p)               # (B,1,W)
    h = a[:, 0] * state["h"] + gated[:, 0]
    y = (h[:, None].to(x.dtype) * gelu(x @ p["w_gate"])) @ p["w_out"]
    return y, {"h": h, "conv": conv_new}
