"""Shared transformer building blocks: RMSNorm, RoPE, GQA attention (global /
sliding-window, optional softcap and bias), SwiGLU MLP — the counterpart of
`repro.models.layers`.

Conventions (the reference's, kept at every function here):
  activations  x: (B, T, D), computed in the param dtype (bf16 target),
  softmax/norm statistics in f32.
  attention weights: wq (D, H*hd), wk/wv (D, KV*hd), wo (H*hd, D), applied
  as ``x @ w`` (the reference's layout; no transpose anywhere).
  KV cache: dict(k=(B, S, KV, hd), v=(B, S, KV, hd), pos=()) — pos is the
  current fill level (static-shape cache, masked reads).
A weight dict ``w`` is anything indexed by name: a dict of tensors, or an
`torch.nn.ParameterDict` of a `Weights` module (a block's ``attn``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

# An attention core: (q (B,T,H,hd), k, v (B,S,KV,hd), *, causal) ->
# (B,T,H,hd); `repro_torch.kernels.flashattn.ops.flash_attention` is one.
AttentionCore = Callable[..., torch.Tensor]


# ---------------------------------------------------------------------------
# norms & positional encoding
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x.float() * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(hd: int, theta: float, positions):
    """positions (…,) -> cos/sin (…, hd/2), in float32 whatever the
    positions' or the model's dtype (as the reference)."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(q, cos, sin):
    """q (B, T, H, hd); cos/sin (T, hd/2) or (B, T, hd/2)."""
    q1, q2 = q.chunk(2, dim=-1)
    cos = cos[..., None, :]          # head axis
    sin = sin[..., None, :]
    while cos.dim() < q1.dim():      # leading batch axes
        cos = cos[None]
        sin = sin[None]
    out = torch.cat([q1 * cos - q2 * sin, q1 * sin + q2 * cos], dim=-1)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _soft_cap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _neg(dt):
    """The masked score, finfo(dt).min / 8 (exact in dt), as a Python
    number: `torch.where` keeps the tensor's dtype, and no host-to-device
    copy stalls the step (a `torch.tensor` on the card would)."""
    return torch.finfo(dt).min / 8


def attention_core(q, k, v, *, causal=True, window=0, is_global=True,
                   softcap=0.0, q_chunk=0, q_offset=0):
    """The reference's attention after rope (`attention_train`'s `block`):
    q (B, T, H, hd) at global rows q_offset.., k/v (B, S, KV, hd) ->
    (B, T, H*hd).  Scores and probabilities in q's dtype, the softmax sum
    in f32, masked scores finfo(dtype).min / 8; q_chunk > 0 computes
    q_chunk query rows at a time (peak score tensor (…, q_chunk, S))."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    q = q.reshape(B, T, KV, g, hd)
    dt = q.dtype
    neg = _neg(dt)
    si = torch.arange(S, device=q.device)[None, :]

    def block(qb, q0):
        """qb: (B, C, KV, g, hd) starting at global row q0. -> (B, C, H*hd)"""
        C = qb.shape[1]
        logits = torch.einsum("bqkgh,bskh->bkgqs", qb, k)
        logits = logits * (1.0 / float(hd) ** 0.5)
        logits = _soft_cap(logits, softcap)
        qi = q0 + torch.arange(C, device=q.device)[:, None]
        mask = (si <= qi) if causal else torch.ones(
            (C, S), dtype=torch.bool, device=q.device)
        if window and not is_global:
            mask = mask & (si > qi - window)
        logits = torch.where(mask, logits, neg)
        m = logits.amax(dim=-1, keepdim=True).detach()
        e = torch.exp(logits - m)
        s = e.float().sum(dim=-1, keepdim=True)
        probs = e / s.to(dt)
        ob = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
        return ob.reshape(B, C, H * hd)

    if q_chunk and T > q_chunk and T % q_chunk == 0:
        return torch.cat([block(q[:, i:i + q_chunk], q_offset + i)
                          for i in range(0, T, q_chunk)], dim=1)
    return block(q, q_offset)


def qkv_rope(x, w, *, n_heads, n_kv, hd, rope_theta, bias=None,
             positions=None):
    """Projections, biases and rope: x (B, T, D) -> q (B, T, H, hd) and k
    (B, T, KV, hd) roped, v (B, T, KV, hd)."""
    B, T, D = x.shape
    q = x @ w["wq"]
    k = x @ w["wk"]
    v = x @ w["wv"]
    if bias is not None:
        q = q + bias["bq"]
        k = k + bias["bk"]
        v = v + bias["bv"]
    q = q.reshape(B, T, n_heads, hd)
    k = k.reshape(B, T, n_kv, hd)
    v = v.reshape(B, T, n_kv, hd)
    if positions is None:
        positions = torch.arange(T, device=x.device)
    cos, sin = rope_freqs(hd, rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention_train(x, w, *, n_heads, n_kv, hd, rope_theta, window=0,
                    softcap=0.0, is_global=True, bias=None, positions=None,
                    causal=True, q_chunk=0,
                    core: Optional[AttentionCore] = None, return_kv=False):
    """Self-attention over a full sequence (training / prefill compute).

    w: dict(wq, wk, wv, wo [, bq, bk, bv]). window>0 & not is_global =>
    sliding-window causal mask; causal=False => bidirectional (encoders).
    q_chunk>0 => memory-efficient attention over query blocks; 0 => dense.
    core: None => the reference's dense math (`attention_core`); else a
    function of (q, k, v, causal=) such as `flash_attention`, for causal
    attention without a window or softcap (refused elsewhere).
    return_kv => also the roped k and the v, (B, T, KV, hd) each (what the
    reference's prefill recomputes for its cache).
    Returns (B, T, D) [, (k, v)].
    """
    B, T, D = x.shape
    q, k, v = qkv_rope(x, w, n_heads=n_heads, n_kv=n_kv, hd=hd,
                       rope_theta=rope_theta, bias=bias, positions=positions)
    if core is None:
        out = attention_core(q, k, v, causal=causal, window=window,
                             is_global=is_global, softcap=softcap,
                             q_chunk=q_chunk)
    else:
        if not causal or softcap or (window and not is_global):
            raise ValueError("an attention core other than the dense one "
                             "takes causal attention without a window or "
                             "softcap")
        out = core(q, k, v, causal=True).reshape(B, T, n_heads * hd)
    out = out @ w["wo"]
    return (out, (k, v)) if return_kv else out


def attention_decode(x, w, cache: Dict[str, torch.Tensor], *, n_heads, n_kv,
                     hd, rope_theta, window=0, softcap=0.0, is_global=True,
                     bias=None, q_chunk=0):  # q_chunk ignored (single token)
    """One-token decode against a static-shape KV cache.

    x: (B, 1, D); cache k/v: (B, S, KV, hd), cache["pos"]: 0-d int tensor,
    absolute position of the NEW token. Two cache layouts:
      absolute — slot i holds position i (default); causal mask si <= pos,
                 optional sliding-window mask.
      ring     — cache["write_idx"] present: slot = position % S (window-sized
                 caches for local-attention layers; rope stays absolute so
                 relative geometry is preserved, eviction is automatic).
    The new k/v are written into cache["k"] and cache["v"] IN PLACE (the
    reference donates its cache; a functional copy would move the whole
    cache on every step), and the returned cache holds those same tensors.
    Returns (out (B,1,D), cache with pos + 1).
    """
    B, T, D = x.shape
    assert T == 1
    S = cache["k"].shape[1]
    pos = cache["pos"]
    write_idx = cache.get("write_idx", pos)
    q, k, v = qkv_rope(x, w, n_heads=n_heads, n_kv=n_kv, hd=hd,
                       rope_theta=rope_theta, bias=bias,
                       positions=pos.reshape(1))
    ck, cv = cache["k"], cache["v"]
    slot = write_idx.reshape(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))

    g = n_heads // n_kv
    qh = q.reshape(B, n_kv, g, hd)
    dt = x.dtype
    logits = torch.einsum("bkgh,bskh->bkgs", qh, ck)
    logits = logits * (1.0 / float(hd) ** 0.5)
    logits = _soft_cap(logits, softcap)
    si = torch.arange(S, device=x.device)
    valid = si <= pos
    if window and "write_idx" not in cache and not is_global:
        valid = valid & (si > pos - window)
    logits = torch.where(valid, logits, _neg(dt))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.float().sum(dim=-1, keepdim=True)
    probs = e / s.to(dt)
    out = torch.einsum("bkgs,bskh->bkgh", probs, cv)
    out = out.reshape(B, 1, n_heads * hd)
    return out @ w["wo"], {"k": ck, "v": cv, "pos": pos + 1}


def cross_attention(x, w, kv_k, kv_v, *, n_heads, n_kv, hd):
    """Decoder→encoder cross-attention (whisper). kv_k/kv_v: (B, Senc, KV, hd)
    precomputed from encoder output; no mask, no rope (absolute content).
    The reference's rounding: logits and e in x's dtype, the sum in f32,
    probs = e / s in x's dtype."""
    B, T, D = x.shape
    q = (x @ w["wq"]).reshape(B, T, n_heads, hd)
    out = attention_core(q, kv_k, kv_v, causal=False)
    return out @ w["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x, w):
    """w: dict(wi, wg, wo): (D,F), (D,F), (F,D)."""
    return (F.silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]


# ---------------------------------------------------------------------------
# weights: specs, allocation and draws from a torch.Generator
# ---------------------------------------------------------------------------
#
# A spec maps a weight's name to (shape, dtype, init), or to a nested spec
# (a group such as a block's ``attn``).  init NORMAL draws the reference's
# `dense_init`, N(0, 1/shape[0]); ("normal", scale) draws N(0, scale^2);
# a number fills the weight with that value.  `Weights` lays a spec out as
# module parameters and `draw` draws its values: in the spec's order,
# float32 on the generator's device, then cast.

NORMAL = ("normal", None)


def gelu(x):
    """The tanh approximation, as the reference's `jax.nn.gelu`."""
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def dense_init(generator, shape, dtype, scale=None, device=None):
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return x.to(device=device or generator.device, dtype=dtype)


def draw(generator, spec, device=None):
    """The weights of `spec` as a (nested) dict of tensors on `device`
    (default: the generator's)."""
    out = {}
    for name, s in spec.items():
        if isinstance(s, dict):
            out[name] = draw(generator, s, device)
            continue
        shape, dtype, init = s
        if isinstance(init, tuple):
            out[name] = dense_init(generator, shape, dtype, init[1], device)
        else:
            out[name] = torch.full(shape, float(init), dtype=dtype,
                                   device=device or generator.device)
    return out


class Weights(nn.Module):
    """A spec laid out as parameters: a group becomes an
    `nn.ParameterDict` attribute, a single weight a parameter attribute
    (so ``blk.attn["wq"]``, ``blk.ln1``).  Allocated, not drawn."""

    def __init__(self, spec, device):
        super().__init__()
        self.spec = spec
        for name, s in spec.items():
            if isinstance(s, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: _empty(v, device) for k, v in s.items()}))
            else:
                setattr(self, name, _empty(s, device))

    @torch.no_grad()
    def draw_(self, generator):
        """Fill every weight from `generator`, in the spec's order."""
        for name, value in draw(generator, self.spec).items():
            if isinstance(value, dict):
                for k, v in value.items():
                    getattr(self, name)[k].copy_(v)
            else:
                getattr(self, name).copy_(value)
        return self


def _empty(s, device):
    shape, dtype, _ = s
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def attn_spec(D, n_heads, n_kv, hd, dtype, qkv_bias=False):
    spec = {"wq": ((D, n_heads * hd), dtype, NORMAL),
            "wk": ((D, n_kv * hd), dtype, NORMAL),
            "wv": ((D, n_kv * hd), dtype, NORMAL),
            "wo": ((n_heads * hd, D), dtype, NORMAL)}
    if qkv_bias:
        spec.update(bq=((n_heads * hd,), dtype, 0.0),
                    bk=((n_kv * hd,), dtype, 0.0),
                    bv=((n_kv * hd,), dtype, 0.0))
    return spec


def mlp_spec(D, F_, dtype):
    return {"wi": ((D, F_), dtype, NORMAL), "wg": ((D, F_), dtype, NORMAL),
            "wo": ((F_, D), dtype, NORMAL)}


def attn_params(generator, D, n_heads, n_kv, hd, dtype, qkv_bias=False,
                device=None):
    return draw(generator, attn_spec(D, n_heads, n_kv, hd, dtype, qkv_bias),
                device)


def mlp_params(generator, D, F_, dtype, device=None):
    return draw(generator, mlp_spec(D, F_, dtype), device)
