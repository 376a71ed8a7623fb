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
A weight dict ``w`` is anything indexed by name: a dict of tensors, or the
`torch.nn.ParameterDict` of a `repro_torch.models.lm.DenseBlock`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x, w):
    """w: dict(wi, wg, wo): (D,F), (D,F), (F,D)."""
    return (F.silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]


# ---------------------------------------------------------------------------
# init helpers (weights drawn from a torch.Generator, on its device)
# ---------------------------------------------------------------------------

def dense_init(generator, shape, dtype, scale=None, device=None):
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return x.to(device=device or generator.device, dtype=dtype)


def attn_params(generator, D, n_heads, n_kv, hd, dtype, qkv_bias=False,
                device=None):
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(generator, (D, n_heads * hd), **kw),
        "wk": dense_init(generator, (D, n_kv * hd), **kw),
        "wv": dense_init(generator, (D, n_kv * hd), **kw),
        "wo": dense_init(generator, (n_heads * hd, D), **kw),
    }
    if qkv_bias:
        dev = device or generator.device
        p["bq"] = torch.zeros((n_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * hd,), dtype=dtype, device=dev)
    return p


def mlp_params(generator, D, F_, dtype, device=None):
    kw = dict(dtype=dtype, device=device)
    return {"wi": dense_init(generator, (D, F_), **kw),
            "wg": dense_init(generator, (D, F_), **kw),
            "wo": dense_init(generator, (F_, D), **kw)}
