"""Dense-attention oracle for the flash kernel (f32 math, explicit softmax)
— the counterpart of `repro.kernels.flashattn.ref`."""
from __future__ import annotations

import math

import torch


def ref_attention(q, k, v, causal=True):
    """q (B,T,H,hd); k/v (B,S,KV,hd) -> (B,T,H,hd), GQA by head grouping."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float().reshape(B, T, KV, g, hd)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) / math.sqrt(float(hd))
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None])
        s = torch.where(mask, s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, vf)
    return o.reshape(B, T, H, hd).to(q.dtype)


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bfloat16 ulps of want, the ulp taken at
    no less than 2^-8 of the largest |want|: two float32 results of one
    attention, each rounded once to bfloat16, may straddle a rounding
    boundary (one ulp), and near zero their float32 difference exceeds a
    bfloat16 ulp of the value itself."""
    got, want = got.double(), want.double()
    mag = torch.maximum(want.abs(), want.abs().max() * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())
