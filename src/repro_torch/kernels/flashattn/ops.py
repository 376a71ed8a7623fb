"""Public flash-attention entry: pads T and S to block multiples and
restores the shapes — the counterpart of `repro.kernels.flashattn.ops`.

CUDA tensors go to the kernel (`csrc/flash_attention.cu`), CPU tensors to
its plain version, by `kernel.flash_attention_kernel`.  K7 is forward
only, as the reference's Pallas kernel: it refuses inputs that need a
gradient, on both devices, rather than drop it on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import flash_attention_kernel


def pad_to_blocks(q, k, v, *, causal=True, block_q=128, block_k=128):
    """(q, k, v, bq, bk): T and S zero-padded up to multiples of the block
    sizes bq = min(block_q, max(16, T)), bk = min(block_k, max(16, S))."""
    T, S = q.shape[1], k.shape[1]
    bq = min(block_q, max(16, T))
    bk = min(block_k, max(16, S))
    pt = (-T) % bq
    ps = (-S) % bk
    if pt:
        q = F.pad(q, (0, 0, 0, 0, 0, pt))
    if ps:
        k = F.pad(k, (0, 0, 0, 0, 0, ps))
        v = F.pad(v, (0, 0, 0, 0, 0, ps))
    if ps and not causal:
        raise NotImplementedError("non-causal padding needs a length mask")
    return q.contiguous(), k.contiguous(), v.contiguous(), bq, bk


def flash_attention(q, k, v, *, causal=True, block_q=128, block_k=128):
    """q (B,T,H,hd); k/v (B,S,KV,hd). Pads T and S up to block multiples
    (padded keys are masked out by causality / a length mask).  Raises
    where grad mode is on and q, k or v requires grad: training runs on
    the dense core (`models.layers.attention_core`), as the reference's
    `layers.attention_train`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention (K7) is forward only and gives no gradient; "
            "train on the dense attention core (attn_core = None, "
            "models.layers.attention_core), as the reference trains on "
            "layers.attention_train")
    T = q.shape[1]
    q, k, v, bq, bk = pad_to_blocks(q, k, v, causal=causal, block_q=block_q,
                                    block_k=block_k)
    out = flash_attention_kernel(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
    return out[:, :T]
