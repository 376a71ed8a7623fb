"""Whisper-style encoder-decoder BACKBONE (whisper-tiny) — the counterpart
of `repro.models.encdec`.

As in the reference the conv/mel audio frontend is a STUB: the batch
carries precomputed frame embeddings (B, enc_seq, D).  The backbone is
real: a bidirectional transformer encoder (the reference's dense
attention: non-causal) and a causal decoder with cross-attention, whose
self-attention may take an attention core such as K7 (`attn_core`).  The
decoder recomputes the cross-attention K/V from ``cache["enc"]`` at every
step, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import (AttentionCore, Weights, attention_decode,
                     attention_train, attn_spec, cross_attention, mlp_spec,
                     rmsnorm, swiglu)
from .lm import _LM, _norm_spec, lm_loss, remat_call


class EncDecLM(_LM):
    """``remat`` checkpoints each encoder block, as the reference's (its
    decoder blocks run as they are)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                 remat=False):
        super().__init__(cfg, dtype, device,
                         extra=_norm_spec(cfg, dtype, "enc_norm"),
                         remat=remat)
        self.enc_blocks = nn.ModuleList(
            Weights(self._block_spec(), self.device)
            for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(
            Weights({**self._block_spec(),
                     "xattn": self._attn_spec(),
                     **_norm_spec(cfg, dtype, "lnx")}, self.device)
            for _ in range(cfg.n_layers))
        self.q_chunk = 0
        # the decoder self-attention's core (None: the dense math)
        self.attn_core: Optional[AttentionCore] = None

    def _attn_spec(self):
        cfg = self.cfg
        return attn_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         self.dtype)

    def _block_spec(self):
        cfg = self.cfg
        return {"attn": self._attn_spec(),
                "mlp": mlp_spec(cfg.d_model, cfg.d_ff, self.dtype),
                **_norm_spec(cfg, self.dtype, "ln1", "ln2")}

    def _attn_kwargs(self):
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                    rope_theta=cfg.rope_theta, q_chunk=self.q_chunk)

    def _enc_block(self, blk, x):
        cfg = self.cfg
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        x = x + attention_train(h, blk.attn, causal=False,
                                **self._attn_kwargs())
        h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
        return x + swiglu(h2, blk.mlp)

    def encode(self, frames):
        """frames: (B, enc_seq, D) stub embeddings -> encoder states."""
        x = frames.to(self.dtype)
        for blk in self.enc_blocks:
            x = remat_call(self.remat, self._enc_block, blk, x)
        return rmsnorm(x, self.enc_norm, self.cfg.norm_eps)

    def _xkv(self, blk, enc):
        cfg = self.cfg
        B, S, D = enc.shape
        k = (enc @ blk.xattn["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        v = (enc @ blk.xattn["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
        return k, v

    def _dec_block(self, blk, x, enc, cache=None):
        """One decoder block: over the sequence (cache None; returns also
        the roped k and v) or one decode step against `cache` (written in
        place).  Returns (x, (k, v) or None)."""
        cfg = self.cfg
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        if cache is not None:
            a, _ = attention_decode(h, blk.attn, cache, **self._attn_kwargs())
            kv = None
        else:
            a, kv = attention_train(h, blk.attn, core=self.attn_core,
                                    return_kv=True, **self._attn_kwargs())
        x = x + a
        h = rmsnorm(x, blk.lnx, cfg.norm_eps)
        xk, xv = self._xkv(blk, enc)
        x = x + cross_attention(h, blk.xattn, xk, xv, n_heads=cfg.n_heads,
                                n_kv=cfg.n_kv_heads, hd=cfg.hd)
        h = rmsnorm(x, blk.ln2, cfg.norm_eps)
        return x + swiglu(h, blk.mlp), kv

    def forward(self, tokens, frames):
        enc = self.encode(frames)
        x = self._embed(tokens)
        for blk in self.dec_blocks:
            x, _ = self._dec_block(blk, x, enc)
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    def loss(self, batch):
        """(ce, {"ce", "aux": 0}) over ``batch``'s tokens and frames."""
        return lm_loss(self.forward(batch["tokens"], batch["frames"]), self,
                       self.cfg, batch["labels"])

    def init_cache(self, batch, cache_len, dtype=None):
        cfg = self.cfg
        dtype = dtype or self.dtype
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "enc": torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                   dtype=dtype, device=self.device),
                "pos": self._pos(0)}

    def prefill(self, batch, cache_len=None):
        tokens = batch["tokens"]
        B, T = tokens.shape
        cache = self.init_cache(B, max(cache_len or T, T))
        cache["enc"] = enc = self.encode(batch["frames"])
        cache["pos"].fill_(T)
        x = self._embed(tokens)
        for i, blk in enumerate(self.dec_blocks):
            x, (k, v) = self._dec_block(blk, x, enc)
            cache["k"][i, :, :T] = k
            cache["v"][i, :, :T] = v
        return self._head(x[:, -1:]), cache

    def decode_step(self, cache, tokens):
        x = self._embed(tokens)
        pos = cache["pos"]
        for i, blk in enumerate(self.dec_blocks):
            lc = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
            x, _ = self._dec_block(blk, x, cache["enc"], lc)
        pos.add_(1)
        return self._head(x), cache

