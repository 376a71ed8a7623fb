"""The dense decoder LM — the counterpart of `repro.models.lm`'s `DecoderLM`
for ``family="dense"`` (global attention, gemma3-style local:global
patterns, QKV bias, tied embeddings).

PyTorch's idiom in place of the reference's pytree: the model is an
`nn.Module` that holds its weights, laid out as the reference's params
(``embed`` (Vp, D), ``final_norm``, ``unembed`` (D, Vp) unless tied, and
``blocks[i]`` with ``attn`` {wq, wk, wv, wo [, bq, bk, bv]}, ``ln1``,
``ln2`` and ``mlp`` {wi, wg, wo}; the reference stacks the blocks as (L, …)
leaves, `repro_torch.convert.lm_params` unstacks them).  So the methods take
no ``params`` argument: ``init_params(generator)`` draws the weights into
the module (and returns it), and ``forward(tokens)``,
``prefill(batch, cache_len)`` and ``decode_step(cache, tokens)`` read them.
A Python loop over ``blocks`` (an `nn.ModuleList`) takes the place of the
reference's ``lax.scan``.

Families other than dense wait for ROADMAP queue 1 item 16.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.ensemble import resolve_device

from .config import ModelConfig
from .layers import (AttentionCore, attention_decode, attention_train,
                     attn_params, dense_init, mlp_params, rmsnorm, swiglu)


def _embed_params(generator, cfg: ModelConfig, dtype, device=None):
    p = {"embed": dense_init(generator, (cfg.vocab_padded, cfg.d_model),
                             dtype, scale=0.02, device=device),
         "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                   device=device or generator.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (cfg.d_model, cfg.vocab_padded),
                                  dtype, device=device)
    return p


def _logits(x, params, cfg):
    """Full-vocab logits in the COMPUTE dtype with the pad mask fused as a
    min-value select: columns at or past the true vocab read
    finfo(dtype).min / 8.  `params` holds ``embed`` / ``unembed`` (the
    model)."""
    if cfg.tie_embeddings:
        lg = x @ params.embed.T
    else:
        lg = x @ params.unembed
    col = torch.arange(cfg.vocab_padded, device=lg.device)
    return torch.where(col[None, None, :] < cfg.vocab_size, lg,
                       torch.finfo(lg.dtype).min / 8)


def xent_loss(logits, labels):
    """logits (B,T,Vp) any float dtype, labels (B,T). Max/sum statistics are
    accumulated in f32; the big tensors are never upcast."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(logits - m)
    s = e.float().sum(dim=-1)
    lse = torch.log(s) + m[..., 0].float()
    tgt = torch.take_along_dim(logits, labels[..., None],
                               dim=-1)[..., 0].float()
    return (lse - tgt).mean()


def _empty(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class DenseBlock(nn.Module):
    """One decoder block's weights: attn, ln1, ln2, mlp (the reference's
    ``params["blocks"]`` at one layer)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, H, KV, hd, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            cfg.d_ff)
        shapes = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
                  "wo": (H * hd, D)}
        if cfg.qkv_bias:
            shapes.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
        self.attn = nn.ParameterDict({k: _empty(s, dtype, device)
                                      for k, s in shapes.items()})
        self.mlp = nn.ParameterDict({
            "wi": _empty((D, Fd), dtype, device),
            "wg": _empty((D, Fd), dtype, device),
            "wo": _empty((Fd, D), dtype, device)})
        self.ln1 = _empty((D,), dtype, device)
        self.ln2 = _empty((D,), dtype, device)

    def bias(self):
        if "bq" not in self.attn:
            return None
        return {k: self.attn[k] for k in ("bq", "bk", "bv")}


class DecoderLM(nn.Module):
    """Dense decoder LM; weights allocated on `device` in `dtype` (filled by
    `init_params` or `repro_torch.convert.lm_params`); ``device=None``
    means CUDA and raises without it."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port's DecoderLM runs the dense "
                "family only; the others wait for ROADMAP queue 1 item 16")
        self.cfg = cfg
        self.dtype = dtype
        self.device = device = resolve_device(device)
        D, Vp = cfg.d_model, cfg.vocab_padded
        self.embed = _empty((Vp, D), dtype, device)
        self.final_norm = _empty((D,), dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = _empty((D, Vp), dtype, device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        # q_chunk>0: memory-efficient attention over query blocks (the
        # reference's serve factory sets 512 for cache_len >= 8192 on a mesh)
        self.q_chunk = 0
        # attn_core: None => the reference's dense attention math; else an
        # attention core such as `kernels.flashattn.ops.flash_attention`
        self.attn_core: Optional[AttentionCore] = None
        # per-layer is_global flags (gemma3 pattern; all-global otherwise)
        if cfg.global_every:
            self.layer_global = [(i + 1) % cfg.global_every == 0
                                 for i in range(cfg.n_layers)]
        else:
            self.layer_global = [True] * cfg.n_layers

    # ---- params ----
    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """Draw every weight from `generator` (on its device), in the
        reference's distributions: embed N(0, 0.02²), projections
        N(0, 1/fan_in), norms and biases zero.  Returns the module."""
        cfg = self.cfg
        emb = _embed_params(generator, cfg, self.dtype, self.device)
        for name, value in emb.items():
            getattr(self, name).copy_(value)
        for blk in self.blocks:
            attn = attn_params(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, self.dtype,
                               cfg.qkv_bias, device=self.device)
            mlp = mlp_params(generator, cfg.d_model, cfg.d_ff, self.dtype,
                             device=self.device)
            for name, value in attn.items():
                blk.attn[name].copy_(value)
            for name, value in mlp.items():
                blk.mlp[name].copy_(value)
            blk.ln1.zero_()
            blk.ln2.zero_()
        return self

    # ---- blocks ----
    def _attn_kwargs(self):
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                    rope_theta=cfg.rope_theta, window=cfg.window,
                    softcap=cfg.attn_softcap, q_chunk=self.q_chunk)

    def _run_blocks(self, x, cache=None):
        """The blocks over a full sequence; with `cache`, each layer's roped
        k and v are written into it at positions 0..T-1."""
        cfg = self.cfg
        T = x.shape[1]
        for i, (blk, is_global) in enumerate(zip(self.blocks,
                                                 self.layer_global)):
            h = rmsnorm(x, blk.ln1, cfg.norm_eps)
            a, (k, v) = attention_train(
                h, blk.attn, is_global=is_global, bias=blk.bias(),
                core=self.attn_core, return_kv=True, **self._attn_kwargs())
            if cache is not None:
                cache["k"][i, :, :T] = k
                cache["v"][i, :, :T] = v
            x = x + a
            h = rmsnorm(x, blk.ln2, cfg.norm_eps)
            x = x + swiglu(h, blk.mlp)
        return rmsnorm(x, self.final_norm, cfg.norm_eps)

    def forward(self, tokens, h0=None):
        """Full-sequence compute (train / prefill). Returns (x, aux): the
        final-normed hidden states (B, T, D) and the auxiliary loss (0 for
        the dense family, f32)."""
        x = self.embed[tokens].to(self.dtype) if h0 is None else h0
        x = self._run_blocks(x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # ---- serving ----
    def init_cache(self, batch, cache_len, dtype=None):
        cfg = self.cfg
        dtype = dtype or self.dtype
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "pos": torch.zeros((), dtype=torch.int32,
                                   device=self.device)}

    def prefill(self, batch, cache_len=None):
        """Prompt pass: returns (last-position logits (B, 1, Vp), filled
        cache {k, v: (L, B, max(cache_len, T), KV, hd), pos: T})."""
        tokens = batch["tokens"]
        B, T = tokens.shape
        cache = self.init_cache(B, max(cache_len or T, T))
        x = self.embed[tokens].to(self.dtype)
        x = self._run_blocks(x, cache)
        cache["pos"].fill_(T)
        return _logits(x[:, -1:], self, self.cfg), cache

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B,1,Vp), cache).  The new k/v are
        written into ``cache["k"]``/``cache["v"]`` in place and
        ``cache["pos"]`` advances by one in place: the returned cache is the
        same dict (the reference donates its cache to the step)."""
        cfg = self.cfg
        x = self.embed[tokens].to(self.dtype)
        pos = cache["pos"]
        for i, (blk, is_global) in enumerate(zip(self.blocks,
                                                 self.layer_global)):
            h = rmsnorm(x, blk.ln1, cfg.norm_eps)
            lc = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
            a, _ = attention_decode(h, blk.attn, lc, is_global=is_global,
                                    bias=blk.bias(), **self._attn_kwargs())
            x = x + a
            h = rmsnorm(x, blk.ln2, cfg.norm_eps)
            x = x + swiglu(h, blk.mlp)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        pos.add_(1)
        return _logits(x, self, cfg), cache
