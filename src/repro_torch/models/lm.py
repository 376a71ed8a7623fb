"""Model classes for the architecture zoo — the counterpart of
`repro.models.lm`:

  DecoderLM  — dense / MoE / gemma3-style local:global patterns.
  Mamba2LM   — attention-free SSD stack.
  HybridLM   — recurrentgemma (R, R, A periods: RG-LRU + local attention).

(`encdec.EncDecLM` and `vlm.VLM` sit in their own modules, as in the
reference.)  PyTorch's idiom in place of the reference's pytree: a model
is an `nn.Module` that holds its weights, laid out as the reference's
params (``embed`` (Vp, D), ``final_norm``, ``unembed`` (D, Vp) unless
tied, and per layer the reference's block leaves: ``attn`` {wq, wk, wv, wo
[, bq, bk, bv]}, ``ln1``, ``ln2``, ``mlp`` {wi, wg, wo} or ``moe`` {router,
wi, wg, wo [, s_wi, s_wg, s_wo]}, ``ssd``, ``rglru``; the reference stacks
them as (L, …) leaves, `repro_torch.convert.lm_params` unstacks them).
So the methods take no ``params`` argument: ``init_params(generator)``
draws the weights into the module (and returns it), and ``forward``,
``loss(batch)``, ``prefill(batch, cache_len)`` and ``decode_step(cache,
tokens)`` read them.  A Python loop over ``blocks`` (an `nn.ModuleList`,
in execution order) takes the place of the reference's ``lax.scan``, and
decode writes its cache in place (the reference donates it).

``remat`` (the reference's ``jax.checkpoint`` around each block, or each
period of the hybrid): True recomputes the block in the backward pass
(`torch.utils.checkpoint`, non-reentrant); "dots" keeps the outputs of
the matmuls with no batch dimension (``aten.mm``: the projections) and
recomputes the rest, the counterpart of
``dots_with_no_batch_dims_saveable``.  It acts only where grad is on.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.ensemble import resolve_device

from .config import ModelConfig
from .layers import (NORMAL, AttentionCore, Weights, attention_decode,
                     attention_train, attn_spec, mlp_spec, rmsnorm, swiglu)
from .moe import moe_ffn, moe_spec
from .rglru import rglru_decode, rglru_spec, rglru_train
from .ssm import ssd_layer_decode, ssd_layer_train, ssd_spec


def _embed_spec(cfg: ModelConfig, dtype):
    spec = {"embed": ((cfg.vocab_padded, cfg.d_model), dtype,
                      ("normal", 0.02)),
            "final_norm": ((cfg.d_model,), dtype, 0.0)}
    if not cfg.tie_embeddings:
        spec["unembed"] = ((cfg.d_model, cfg.vocab_padded), dtype, NORMAL)
    return spec


def _norm_spec(cfg: ModelConfig, dtype, *names):
    return {n: ((cfg.d_model,), dtype, 0.0) for n in names}


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


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the matmuls with no batch dimension."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(remat, fn, *args):
    """fn(*args) under the remat policy `remat` (False, True or "dots")
    where grad is on."""
    if not remat or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif remat is True:
        context_fn = ckpt.noop_context_fn
    else:
        raise ValueError(f"remat must be False, True or 'dots', not "
                         f"{remat!r}")
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           context_fn=context_fn)


def lm_loss(x, params, cfg, labels, aux=None):
    """The reference's next-token loss on final-normed hidden states x
    (B, T, D): the logits at positions 0..T-2 against the labels at
    1..T-1; total = ce + 0.01 aux where the family has an aux loss.
    Returns (total, {"ce", "aux"}), aux float32 0 where it has none."""
    logits = _logits(x, params, cfg)
    ce = xent_loss(logits[:, :-1], labels[:, 1:])
    if aux is None:
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _bias(attn):
    if "bq" not in attn:
        return None
    return {k: attn[k] for k in ("bq", "bk", "bv")}


class _LM(Weights):
    """The embedding, final norm and unembedding of a model on `device`
    (None: CUDA, raising without it); `blocks` in execution order."""

    def __init__(self, cfg: ModelConfig, dtype, device, extra=None,
                 remat=False):
        device = resolve_device(device)
        super().__init__({**_embed_spec(cfg, dtype), **(extra or {})},
                         device)
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        self.remat = remat

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """Draw every weight from `generator` (on its device), in the
        reference's distributions: embed N(0, 0.02²), projections
        N(0, 1/fan_in), norms and biases zero, the families' own constants
        (`*_spec`).  Returns the module."""
        self.draw_(generator)
        for blk in self.modules():
            if isinstance(blk, Weights) and blk is not self:
                blk.draw_(generator)
        return self

    def _embed(self, tokens):
        # the reference's `embed[tokens]`; `F.embedding`'s backward on the
        # card sums a row's repeats in float32 (indexing's, in the table's
        # dtype: 3% off a bf16 table's gradient on Zipf tokens, PERF.md §6)
        return F.embedding(tokens, self.embed).to(self.dtype)

    def _head(self, x):
        """The final norm and the logits of x."""
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return _logits(x, self, self.cfg)

    def _pos(self, value):
        return torch.full((), value, dtype=torch.int32, device=self.device)


# ===========================================================================
# DecoderLM: dense / moe / gemma3 local-global
# ===========================================================================

def _decoder_block_spec(cfg: ModelConfig, dtype):
    spec = {"attn": attn_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, dtype, cfg.qkv_bias),
            **_norm_spec(cfg, dtype, "ln1", "ln2")}
    if cfg.family == "moe":
        spec["moe"] = moe_spec(cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                               cfg.n_shared_experts, dtype)
    else:
        spec["mlp"] = mlp_spec(cfg.d_model, cfg.d_ff, dtype)
    return spec


class DecoderLM(_LM):
    """Decoder LM (dense, MoE, and the VLM's language model); weights
    allocated on `device` in `dtype` (filled by `init_params` or
    `repro_torch.convert.lm_params`); ``device=None`` means CUDA and
    raises without it.  MoE capacity: `moe_cf` in `forward`,
    `moe_inference_cf` (None: no drops) in prefill and decode; groups of
    `moe_group` tokens (decode: the batch)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                 remat=False, moe_group=4096, moe_cf=1.25):
        super().__init__(cfg, dtype, device, remat=remat)
        self.blocks = nn.ModuleList(
            Weights(_decoder_block_spec(cfg, dtype), self.device)
            for _ in range(cfg.n_layers))
        self.moe_group = moe_group
        self.moe_cf = moe_cf  # None => no-drop
        self.moe_inference_cf = None
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

    def _attn_kwargs(self):
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                    rope_theta=cfg.rope_theta, window=cfg.window,
                    softcap=cfg.attn_softcap, q_chunk=self.q_chunk)

    def _ffn(self, blk, h, capacity_factor, group_size):
        """(FFN output, the MoE aux loss or None)."""
        cfg = self.cfg
        if cfg.family != "moe":
            return swiglu(h, blk.mlp), None
        return moe_ffn(h, blk.moe, topk=cfg.topk, n_experts=cfg.n_experts,
                       capacity_factor=capacity_factor, group_size=group_size)

    def _block(self, blk, is_global, moe_cf, x):
        """One block over a full sequence: (x, the MoE aux or None, the
        roped k and the v)."""
        cfg = self.cfg
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        a, kv = attention_train(
            h, blk.attn, is_global=is_global, bias=_bias(blk.attn),
            core=self.attn_core, return_kv=True, **self._attn_kwargs())
        x = x + a
        h = rmsnorm(x, blk.ln2, cfg.norm_eps)
        y, aux = self._ffn(blk, h, moe_cf, self.moe_group)
        return x + y, aux, kv

    def _run_blocks(self, x, cache=None, moe_cf=None):
        """The blocks over a full sequence, then the final norm: (x, the
        summed aux, f32).  With `cache`, each layer's roped k and v are
        written into it at positions 0..T-1; without, each block runs
        under `remat`."""
        T = x.shape[1]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (blk, is_global) in enumerate(zip(self.blocks,
                                                 self.layer_global)):
            if cache is not None:
                x, a, (k, v) = self._block(blk, is_global, moe_cf, x)
                cache["k"][i, :, :T] = k
                cache["v"][i, :, :T] = v
            else:
                x, a, _ = remat_call(self.remat, self._block, blk, is_global,
                                     moe_cf, x)
            if a is not None:
                aux = aux + a
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps), aux

    def forward(self, tokens, h0=None):
        """Full-sequence compute (train / prefill). Returns (x, aux): the
        final-normed hidden states (B, T, D) and the summed MoE aux loss
        (0 for the dense family), f32."""
        x = self._embed(tokens) if h0 is None else h0
        return self._run_blocks(x, moe_cf=self.moe_cf)

    def loss(self, batch):
        """(total, {"ce", "aux"}): the next-token loss of ``batch``'s
        tokens against its labels, + 0.01 aux."""
        x, aux = self.forward(batch["tokens"])
        return lm_loss(x, self, self.cfg, batch["labels"], aux)

    # ---- serving ----
    def init_cache(self, batch, cache_len, dtype=None):
        cfg = self.cfg
        dtype = dtype or self.dtype
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "pos": self._pos(0)}

    def _prefill(self, x, cache_len, moe_cf):
        """Prompt pass over embeddings x (B, T, D)."""
        B, T = x.shape[:2]
        cache = self.init_cache(B, max(cache_len or T, T))
        x, _ = self._run_blocks(x, cache, moe_cf)
        cache["pos"].fill_(T)
        return _logits(x[:, -1:], self, self.cfg), cache

    def prefill(self, batch, cache_len=None):
        """Prompt pass: returns (last-position logits (B, 1, Vp), filled
        cache {k, v: (L, B, max(cache_len, T), KV, hd), pos: T})."""
        return self._prefill(self._embed(batch["tokens"]), cache_len,
                             self.moe_inference_cf)

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B,1,Vp), cache).  The new k/v are
        written into ``cache["k"]``/``cache["v"]`` in place and
        ``cache["pos"]`` advances by one in place: the returned cache is the
        same dict (the reference donates its cache to the step)."""
        cfg = self.cfg
        x = self._embed(tokens)
        pos = cache["pos"]
        for i, (blk, is_global) in enumerate(zip(self.blocks,
                                                 self.layer_global)):
            h = rmsnorm(x, blk.ln1, cfg.norm_eps)
            lc = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
            a, _ = attention_decode(h, blk.attn, lc, is_global=is_global,
                                    bias=_bias(blk.attn),
                                    **self._attn_kwargs())
            x = x + a
            h = rmsnorm(x, blk.ln2, cfg.norm_eps)
            x = x + self._ffn(blk, h, self.moe_inference_cf, x.shape[0])[0]
        pos.add_(1)
        return self._head(x), cache


# ===========================================================================
# Mamba2LM
# ===========================================================================

class Mamba2LM(_LM):
    """The attention-free SSD stack; its cache holds each layer's state h
    (float32, or the prefill's wider dtype), conv tail and pos."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                 remat=False, ssd_chunk=256):
        super().__init__(cfg, dtype, device, remat=remat)
        self.blocks = nn.ModuleList(
            Weights({"ssd": ssd_spec(cfg, dtype),
                     **_norm_spec(cfg, dtype, "ln")}, self.device)
            for _ in range(cfg.n_layers))
        self.ssd_chunk = ssd_chunk

    def _block(self, blk, x):
        """One block: (x, its state)."""
        h = rmsnorm(x, blk.ln, self.cfg.norm_eps)
        y, st = ssd_layer_train(h, blk.ssd, self.cfg, chunk=self.ssd_chunk)
        return x + y, st

    def _layers(self, x, states):
        for blk in self.blocks:
            x, st = self._block(blk, x)
            states.append(st)
        return x

    def forward(self, tokens):
        x = self._embed(tokens)
        for blk in self.blocks:
            x, _ = remat_call(self.remat, self._block, blk, x)
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    def loss(self, batch):
        return lm_loss(self.forward(batch["tokens"]), self, self.cfg,
                       batch["labels"])

    def init_cache(self, batch, cache_len, dtype=None):
        cfg = self.cfg
        dtype = dtype or self.dtype
        L, din, N = cfg.n_layers, cfg.d_inner, cfg.ssm_state
        H, P, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
        return {"h": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                                 device=self.device),
                "conv": torch.zeros((L, batch, K - 1, din + 2 * N),
                                    dtype=dtype, device=self.device),
                "pos": self._pos(0)}

    def prefill(self, batch, cache_len=None):
        """(last-position logits, cache); `cache_len` is unused: the state
        is O(1) in the sequence."""
        tokens = batch["tokens"]
        states = []
        x = self._layers(self._embed(tokens), states)
        cache = {"h": torch.stack([s["h"] for s in states]),
                 "conv": torch.stack([s["conv"] for s in states]),
                 "pos": self._pos(tokens.shape[1])}
        return self._head(x[:, -1:]), cache

    def decode_step(self, cache, tokens):
        x = self._embed(tokens)
        for i, blk in enumerate(self.blocks):
            h = rmsnorm(x, blk.ln, self.cfg.norm_eps)
            y, st = ssd_layer_decode(h, blk.ssd, self.cfg,
                                     {"h": cache["h"][i],
                                      "conv": cache["conv"][i]})
            x = x + y
            cache["h"][i].copy_(st["h"])
            cache["conv"][i].copy_(st["conv"])
        cache["pos"].add_(1)
        return self._head(x), cache


# ===========================================================================
# HybridLM (recurrentgemma): period pattern (R, R, A)
# ===========================================================================

class HybridLM(_LM):
    """Layers in periods of ``block_pattern`` plus a remainder, in
    execution order in `blocks` (the reference keeps ``periods``, one
    (n_periods, …) stack a slot, and ``rem``).  The cache keeps the
    reference's layout: ``slots`` (a stack a slot: a window-sized ring
    buffer k/v for attention, h (f32) and conv for RG-LRU), ``rem``,
    ``pos``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                 remat=False):
        super().__init__(cfg, dtype, device, remat=remat)
        self.pattern = tuple(cfg.block_pattern or ("R", "R", "A"))
        self.period = len(self.pattern)
        self.n_periods = cfg.n_layers // self.period
        self.rem = self.pattern[:cfg.n_layers % self.period]
        self.kinds = self.pattern * self.n_periods + self.rem
        self.W = cfg.rnn_width or cfg.d_model
        self.q_chunk = 0
        self.blocks = nn.ModuleList(Weights(self._slot_spec(kind), self.device)
                                    for kind in self.kinds)

    def _slot_spec(self, kind):
        cfg = self.cfg
        if kind == "A":
            mixer = {"attn": attn_spec(cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd, self.dtype)}
        else:
            mixer = {"rglru": rglru_spec(cfg.d_model, self.W, cfg.ssm_conv,
                                         self.dtype)}
        return {**mixer, **_norm_spec(cfg, self.dtype, "ln1", "ln2"),
                "mlp": mlp_spec(cfg.d_model, cfg.d_ff, self.dtype)}

    def _apply_slot(self, blk, x, kind, mode, state=None):
        """mode: train|prefill|decode. Returns (x, new_state)."""
        cfg = self.cfg
        h = rmsnorm(x, blk.ln1, cfg.norm_eps)
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                  rope_theta=cfg.rope_theta)
        if kind == "A":
            if mode == "decode":
                # ring-buffer window cache: eviction IS the sliding window
                a, state = attention_decode(h, blk.attn, state, window=0,
                                            is_global=True, **kw)
            else:
                a, (k, v) = attention_train(h, blk.attn, window=cfg.window,
                                            is_global=False,
                                            q_chunk=self.q_chunk,
                                            return_kv=True, **kw)
                state = {"k": k, "v": v} if mode == "prefill" else None
        elif mode == "decode":
            a, state = rglru_decode(h, blk.rglru, state)
        else:
            a, state = rglru_train(h, blk.rglru)
        x = x + a
        h2 = rmsnorm(x, blk.ln2, cfg.norm_eps)
        return x + swiglu(h2, blk.mlp), state

    def _run(self, x, j0, j1):
        """Layers j0..j1-1 in training mode."""
        for blk, kind in zip(self.blocks[j0:j1], self.kinds[j0:j1]):
            x, _ = self._apply_slot(blk, x, kind, "train")
        return x

    def forward(self, tokens):
        """The periods, each under `remat` (as the reference's scan over
        periods), then the remainder's layers."""
        x = self._embed(tokens)
        P = self.period
        for c in range(self.n_periods):
            x = remat_call(self.remat, self._run, x, c * P, (c + 1) * P)
        x = self._run(x, self.n_periods * P, len(self.blocks))
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    def loss(self, batch):
        return lm_loss(self.forward(batch["tokens"]), self, self.cfg,
                       batch["labels"])

    def _state_zeros(self, kind, lead, batch, wlen, dtype):
        cfg = self.cfg
        z = lambda *s, dt=dtype: torch.zeros(lead + (batch,) + s, dtype=dt,
                                             device=self.device)
        if kind == "A":
            return {"k": z(wlen, cfg.n_kv_heads, cfg.hd),
                    "v": z(wlen, cfg.n_kv_heads, cfg.hd)}
        return {"h": z(self.W, dt=torch.float32),
                "conv": z(cfg.ssm_conv - 1, self.W)}

    # serving: attention slots keep a WINDOW-sized cache (ring buffer:
    # slot = position % wlen); the RG-LRU state is O(1)
    def init_cache(self, batch, cache_len, dtype=None):
        dtype = dtype or self.dtype
        wlen = min(cache_len, self.cfg.window) if self.cfg.window \
            else cache_len
        return {"slots": tuple(self._state_zeros(k, (self.n_periods,), batch,
                                                 wlen, dtype)
                               for k in self.pattern),
                "rem": tuple(self._state_zeros(k, (), batch, wlen, dtype)
                             for k in self.rem),
                "pos": self._pos(0)}

    def _layer_cache(self, cache, j):
        """Layer j's part of the cache, as views."""
        c, s = divmod(j, self.period)
        if c < self.n_periods:
            return {k: v[c] for k, v in cache["slots"][s].items()}
        return cache["rem"][j - self.n_periods * self.period]

    def decode_step(self, cache, tokens):
        x = self._embed(tokens)
        pos = cache["pos"]
        wlen = (cache["slots"][self.pattern.index("A")]["k"].shape[2]
                if "A" in self.pattern else 0)
        for j, (blk, kind) in enumerate(zip(self.blocks, self.kinds)):
            st = self._layer_cache(cache, j)
            if kind == "A":                       # k, v written in place
                x, _ = self._apply_slot(blk, x, kind, "decode",
                                        dict(st, pos=pos,
                                             write_idx=pos % wlen))
            else:
                x, new = self._apply_slot(blk, x, kind, "decode", st)
                st["h"].copy_(new["h"])
                st["conv"].copy_(new["conv"])
        pos.add_(1)
        return self._head(x), cache

    def prefill(self, batch, cache_len=None):
        # prefill = forward + state capture; window caches keep the LAST
        # `wlen` keys placed at their ring slots (slot = position % wlen)
        cfg = self.cfg
        tokens = batch["tokens"]
        B, T = tokens.shape
        cache_len = cache_len or T
        wlen = min(cache_len, cfg.window) if cfg.window else cache_len

        def to_ring(k):
            """(B, T, KV, hd) -> (B, wlen, KV, hd) at ring slots."""
            if T >= wlen:
                return torch.roll(k[:, -wlen:], T % wlen, dims=1)
            return F.pad(k, (0, 0, 0, 0, 0, wlen - T))

        cache = self.init_cache(B, cache_len)
        x = self._embed(tokens)
        for j, (blk, kind) in enumerate(zip(self.blocks, self.kinds)):
            x, st = self._apply_slot(blk, x, kind, "prefill")
            if kind == "A":
                st = {"k": to_ring(st["k"]), "v": to_ring(st["v"])}
            for key, dst in self._layer_cache(cache, j).items():
                dst.copy_(st[key])
        cache["pos"].fill_(T)
        return self._head(x[:, -1:]), cache
