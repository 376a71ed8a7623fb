"""Architecture configuration schema for the assigned model zoo — a copy of
`repro.models.config` (pure Python; the port keeps its own).

One frozen dataclass describes every family (dense / MoE / SSM / hybrid /
enc-dec / VLM); `src/repro_torch/configs/archs.py` instantiates the exact
published numbers. Vocabularies are padded to a multiple of 2048 so the vocab dim always
shards over the 16-way `model` mesh axis (logits are masked back to the true
vocab; see DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_vocab(v: int, multiple: int = 2048) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0      # grok-style logit soft cap (0 = off)
    window: int = 0                # sliding-window size for local layers
    global_every: int = 0          # gemma3: 1 global layer per this many
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0              # per-expert FFN width
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # hybrid (recurrentgemma): repeating block pattern, e.g. ("R","R","A")
    block_pattern: Tuple[str, ...] = ()
    rnn_width: int = 0
    # encoder-decoder (whisper backbone)
    enc_layers: int = 0
    enc_seq: int = 1500            # precomputed frame embeddings (stub frontend)
    # VLM (internvl backbone)
    vis_seq: int = 0               # image tokens after pixel shuffle
    vis_dim: int = 0               # frontend embedding width (stub)
    # training
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:      # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True iff decode memory/compute is sub-quadratic-friendly at 512k:
        SSM, RG-LRU hybrid, or mostly-local attention (gemma3 5:1)."""
        return self.family in ("ssm", "hybrid") or self.global_every > 0

    def n_params(self) -> int:
        """Total parameter count (true vocab, untied unless tied)."""
        D, L = self.d_model, self.n_layers
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            att = D * self.n_heads * self.hd + 2 * D * self.n_kv_heads * self.hd \
                + self.n_heads * self.hd * D
            per_layer += att + 2 * D
            if self.family == "moe":
                per_layer += (self.n_experts + self.n_shared_experts) * \
                    3 * D * self.moe_d_ff + D * self.n_experts
            else:
                per_layer += 3 * D * self.d_ff
        if self.family == "ssm":
            din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += D * (2 * din) + 2 * D * N + D * H \
                + din * self.ssm_conv + din * D + 2 * D + H
        if self.family == "hybrid":
            W = self.rnn_width or D
            att = D * self.n_heads * self.hd + 2 * D * self.n_kv_heads * self.hd \
                + self.n_heads * self.hd * D
            rec = 2 * D * W + 2 * W * W + W * D + W * self.ssm_conv
            mlp = 3 * D * self.d_ff
            pat = self.block_pattern or ("R", "R", "A")
            n_att = sum(1 for i in range(L) if pat[i % len(pat)] == "A")
            per_layer = 0
            total = n_att * (att + mlp + 2 * D) + (L - n_att) * (rec + mlp + 2 * D)
            return emb + total + D
        total = emb + L * per_layer + D
        if self.family == "encdec":
            # encoder stack + cross-attention in decoder
            att = 4 * D * self.n_heads * self.hd
            total += self.enc_layers * (att + 3 * D * self.d_ff + 2 * D)
            total += L * att  # cross-attn
        if self.family == "vlm":
            total += self.vis_dim * D  # projector
        return total

    def n_params_active(self) -> int:
        """Active params per token (MoE routing)."""
        if self.family != "moe":
            return self.n_params()
        D, L = self.d_model, self.n_layers
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        att = D * self.n_heads * self.hd + 2 * D * self.n_kv_heads * self.hd \
            + self.n_heads * self.hd * D
        act = att + 2 * D + (self.topk + self.n_shared_experts) * \
            3 * D * self.moe_d_ff + D * self.n_experts
        return emb + L * act + D


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input-shape cells."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
