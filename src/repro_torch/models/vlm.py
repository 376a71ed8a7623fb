"""InternVL2-style VLM BACKBONE (internvl2-26b) — the counterpart of
`repro.models.vlm`.

As in the reference the InternViT frontend is a STUB: the batch carries
precomputed patch embeddings (B, vis_seq, vis_dim).  The backbone is real:
an MLP projector into the LM width + the InternLM2 decoder (`DecoderLM`,
`lm`); the image tokens are prepended to the text, so the cache's
positions count them.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import NORMAL, Weights, gelu
from .lm import DecoderLM, lm_loss


class VLM(Weights):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                 remat=False):
        lm = DecoderLM(cfg, dtype=dtype, device=device, remat=remat)
        super().__init__({"projector": {
            "w1": ((cfg.vis_dim, cfg.d_model), dtype, NORMAL),
            "w2": ((cfg.d_model, cfg.d_model), dtype, NORMAL)}}, lm.device)
        self.lm = lm
        self.cfg = cfg
        self.dtype = dtype
        self.device = lm.device

    # the LM's attention core (K7 where set)
    attn_core = property(lambda self: self.lm.attn_core,
                         lambda self, core: setattr(self.lm, "attn_core",
                                                    core))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        self.lm.init_params(generator)
        return self.draw_(generator)

    def _embed_multimodal(self, tokens, patches):
        vis = gelu(patches.to(self.dtype) @ self.projector["w1"])
        vis = vis @ self.projector["w2"]                    # (B, Tv, D)
        txt = self.lm._embed(tokens)                        # (B, Tt, D)
        return torch.cat([vis, txt], dim=1)

    def loss(self, batch):
        """batch: tokens (B, Tt), labels (B, Tt), patches (B, Tv, vis_dim).
        The loss on the text positions only, + 0.01 aux."""
        h0 = self._embed_multimodal(batch["tokens"], batch["patches"])
        x, aux = self.lm.forward(None, h0=h0)
        Tv = batch["patches"].shape[1]
        return lm_loss(x[:, Tv:], self.lm, self.cfg, batch["labels"], aux)

    def init_cache(self, batch, cache_len, dtype=None):
        return self.lm.init_cache(batch, cache_len, dtype)

    def prefill(self, batch, cache_len=None):
        """Image + prompt prefill. tokens (B,Tt), patches (B,Tv,vis_dim)."""
        h0 = self._embed_multimodal(batch["tokens"], batch["patches"])
        return _prefill_from_embeds(self.lm, h0, cache_len)

    def decode_step(self, cache, tokens):
        return self.lm.decode_step(cache, tokens)


def _prefill_from_embeds(lm: DecoderLM, h0, cache_len):
    """DecoderLM.prefill generalized to a precomputed embedding stream (an
    MoE language model routes it with no drops, as the reference's)."""
    return lm._prefill(h0, cache_len, None)
