"""Model factory: config -> model instance (family dispatch) — the
counterpart of `repro.models.model`."""
from __future__ import annotations

import torch

from .config import ModelConfig
from .encdec import EncDecLM
from .lm import DecoderLM, HybridLM, Mamba2LM
from .vlm import VLM


def build_model(cfg: ModelConfig, dtype=torch.bfloat16, device=None,
                remat=False, **kw):
    """The model of `cfg` with its weights allocated (not drawn: call
    `init_params`) in `dtype` on `device`; ``device=None`` means CUDA and
    raises without it, the CPU only when asked for.  `remat` (False, True
    or "dots") checkpoints each block in training, as the reference's.
    `kw` goes to `DecoderLM` (``moe_group``, ``moe_cf``) and `Mamba2LM`
    (``ssd_chunk``), as in the reference."""
    if cfg.family in ("dense", "moe"):
        return DecoderLM(cfg, dtype=dtype, device=device, remat=remat, **kw)
    if cfg.family == "ssm":
        return Mamba2LM(cfg, dtype=dtype, device=device, remat=remat, **kw)
    if cfg.family == "hybrid":
        return HybridLM(cfg, dtype=dtype, device=device, remat=remat)
    if cfg.family == "encdec":
        return EncDecLM(cfg, dtype=dtype, device=device, remat=remat)
    if cfg.family == "vlm":
        return VLM(cfg, dtype=dtype, device=device, remat=remat)
    raise ValueError(f"unknown family {cfg.family!r}")
