"""Model factory: config -> model instance (family dispatch) — the
counterpart of `repro.models.model`."""
from __future__ import annotations

import torch

from .config import ModelConfig
from .lm import DecoderLM

QUEUE_ITEM = "ROADMAP queue 1 item 16"


def build_model(cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """The model of `cfg` with its weights allocated (not drawn: call
    `init_params`) in `dtype` on `device`; ``device=None`` means CUDA and
    raises without it, the CPU only when asked for."""
    if cfg.family == "dense":
        return DecoderLM(cfg, dtype=dtype, device=device)
    if cfg.family in ("moe", "ssm", "hybrid", "encdec", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({QUEUE_ITEM}); the "
            "port builds the dense family")
    raise ValueError(f"unknown family {cfg.family!r}")
