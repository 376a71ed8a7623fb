"""Deterministic synthetic data pipeline: seeded, checkpointable — the
counterpart of `repro.data.pipeline`.

Every batch is a pure function of (seed, step): the data "cursor" in a
checkpoint is just the step integer, so a restart resumes exactly.  A
background thread computes the next batches while the card steps.  The
numpy calls are the reference's, on `np.random.SeedSequence([seed, step])`,
so tokens, frames and patches are bitwise the reference's.

Token streams are Zipf-distributed over the true vocab (so losses are
non-degenerate); the modality stubs (whisper frames, VLM patches) are unit
Gaussians.  Batches are CPU tensors: int64 tokens and labels (what the
embedding's index and the loss's `take_along_dim` take), float32 stubs;
the train step moves them to the model's device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def synth_batch(cfg: ModelConfig, seed: int, step: int, batch: int,
                seq_len: int) -> Dict[str, torch.Tensor]:
    """Pure (seed, step) -> batch, on the host."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    V = cfg.vocab_size
    # Zipf-ish: sample ranks, then fold them into the vocab
    ranks = rng.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
    toks = torch.from_numpy((ranks - 1) % V)
    out = {"tokens": toks, "labels": toks.clone()}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32))
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.vis_seq, cfg.vis_dim), dtype=np.float32))
    return out


class DataPipeline:
    """Checkpointable iterator with background prefetch."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        s = self.step
        while not self._stop.is_set():
            b = synth_batch(self.cfg, self.seed, s, self.batch, self.seq_len)
            try:
                self._q.put((s, b), timeout=1.0)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self):
        s, b = self._q.get()
        self.step = s + 1
        return b

    def cursor(self) -> int:
        """Checkpointable position: the next step to be consumed."""
        return self.step

    def close(self):
        self._stop.set()
