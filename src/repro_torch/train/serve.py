"""Serving step factories: prefill (prompt -> cache) and decode (one token)
— the counterpart of `repro.train.serve` for ``mesh=None``.

`make_serve_plan` returns the two steps of a served model, each run under
`torch.inference_mode()`.  The reference jit-compiles them; PyTorch runs
eagerly.  Its decode donates the cache: the port's `decode_step` writes the
cache in place.  Every family serves (`models.model.build_model`).  A
device mesh (the reference's sharded plan, the LM's model sharding on
`models/sharding.py`) waits for ROADMAP queue 1 item 16.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass
class ServePlan:
    prefill_fn: Callable[..., Any]   # batch -> (last logits, cache)
    decode_fn: Callable[..., Any]    # (cache, tokens) -> (logits, cache)


def make_serve_plan(model, mesh, batch: int, cache_len: int) -> ServePlan:
    """The prefill and decode steps of `model` for `batch` requests and a
    `cache_len`-token cache.  ``mesh`` must be None; as in the reference,
    the unsharded plan leaves ``model.q_chunk`` as it is."""
    if mesh is not None:
        raise NotImplementedError("make_serve_plan runs unsharded (mesh=None)"
                                  "; a device mesh (model sharding on "
                                  "models/sharding.py) waits for ROADMAP "
                                  "queue 1 item 16")

    def prefill_fn(b):
        with torch.inference_mode():
            return model.prefill(b, cache_len=cache_len)

    def decode_fn(cache, tokens):
        with torch.inference_mode():
            return model.decode_step(cache, tokens)

    return ServePlan(prefill_fn, decode_fn)
