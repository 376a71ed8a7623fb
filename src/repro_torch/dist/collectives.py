"""Gradient-compression collectives: int8 quantization with error feedback
and fixed-size gradient bucketing — the counterpart of
`repro.dist.collectives`.

These are the communication-volume levers for the distributed training
loop: int8 all-reduce payloads are 4x smaller than f32, error feedback
(EF) carries the quantization residual forward so the *sum* of updates
stays unbiased, and bucketing packs a gradient dict into equal-size flat
segments so collective launches amortize over many small leaves.

They act on a dict of tensors (the model's parameters or gradients keyed
by name, nested dicts allowed), leaf by leaf in a fixed order: dict keys
sorted, as the reference's pytree flattening and the checkpoint layer's
(`checkpoint.ckpt`).  No step imports them, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from repro_torch.checkpoint.ckpt import _flatten, _unflatten


class EFState(NamedTuple):
    """Error-feedback residual, one leaf per parameter leaf."""
    residual: Any


def _map(fn, *trees):
    """fn over the leaves of dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ef_init(params: Any) -> EFState:
    """Zero residuals shaped like `params`."""
    return EFState(residual=_map(torch.zeros_like, params))


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric round-to-nearest (half to even) int8 quantization.

    Returns (q int8, scale) with x ≈ q * scale and max error ≤ scale/2
    (before the product's own rounding).
    """
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones((), dtype=x.dtype, device=x.device))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(x.dtype)


def ef_compress(grads: Any, state: EFState) -> Tuple[Any, EFState]:
    """Quantize (grads + residual) leafwise; return the dequantized updates
    and the new residual state.  sum(updates) over steps converges to
    sum(grads)."""
    def one(g, r):
        x = g + r
        q, s = _quant_int8(x)
        deq = q.to(x.dtype) * s
        return deq, x - deq

    def part(t, i):
        if isinstance(t, dict):
            return {k: part(v, i) for k, v in t.items()}
        return t[i]

    pairs = _map(one, grads, state.residual)
    return part(pairs, 0), EFState(residual=part(pairs, 1))


def bucketize(tree: Any, bucket_bytes: int
              ) -> Tuple[List[torch.Tensor],
                         Callable[[List[torch.Tensor]], Any]]:
    """Pack a dict of tensors into ~`bucket_bytes` flat 1-D buckets.

    Returns (buckets, unpack) where `unpack(buckets)` restores the original
    structure, shapes and dtypes.  Buckets split on element boundaries of
    the flattened concatenation (a leaf may span buckets), so every bucket
    except the last has exactly `bucket_bytes // itemsize` elements — the
    fixed-size payload a fused all-reduce wants.
    """
    leaves, spec = _flatten(tree)
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    ctype = functools.reduce(torch.promote_types, dtypes)
    flat = torch.cat([l.reshape(-1).to(ctype) for l in leaves])
    per = max(1, bucket_bytes // flat.element_size())
    buckets = [flat[i:i + per] for i in range(0, flat.shape[0], per)]

    def unpack(bs: List[torch.Tensor]) -> Any:
        whole = torch.cat(list(bs))
        out, off = [], 0
        for shape, dtype, size in zip(shapes, dtypes, sizes):
            out.append(whole[off:off + size].reshape(shape).to(dtype))
            off += size
        return _unflatten(spec, out)

    return buckets, unpack
