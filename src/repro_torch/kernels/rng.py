"""Counter-based RNG for in-kernel noise (paper §6.8) — the plain PyTorch
versions of `repro.kernels.rng`'s Threefry-2x32-20 and its Box–Muller
normals, which the CUDA kernel (`csrc/sde_ensemble.cu`) draws on the card.

CPU PyTorch has no add or shift on ``uint32``, so every word here is an
``int64`` tensor holding a value in [0, 2^32), and every add, multiply and
shift is masked back to 32 bits: the same words as native ``uint32``
arithmetic, bit for bit.  The normals are computed in float32 whatever the
requested dtype, then cast, as the reference does (its ``jnp.log`` and
``jnp.cos`` run on float32 inputs); ``2π`` is rounded to float32 first, as
JAX rounds the weakly typed Python constant.

The virtual Brownian tree (`bridge_normals`, `brownian_bridge_point`) is
the adaptive SDE kernel's noise (`csrc/sde_adaptive_ensemble.cu`): the same
Threefry core keyed with a second key word of its own, and a `depth`-level
Lévy-bridge descent that makes W a pure function of (seed; lane, row,
dyadic index).
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# second key word of the fixed-dt stream and the counter's step stride
STREAM_KEY = 0x243F6A88
STEP_STRIDE = 0x9E3779B9
# second key word of the virtual Brownian tree's stream; its counter is
# node·STEP_STRIDE + row
BRIDGE_KEY = 0x85A308D3
# 2π rounded to float32 (6.2831855), the constant the reference multiplies by
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def check_u32(what: str, v) -> int:
    """`v` as a Python int, which must fit a uint32 counter or key word."""
    v = int(v)
    if not 0 <= v < 2 ** 32:
        raise ValueError(f"{what} must lie in [0, 2^32), got {v}")
    return v


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: int, k1: int, c0, c1):
    """Threefry-2x32, 20 rounds.  k0, k1: Python ints (the key words);
    c0, c1: int64 tensors of uint32 values (broadcastable).  Returns two
    int64 tensors of uint32 values of the broadcast shape."""
    ks0 = int(k0) & M32
    ks1 = int(k1) & M32
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0 = (c0 + ks0) & M32
    x1 = (c1 + ks1) & M32
    subkeys = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2), (ks2, ks0))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        a, b = subkeys[i]
        x0 = (x0 + a) & M32
        x1 = (x1 + ((b + i + 1) & M32)) & M32
    return x0, x1


def _to_unit(bits):
    """uint32 words -> float32 in (0, 1]: (bits + 0.5) / 2^32."""
    return (bits.to(torch.float32) + 0.5) * (2.0 ** -32)


def counter_words(seed: int, step, lane_idx, row_idx):
    """The two Threefry words behind `counter_normals_threefry`: key
    (seed, STREAM_KEY), counters (step·STEP_STRIDE + row, lane), all mod
    2^32.  `step` is a Python int or an int64 tensor (values below 2^31);
    lane_idx and row_idx are int64 tensors, broadcastable."""
    if isinstance(step, int):
        base = (step * STEP_STRIDE) & M32
    else:
        base = (step.to(torch.int64) * STEP_STRIDE) & M32
    c0 = (base + row_idx) & M32
    c1 = lane_idx & M32
    return threefry2x32(seed, STREAM_KEY, c0, c1)


def counter_normals_threefry(seed: int, step, lane_idx, row_idx,
                             dtype=torch.float32):
    """N(0,1) draws indexed by (seed; step, noise-row, lane) — one value per
    (row_idx, lane_idx) element via Box–Muller on two Threefry words.

    lane_idx: int64 tensor of global trajectory indices (uint32 values).
    row_idx:  int64 tensor of noise-component indices, broadcastable.
    """
    return _box_muller(*counter_words(seed, step, lane_idx, row_idx), dtype)


def sqrt_rn(x):
    """The correctly rounded square root, as XLA's and CUDA's are.
    PyTorch's CPU sqrt misses it by one ulp on some float64 inputs (at
    every ATen CPU capability), so on the CPU this takes numpy's, the
    hardware instruction."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def _box_muller(x0, x1, dtype):
    """float32 Box–Muller on two words, then cast to `dtype`."""
    u1 = _to_unit(x0)
    u2 = _to_unit(x1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)
    return z.to(dtype)


def bridge_words(seed: int, node, lane_idx, row_idx):
    """The two Threefry words behind `bridge_normals`: key (seed,
    BRIDGE_KEY), counters (node·STEP_STRIDE + row, lane), all mod 2^32.
    node, lane_idx and row_idx are int64 tensors of uint32 values,
    broadcastable."""
    c0 = (((node * STEP_STRIDE) & M32) + row_idx) & M32
    return threefry2x32(seed, BRIDGE_KEY, c0, lane_idx & M32)


def bridge_normals(seed: int, node, lane_idx, row_idx, dtype=torch.float32):
    """N(0,1) draws for the virtual Brownian bridge, indexed by
    (seed; tree node, noise row, lane): the Threefry core of
    `counter_normals_threefry` under the second key word BRIDGE_KEY, so the
    bridge stream is independent of the fixed-dt stream of the same seed."""
    return _box_muller(*bridge_words(seed, node, lane_idx, row_idx), dtype)


def brownian_bridge_point(seed: int, idx, lane_idx, row_idx, *, depth: int,
                          t_total, dtype=torch.float32):
    """W(idx · t_total / 2**depth) of a standard Wiener path on [0, t_total].

    The path is a virtual Brownian tree (Lévy bridge construction): W is a
    pure function of (seed; lane, row, dyadic index), evaluated by
    descending `depth` levels of midpoint-conditioned draws, so a rejected
    step retried with a smaller dt replays exactly the same increments.
    W(0) == 0 exactly, and conditionally on W(l) and W(r) of an enclosing
    dyadic interval the midpoint is N((W(l) + W(r))/2, (t_r - t_l)/4).

    idx, lane_idx, row_idx: int64 tensors of uint32 values, broadcastable;
    idx in [0, 2**depth].  t_total: a Python float or 0-d tensor (rounded to
    `dtype`).  Every operation is rounded on its own, in the reference's
    order, with a correctly rounded sqrt (`sqrt_rn`); the normals are
    float32, cast to `dtype`.  Cost: depth + 1
    Threefry evaluations per point.
    """
    shape = torch.broadcast_shapes(idx.shape, lane_idx.shape, row_idx.shape)
    dev = idx.device
    idx = idx.expand(shape)
    t_total = torch.as_tensor(t_total, dtype=dtype, device=dev)
    h_res = t_total / (2 ** depth)
    # The walk down the tree depends on idx alone.  Level d halves an
    # interval (l, r] of width 2^(depth-d) that holds idx and goes left
    # where idx <= mid: the bits of j = max(idx - 1, 0) from the top, so
    # the heap id of level d is 2^d | j >> (depth - d) and the walk ends at
    # l = j (idx = 0 ends at l = 0).  Every node's normal is drawn at once
    # (node 0 is the endpoint); then the midpoint recurrence runs level by
    # level in the reference's order.
    lev = torch.arange(depth, dtype=torch.int64, device=dev).reshape(
        (depth,) + (1,) * len(shape))
    j = torch.clamp(idx - 1, min=0)[None]
    nodes = torch.cat([torch.zeros((1,) + tuple(shape), dtype=torch.int64,
                                   device=dev),
                       (1 << lev) | (j >> (depth - lev))])
    go_left = ((j >> (depth - 1 - lev)) & 1) == 0
    z = bridge_normals(seed, nodes, lane_idx.expand(shape)[None],
                       row_idx.expand(shape)[None], dtype)
    # the conditional standard deviation of each level's midpoint, halved:
    # 0.5 sqrt(h) with h = (r - l) h_res
    width = (2 ** (depth - torch.arange(depth, device=dev))).to(dtype)
    half_sd = 0.5 * sqrt_rn(width * h_res)
    z_end, *z_lev = z.unbind(0)
    # the endpoint draw: W(t_total) ~ N(0, t_total)
    w_l = torch.zeros(shape, dtype=dtype, device=dev)
    w_r = sqrt_rn(t_total) * z_end
    for s, zd, left in zip(half_sd.unbind(0), z_lev, go_left.unbind(0)):
        # the midpoint conditioned on the endpoints: variance h/4
        w_mid = 0.5 * (w_l + w_r) + s * zd
        w_r = torch.where(left, w_mid, w_r)
        w_l = torch.where(left, w_l, w_mid)
    return torch.where(idx == 0, w_l, w_r)
