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
still to port, with the adaptive SDE kernel.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# second key word of the fixed-dt stream and the counter's step stride
STREAM_KEY = 0x243F6A88
STEP_STRIDE = 0x9E3779B9
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
    x0, x1 = counter_words(seed, step, lane_idx, row_idx)
    u1 = _to_unit(x0)
    u2 = _to_unit(x1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)
    return z.to(dtype)
