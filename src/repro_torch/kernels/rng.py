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

`jax_fold_in`, `jax_random_bits`, `jax_uniform` and `jax_normal` are
`jax.random`'s own key stream (jax 0.9, ``jax_threefry_partitionable``
on, its default), read from jax's `_src/prng.py` and `_src/random.py`: a
key is two uint32 words; fold_in hashes (0, data) under it; the bits of an
array of shape s are Threefry of (i >> 32, i & 0xFFFFFFFF) for its
row-major index i, the two words XORed (32-bit) or joined (64-bit); a
uniform fills the mantissa of a float in [1, 2); a normal is
sqrt(2) erfinv(u) with u uniform on (-1, 1), erfinv by XLA's own
polynomials (`xla_erfinv`).  The words and uniforms equal JAX's bit for
bit; the normals differ by a few ulps where XLA fuses the polynomial's
multiply-adds and where its log1p and PyTorch's differ.  `core.sde.sde_solve_fixed(key=...)` draws from them.

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
    hardware instruction.  Its arguments are tree widths and spans, never
    differentiated: under a `torch.func` transform (which wraps every
    tensor, so it has no numpy view) the values go through a list."""
    if x.device.type == "cpu":
        if torch._C._functorch.is_functorch_wrapped_tensor(x):
            return torch.tensor(np.sqrt(np.asarray(x.tolist())),
                                dtype=x.dtype)
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


# ---------------------------------------------------------------------------
# jax.random's key stream (threefry, partitionable layout)
# ---------------------------------------------------------------------------

def jax_key(key):
    """A raw `jax.random` key (two uint32 words, e.g. ``PRNGKey(s)`` as a
    numpy array), or a seed (int): ``PRNGKey(seed)``'s words."""
    if isinstance(key, (int, np.integer)):
        seed = int(key) & 0xFFFFFFFFFFFFFFFF
        return (seed >> 32) & M32, seed & M32
    words = np.asarray(key).reshape(-1)
    if words.shape[0] != 2:
        raise ValueError(f"a raw threefry key has 2 words, got {words.shape}")
    return int(words[0]) & M32, int(words[1]) & M32


def jax_fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``: Threefry of (0, data) under the
    key, as the new key's two words."""
    k0, k1 = jax_key(key)
    c = torch.tensor([[0], [int(data) & M32]], dtype=torch.int64)
    y0, y1 = threefry2x32(k0, k1, c[0], c[1])
    return int(y0[0]), int(y1[0])


def jax_random_bits(key, shape, bit_width: int = 32, device="cpu"):
    """``jax.random.bits(key, shape)`` for 32- or 64-bit words, as int64
    tensors holding the unsigned values (64-bit: two int64 tensors, the
    high and low words)."""
    k0, k1 = jax_key(key)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    b1, b2 = b1.reshape(tuple(shape)), b2.reshape(tuple(shape))
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def jax_uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
                device="cpu"):
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: the
    random mantissa of a float in [1, 2), minus 1, scaled, floored at
    minval."""
    if dtype == torch.float32:
        bits = jax_random_bits(key, shape, 32, device)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        hi, lo = jax_random_bits(key, shape, 64, device)
        f = (((hi << 20) | (lo >> 12)) | 0x3FF0000000000000).view(
            torch.float64)
    else:
        raise TypeError(f"jax_uniform takes float32 or float64, not {dtype}")
    lo_t = torch.tensor(minval, dtype=dtype, device=device)
    hi_t = torch.tensor(maxval, dtype=dtype, device=device)
    return torch.maximum(lo_t, (f - 1.0) * (hi_t - lo_t) + lo_t)


# XLA's erf_inv polynomials (Giles' approximation, as XLA lowers
# chlo.erf_inv; jax's `_src/pallas/utils.py` carries the same constants)
_ERFINV32 = ((2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941),
             (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682))
_ERFINV64_625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GT16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def xla_erfinv(x):
    """erfinv as XLA computes it (float32 or float64): Giles' polynomials
    in w = -log1p(-x^2), by Horner's rule, then times x; ±inf at ±1."""
    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        c = lambda i: torch.where(lt, _ERFINV32[0][i], _ERFINV32[1][i]).to(
            x.dtype)
        p = c(0)
        for i in range(1, 9):
            p = c(i) + p * w
    else:
        lt625, lt16 = w < 6.25, w < 16.0

        def c(i):
            v = torch.full_like(x, _ERFINV64_625[i])
            if i < 19:
                v = torch.where(lt625, v, _ERFINV64_16[i])
            if i < 17:
                v = torch.where(lt16, v, _ERFINV64_GT16[i])
            return v

        w = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, 3.25, 5.0).to(
                            x.dtype))
        p = c(0)
        for i in range(1, 17):
            p = c(i) + p * w
        for i in range(17, 19):
            p = torch.where(lt16, c(i) + p * w, p)
        for i in range(19, 23):
            p = torch.where(lt625, c(i) + p * w, p)
    return torch.where(x.abs() == 1.0, float("inf") * x, p * x)


def jax_normal(key, shape, dtype=torch.float32, device="cpu"):
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) erfinv(u), u
    uniform on [nextafter(-1, 0), 1), with XLA's erfinv (`xla_erfinv`)."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(npd(-1.0), npd(0.0)))
    u = jax_uniform(key, shape, dtype, lo, 1.0, device)
    return float(npd(np.sqrt(2.0))) * xla_erfinv(u)
