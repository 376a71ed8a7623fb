"""The port's counter RNG (`repro_torch.kernels.rng`) against the reference's
(`repro.kernels.rng`): Threefry-2x32-20 words bitwise, Box–Muller normals
within float32 rounding of log and cos, and the CUDA source's constants
equal to the Python ones.  The kernel's own normals need the card:
tests/test_torch_cuda.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rng as jrng
from repro_torch.kernels import rng as trng
from repro_torch.kernels.build import NVCC_FLAGS
from repro_torch.kernels.em import kernel as sde_kernel

# the fixed-dt kernel and the generator header it includes
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
CU = "".join((CSRC / f).read_text() for f in ("sde_ensemble.cu",
                                              "threefry.cuh"))
# Both packages compute the normals in float32; XLA-CPU's and PyTorch's f32
# log/cos differ by a few ulps on some inputs (4.77e-7 absolute at most on
# 1.6e6 draws), so normals are held to 2e-6 absolute, words to equality.
NORMAL_TOL = 2e-6


def _grid(steps, rows, lanes, lane_offset):
    step = np.asarray(steps, np.int64)[:, None, None]
    row = np.arange(rows, dtype=np.int64)[None, :, None]
    lane = ((np.arange(lanes, dtype=np.int64) + lane_offset)
            % 2 ** 32)[None, None, :]
    return np.broadcast_arrays(step, row, lane)


def test_threefry_words_bitwise_on_random_counters():
    rng = np.random.default_rng(0)
    c0 = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    for k0, k1 in ((0, 0), (7, 0x243F6A88), (2 ** 32 - 1, 0x85A308D3)):
        want = jrng.threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                                 jnp.asarray(c0), jnp.asarray(c1))
        got = trng.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                                torch.from_numpy(c1.astype(np.int64)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("step0,lane_offset", [
    (0, 0), (12345, 77), (2 ** 31 - 3, 0), (5, 2 ** 32 - 100)])
def test_counter_stream_words_bitwise_and_normals_close(step0, lane_offset):
    """Steps up to 2^31 - 1 and lane indices that wrap past 2^32."""
    seed, steps, rows, lanes = 11, 3, 8, 256
    step, row, lane = _grid(range(step0, step0 + steps), rows, lanes,
                            lane_offset)
    c0 = ((step.astype(np.uint64) * 0x9E3779B9 + row.astype(np.uint64))
          % 2 ** 32).astype(np.uint32)
    want = jrng.threefry2x32(jnp.uint32(seed), jnp.uint32(0x243F6A88),
                             jnp.asarray(c0),
                             jnp.asarray(lane.astype(np.uint32)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = trng.counter_words(seed, t(step), t(lane), t(row))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))

    zj = np.stack([np.asarray(jrng.counter_normals_threefry(
        seed, s, jnp.asarray(lane[i].astype(np.uint32)),
        jnp.asarray(row[i].astype(np.uint32)), jnp.float64))
        for i, s in enumerate(range(step0, step0 + steps))])
    zt = np.stack([trng.counter_normals_threefry(
        seed, s, t(lane[i]), t(row[i]), torch.float64).numpy()
        for i, s in enumerate(range(step0, step0 + steps))])
    np.testing.assert_allclose(zt, zj, rtol=0, atol=NORMAL_TOL)
    # float32 values cast to float64, as in the reference
    np.testing.assert_array_equal(zt, zt.astype(np.float32))


def test_counter_normals_are_standard_normal():
    lane = torch.arange(2 ** 16, dtype=torch.int64)
    z = trng.counter_normals_threefry(3, 0, lane, torch.zeros_like(lane),
                                      torch.float64).numpy()
    assert abs(z.mean()) < 5 / np.sqrt(z.size)
    assert abs(z.var() - 1.0) < 5 * np.sqrt(2.0 / z.size)


def test_sde_normals_wrapper_on_cpu_is_the_plain_stream():
    """`sde_normals(device="cpu")` — the plain version the card's
    `sde_normals_launch` is held to — equals the element-wise stream."""
    seed, step0, steps, rows, lanes, off = 9, 2 ** 31 - 4, 4, 3, 40, \
        2 ** 32 - 17
    words, z = sde_kernel.sde_normals(seed, step0, steps, rows, lanes,
                                      lane_offset=off, device="cpu")
    assert tuple(words.shape) == (2, steps, rows, lanes)
    assert tuple(z.shape) == (steps, rows, lanes) and z.dtype == torch.float32
    step, row, lane = (torch.from_numpy(np.ascontiguousarray(a))
                       for a in _grid(range(step0, step0 + steps), rows,
                                      lanes, off))
    w0, w1 = trng.counter_words(seed, step, lane, row)
    assert torch.equal(words[0], w0) and torch.equal(words[1], w1)
    assert int(lane.min()) == 0 and int(lane.max()) == 2 ** 32 - 1
    for s in range(steps):
        want = trng.counter_normals_threefry(seed, step0 + s, lane[s],
                                             row[s])
        assert torch.equal(z[s], want)
    with pytest.raises(ValueError, match="2\\^32"):
        sde_kernel.sde_normals(2 ** 32, 0, 1, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="block"):
        sde_kernel.sde_normals(0, 2 ** 31 - 1, 2, 1, 1, device="cpu")


def test_cuda_source_constants_equal_the_python_ones():
    def const(name):
        return re.search(rf"{name}\s*=\s*([0-9A-Fa-fx.e+-]+)f?u?;", CU).group(1)
    assert int(const("kStreamKey").rstrip("u"), 16) == trng.STREAM_KEY
    assert int(const("kStepStride").rstrip("u"), 16) == trng.STEP_STRIDE
    assert int(const("kParity").rstrip("u"), 16) == trng._PARITY
    two_pi = np.float32(float(const("kTwoPiF32").rstrip("f")))
    assert two_pi == np.float32(2 * np.pi) == np.float32(trng.TWO_PI_F32)
    assert float(const("kTwoM32").rstrip("f")) == 2.0 ** -32
    # the reference's rotation schedule, in the .cu's mix4 calls
    rots = re.findall(r"mix4<(\d+), (\d+), (\d+), (\d+)>\(x0, x1\)", CU)
    assert [tuple(map(int, r)) for r in rots] == \
        [trng._ROTATIONS[i % 2] for i in range(5)]
    # the approximate intrinsics would move every normal
    assert not any("fast_math" in flag for flag in NVCC_FLAGS)


# ---------------------------------------------------------------------------
# jax.random's own key stream (sde_solve_fixed(key=...))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
def test_jax_fold_in_and_bits_bitwise(seed):
    import jax
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 7, 123_456, 2 ** 32 - 1):
        want = tuple(int(w) for w in np.asarray(jax.random.fold_in(key,
                                                                   data)))
        assert trng.jax_fold_in(np.asarray(key), data) == want
    sub = jax.random.fold_in(key, 5)
    for shape in ((1,), (7,), (3, 5), (2, 3, 4)):
        got = trng.jax_random_bits(np.asarray(sub), shape)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.bits(sub, shape, jnp.uint32)))
        hi, lo = trng.jax_random_bits(np.asarray(sub), shape, 64)
        joined = ((hi.numpy().astype(np.uint64) << np.uint64(32))
                  | lo.numpy().astype(np.uint64))
        np.testing.assert_array_equal(
            joined, np.asarray(jax.random.bits(sub, shape, jnp.uint64)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jax_uniform_bitwise_and_normal_within_ulps(dtype):
    """Uniforms on [0, 1) bit for bit, on a range within one ulp; normals
    within 2 (float32) and 16 (float64)
    ulps of max(|z|, 1): XLA's erfinv polynomials are ported, but XLA's
    log1p differs from PyTorch's (by up to 128 ulps of w in float64)."""
    import jax
    tdt = getattr(torch, dtype)
    key = jax.random.fold_in(jax.random.PRNGKey(11), 2)
    shape = (4, 5000)
    jdt = getattr(jnp, dtype)
    np.testing.assert_array_equal(
        trng.jax_uniform(np.asarray(key), shape, tdt).numpy(),
        np.asarray(jax.random.uniform(key, shape, jdt)))
    # on a range XLA fuses floats * (max - min) + min: one ulp at most
    want = np.asarray(jax.random.uniform(key, shape, jdt, -0.5, 2.0))
    got = trng.jax_uniform(np.asarray(key), shape, tdt, -0.5, 2.0).numpy()
    assert float((np.abs(got - want) / np.spacing(
        np.maximum(np.abs(want), 0.5).astype(want.dtype))).max()) <= 1
    want = np.asarray(jax.random.normal(key, shape, getattr(jnp, dtype)))
    got = trng.jax_normal(np.asarray(key), shape, tdt).numpy()
    ulps = np.abs(got - want) / np.spacing(
        np.maximum(np.abs(want), 1).astype(want.dtype))
    assert float(ulps.max()) <= (2 if dtype == "float32" else 16)
    assert abs(float(got.mean())) < 0.02 and abs(float(got.std()) - 1) < 0.02
