"""The port's flash attention (its plain version on the CPU) against the
reference's Pallas kernel (interpret mode on the CPU, as
tests/test_flashattn.py runs it) and the dense oracles, on the reference
test's ten cases, from the same numpy inputs.

Bars: float32 inputs within 1e-5 (both compute in float32 from the same
inputs; only the order of the sums differs, and the reference's own bar
against the dense oracle is 2e-5); float64 inputs within 1e-6 (computed in
float32 by both, as the reference's astype(float32) does; the reference
test's own f64 bar); bfloat16 inputs within 2 bfloat16 ulps of the
reference's value (both round a float32 result once; the float32 values
may straddle a rounding boundary, one ulp, and the second ulp covers their
float32 difference on outputs far below the tensor's scale, where the ulp
is measured at 2^-8 of the largest |value|).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn.ops import flash_attention as ref_flash
from repro.kernels.flashattn.ref import ref_attention as ref_dense
from repro_torch.kernels.flashattn.kernel import flash_attention_plain
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.kernels.flashattn.ref import bf16_ulps, ref_attention

# the reference test's cases: (B, T, S, H, KV, hd, dtype, causal, bq, bk)
CASES = {
    "causal-64-16-16": (2, 64, 64, 4, 2, 32, "float32", True, 16, 16),
    "causal-64-32-16": (2, 64, 64, 4, 2, 32, "float32", True, 32, 16),
    "causal-48-16-16": (2, 48, 48, 4, 2, 32, "float32", True, 16, 16),
    "causal-128-64-32": (2, 128, 128, 4, 2, 32, "float32", True, 64, 32),
    "gqa-4-4": (1, 32, 32, 4, 4, 16, "float32", True, 16, 16),
    "gqa-4-1": (1, 32, 32, 4, 1, 16, "float32", True, 16, 16),
    "gqa-8-2": (1, 32, 32, 8, 2, 16, "float32", True, 16, 16),
    "noncausal": (1, 32, 32, 2, 2, 16, "float32", False, 16, 16),
    "f64": (1, 32, 32, 2, 1, 16, "float64", True, 16, 16),
    "ragged-T-40": (1, 40, 40, 2, 2, 16, "float64", True, 16, 16),
}
TOL = {"float32": 1e-5, "float64": 1e-6}


def _inputs(case, seed=0):
    B, T, S, H, KV, hd = CASES[case][:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)),
            rng.standard_normal((B, S, KV, hd)),
            rng.standard_normal((B, S, KV, hd)))


def _as_dtype(arrays, dtype):
    """The same values in both packages: bfloat16 rounds once (in torch),
    and the reference receives the rounded values."""
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    js = [jnp.asarray(t.double().numpy()).astype(dtype) for t in ts]
    return ts, js


@functools.cache
def _reference(case, dtype):
    causal, bq, bk = CASES[case][7:]
    _, (q, k, v) = _as_dtype(_inputs(case), dtype)
    out = ref_flash(q, k, v, causal=causal, block_q=bq, block_k=bk)
    return np.asarray(out.astype(jnp.float64))


def _port(case, dtype):
    causal, bq, bk = CASES[case][7:]
    (q, k, v), _ = _as_dtype(_inputs(case), dtype)
    out = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert out.dtype == q.dtype and out.shape == q.shape
    return out.double().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_reference(case):
    dtype = CASES[case][6]
    got, want = _port(case, dtype), _reference(case, dtype)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_bf16_within_two_ulps(case):
    got, want = _port(case, "bfloat16"), _reference(case, "bfloat16")
    assert bf16_ulps(torch.from_numpy(got), torch.from_numpy(want)) <= 2.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_oracles_agree(case):
    """The port's `ref_attention` against the reference's, and the port's
    flash attention against its own oracle at the reference test's bar."""
    B, T, S, H, KV, hd, dtype, causal = CASES[case][:8]
    (q, k, v), (jq, jk, jv) = _as_dtype(_inputs(case), dtype)
    mine = ref_attention(q, k, v, causal=causal).double().numpy()
    theirs = np.asarray(ref_dense(jq, jk, jv, causal=causal)
                        .astype(jnp.float64))
    np.testing.assert_allclose(mine, theirs, rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(_port(case, dtype), mine, rtol=2e-5,
                               atol=2e-5)


def test_ragged_long_rows_and_head_dims():
    """T = 1000 (ragged against every block), g = 1, 2, 8 and hd 64..256
    on the plain version against the dense oracle (2e-5, float32)."""
    rng = np.random.default_rng(7)
    for H, KV, hd in ((2, 2, 64), (4, 2, 128), (8, 1, 256)):
        q, k, v = (torch.from_numpy(rng.standard_normal(s)).float()
                   for s in ((1, 1000, H, hd), (1, 1000, KV, hd),
                             (1, 1000, KV, hd)))
        torch.testing.assert_close(flash_attention(q, k, v),
                                   ref_attention(q, k, v), rtol=2e-5,
                                   atol=2e-5)


def test_noncausal_padding_refused():
    q = torch.zeros(1, 40, 2, 16)
    with pytest.raises(NotImplementedError, match="length mask"):
        flash_attention(q, q, q, causal=False, block_q=16, block_k=16)


def test_plain_version_asserts_block_multiples():
    q = torch.zeros(1, 40, 2, 16)
    with pytest.raises(AssertionError):
        flash_attention_plain(q, q, q, block_q=16, block_k=16)
