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

The tensor-core form of the kernel (csrc/flash_attention_sm90.cu, bfloat16
at hd 64 and 128) scales the float32 scores and rounds P to bfloat16
before P V.  Rounding P moves o by at most u·Σ p_j|v_j|/l ≤ u·max|v|
(u = 2^-8, bfloat16's unit roundoff), and each of two output roundings by
u·|o| ≤ u·max|v|; so it is held within 3·2^-8·max|v| elementwise and 2^-8
by relative norm (two independent roundings of rms 2^-8/√3 give ≈ 3.2e-3).
Here an arithmetic model of that form (`_sm90_model`) shows that the bar
holds against the plain version and the reference.  The .cu sources are
parsed for their instantiations and C entries.
"""
import ctypes
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn.ops import flash_attention as ref_flash
from repro.kernels.flashattn.ref import ref_attention as ref_dense
from repro_torch.kernels.flashattn import kernel as fk
from repro_torch.kernels.flashattn.kernel import flash_attention_plain
from repro_torch.kernels.flashattn.ops import flash_attention, pad_to_blocks
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


# ---------------------------------------------------------------------------
# the tensor-core form's bar, on an arithmetic model of its rounding
# ---------------------------------------------------------------------------

U_BF16 = 2.0 ** -8
SM90_ELEM = 3 * U_BF16        # of max|v|
SM90_REL = U_BF16             # relative Frobenius norm
# (B, T, H, KV, hd, causal): GQA g = 1, 2, 8, ragged T = 40 and 1000, and
# non-causal, at the tensor-core form's head dims
SM90_CASES = {
    "g1-T1000-hd64": (1, 1000, 4, 4, 64, True),
    "g2-T1000-hd128": (1, 1000, 4, 2, 128, True),
    "g8-T1000-hd128": (1, 1000, 8, 1, 128, True),
    "g2-T40-hd128": (2, 40, 4, 2, 128, True),
    "g8-T40-hd64": (1, 40, 8, 1, 64, True),
    "noncausal-T256-hd128": (1, 256, 4, 2, 128, False),
    "noncausal-T40-hd64": (1, 40, 2, 2, 64, False),
}


def _sm90_inputs(case, seed=3):
    B, T, H, KV, hd, _ = SM90_CASES[case]
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, T, H, hd)),
              rng.standard_normal((B, T, KV, hd)),
              rng.standard_normal((B, T, KV, hd)))
    return _as_dtype(arrays, "bfloat16")


def _sm90_model(q, k, v, causal):
    """The tensor-core form's arithmetic, densely: float32 scores of the
    bfloat16 inputs scaled by hd^-0.5 after the product, masked to -1e30,
    exp against the row max, l from the float32 P, P rounded to bfloat16
    for P V (float32 sums), o = acc / max(l, 1e-30) rounded once."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    kv_of = torch.arange(H) // (H // KV)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)[:, kv_of]
    vf = v.float().permute(0, 2, 1, 3)[:, kv_of]
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / float(hd) ** 0.5)
    if causal:
        s = torch.where(torch.arange(S)[None, :] <= torch.arange(T)[:, None],
                        s, fk.MASKED)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = p.to(torch.bfloat16).float() @ vf
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3)


def _sm90_errs(got, want, v):
    d = got.double() - want.double()
    return (float(d.abs().max() / v.double().abs().max()),
            float(d.norm() / want.double().norm()))


@functools.cache
def _sm90_reference(case):
    causal = SM90_CASES[case][5]
    _, (q, k, v) = _sm90_inputs(case)
    return np.asarray(ref_flash(q, k, v, causal=causal).astype(jnp.float64))


@pytest.mark.parametrize("against", ["plain", "reference"])
@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_bar_holds_on_a_model_of_its_rounding(case, against):
    """The model of the tensor-core form lies within 3·2^-8·max|v| and
    2^-8 by relative norm of the plain version (on the padded inputs, as
    the wrapper calls it) and of the reference's Pallas kernel."""
    causal = SM90_CASES[case][5]
    (q, k, v), _ = _sm90_inputs(case)
    T = q.shape[1]
    qp, kp, vp, bq, bk = pad_to_blocks(q, k, v, causal=causal)
    got = _sm90_model(qp, kp, vp, causal)[:, :T]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    if against == "plain":
        want = flash_attention_plain(qp, kp, vp, causal=causal, block_q=bq,
                                     block_k=bk)[:, :T]
    else:
        want = torch.from_numpy(_sm90_reference(case))
    elem, rel = _sm90_errs(got, want, v)
    assert elem <= SM90_ELEM and rel <= SM90_REL, (elem, rel)


def test_sm90_bar_sees_a_two_percent_scale_fault():
    """The relative-norm bar passes the model and fails the same output
    scaled by 1.02, a fault of the size of P's rounding summed coherently
    (an l taken from a wrongly scaled P, say)."""
    (q, k, v), _ = _sm90_inputs("g2-T1000-hd128")
    qp, kp, vp, bq, bk = pad_to_blocks(q, k, v)
    want = flash_attention_plain(qp, kp, vp, block_q=bq, block_k=bk)
    got = _sm90_model(qp, kp, vp, True)
    off = (got.float() * 1.02).to(torch.bfloat16)
    assert max(_sm90_errs(got, want, vp)) <= SM90_REL
    assert _sm90_errs(off, want, vp)[1] > SM90_REL


@pytest.mark.parametrize("dtype,hd,form", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 256, "cuda_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float64, 64, "cuda_core")])
def test_form_is_chosen_from_dtype_and_head_dim(dtype, hd, form):
    assert fk.form_of(dtype, hd) == form


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    (q, k, v), _ = _sm90_inputs("g2-T40-hd128")
    before = (fk.launches, fk.launches_sm90)
    got = fk.flash_attention_kernel(q, k, v, block_q=40, block_k=40)
    assert (fk.launches, fk.launches_sm90) == before
    assert torch.equal(got, flash_attention_plain(q, k, v, block_q=40,
                                                  block_k=40))


# ---------------------------------------------------------------------------
# the .cu sources: instantiations and C entries
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "const void*": ctypes.c_void_p, "void*": ctypes.c_void_p}


def _entry(source, name):
    """(argument C types, body) of the extern "C" function `name`."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)\s*\{(.*?)\n\}",
                  text, re.S)
    assert m, f"{name} not found in {source}"
    args = [re.sub(r"\s+", " ", a.strip()).rsplit(" ", 1)[0]
            .replace(" *", "*") for a in m.group(1).split(",")]
    return args, m.group(2)


@pytest.mark.parametrize("source,name", [
    (fk.SOURCE, "flash_attention_launch"),
    (fk.SM90_SOURCE, "flash_attention_sm90_launch")])
def test_c_entry_arguments_match_the_ctypes_binding(source, name):
    args, _ = _entry(source, name)
    assert [C_TYPES[a] for a in args] == list(fk.ARGTYPES), args


def test_sm90_instantiations_equal_the_wrappers_table():
    """The tensor-core entry takes one dtype id and the head dims of its
    switch; with the kernel's template arguments they are the wrapper's
    SM90_HEAD_DIMS."""
    _, body = _entry(fk.SM90_SOURCE, "flash_attention_sm90_launch")
    dtype_ids = [int(x) for x in re.findall(r"dtype_id != (\d+)", body)]
    ids = {i: dt for dt, i in fk.DTYPE_IDS.items()}
    cases = [int(x) for x in re.findall(r"case (\d+):", body)]
    templated = [int(x) for x in re.findall(r"by_causal<(\d+)>", body)]
    assert cases == templated
    assert {ids[i]: tuple(cases) for i in dtype_ids} == fk.SM90_HEAD_DIMS


def test_cuda_core_instantiations_equal_the_wrappers_head_dims():
    text = (CSRC / fk.SOURCE).read_text()
    by_hd = text[text.index("int by_hd("):]
    by_hd = by_hd[:by_hd.index("\n}\n")]
    assert tuple(int(x) for x in re.findall(r"case (\d+):", by_hd)) \
        == fk.HEAD_DIMS


@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_gradient_refused_on_both_devices(needs_grad):
    """K7 is forward only, as the reference's Pallas kernel: an input that
    requires grad with grad mode on raises (the CUDA form would give an
    output with no gradient, the plain version one K7 lacks); under
    no_grad, or with no input requiring grad, it runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, 2, 16, generator=g) for _ in range(3))
    args = dict(q=q, k=k, v=v)
    args[needs_grad] = args[needs_grad].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="dense attention core"):
        flash_attention(**args)
    with torch.no_grad():
        out = flash_attention(**args)
    assert not out.requires_grad
    assert torch.equal(out, flash_attention(q, k, v))
