"""The port's transformer building blocks (`repro_torch.models.layers`)
against the reference's (`repro.models.layers`), from the same numpy inputs
in float64 and float32.

Bars, as a fraction of the largest |reference value|:
  - float64 through rmsnorm, rope or attention: 1e-6.  The reference takes
    the norm's statistics and rope's cos/sin in float32 whatever the dtype,
    and XLA's float32 pow/cos/sin and mean differ from PyTorch's by an ulp
    (6e-8; measured 1.1e-7 through rmsnorm and attention);
  - float64 elsewhere (SwiGLU, softcap): 1e-12;
  - float32: 2e-6 (a few float32 ulps through the projections, the softmax
    sums and the rope; measured 2.7e-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as R
import repro_torch.models.layers as P

B, T, D, H, KV, HD = 2, 24, 64, 4, 2, 16
S = 32          # decode cache length
POS = 20        # decode position
KW = dict(n_heads=H, n_kv=KV, hd=HD, rope_theta=1e4)
DTYPES = {"float64": torch.float64, "float32": torch.float32}
ROUNDED = {"float64": 1e-6, "float32": 2e-6}
EXACT = {"float64": 1e-12, "float32": 2e-6}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    w = {"wq": rng.standard_normal((D, H * HD)) / 8,
         "wk": rng.standard_normal((D, KV * HD)) / 8,
         "wv": rng.standard_normal((D, KV * HD)) / 8,
         "wo": rng.standard_normal((H * HD, D)) / 8}
    bias = {"bq": rng.standard_normal(H * HD),
            "bk": rng.standard_normal(KV * HD),
            "bv": rng.standard_normal(KV * HD)}
    mlp = {"wi": rng.standard_normal((D, 32)) / 8,
           "wg": rng.standard_normal((D, 32)) / 8,
           "wo": rng.standard_normal((32, D)) / 8}
    return dict(w=w, bias=bias, mlp=mlp,
                x=rng.standard_normal((B, T, D)),
                x1=rng.standard_normal((B, 1, D)),
                scale=0.1 * rng.standard_normal(D),
                q=rng.standard_normal((B, T, H, HD)),
                ck=rng.standard_normal((B, S, KV, HD)),
                cv=rng.standard_normal((B, S, KV, HD)))


A = _arrays()


def both(a, dtype):
    """The same numpy value(s) as (jax, torch) in `dtype`."""
    if isinstance(a, dict):
        pairs = {k: both(v, dtype) for k, v in a.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return (jnp.asarray(a, dtype=dtype),
            torch.tensor(np.asarray(a), dtype=DTYPES[dtype]))


def assert_rel(want, got, rel):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert want.shape == got.shape
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= rel, f"{err:.3e} > {rel}"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm(dtype):
    (jx, tx), (js, ts) = both(A["x"], dtype), both(A["scale"], dtype)
    got = P.rmsnorm(tx, ts)
    assert got.dtype == DTYPES[dtype]
    assert_rel(R.rmsnorm(jx, js), got, ROUNDED[dtype])


def test_rope_freqs_in_float32():
    jc, js = R.rope_freqs(HD, 1e4, jnp.arange(T))
    for positions in (torch.arange(T), torch.arange(T, dtype=torch.float64)):
        tc, ts = P.rope_freqs(HD, 1e4, positions)
        assert tc.dtype == ts.dtype == torch.float32
        assert_rel(jc, tc, 1e-7)
        assert_rel(js, ts, 1e-7)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope_on_the_same_cos_sin(dtype):
    cos, sin = R.rope_freqs(HD, 1e4, jnp.arange(T))
    jq, tq = both(A["q"], dtype)
    got = P.apply_rope(tq, torch.tensor(np.asarray(cos)),
                       torch.tensor(np.asarray(sin)))
    assert got.dtype == DTYPES[dtype]
    assert_rel(R.apply_rope(jq, cos, sin), got, EXACT[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_soft_cap_and_swiglu(dtype):
    jx, tx = both(5 * A["x"], dtype)
    assert_rel(R._soft_cap(jx, 3.0), P._soft_cap(tx, 3.0), EXACT[dtype])
    assert P._soft_cap(tx, 0.0) is tx
    (jx, tx), (jm, tm) = both(A["x"], dtype), both(A["mlp"], dtype)
    assert_rel(R.swiglu(jx, jm), P.swiglu(tx, tm), EXACT[dtype])


ATTENTION_CASES = {
    "dense": {},
    "q_chunk": {"q_chunk": 8},
    "window-local": {"window": 8, "is_global": False},
    "window-global": {"window": 8, "is_global": True},
    "softcap": {"softcap": 2.0},
    "bias": {"bias": "nonzero"},
    "bidirectional": {"causal": False},
    "q_chunk-window-bias": {"q_chunk": 6, "window": 5, "is_global": False,
                            "bias": "nonzero"},
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_train(case, dtype):
    """Non-zero biases are set in numpy: the reference initialises them to
    zero, which would hide a misplaced bias."""
    (jx, tx), (jw, tw) = both(A["x"], dtype), both(A["w"], dtype)
    jkw, tkw = dict(ATTENTION_CASES[case]), dict(ATTENTION_CASES[case])
    if "bias" in jkw:
        jkw["bias"], tkw["bias"] = both(A["bias"], dtype)
    want = R.attention_train(jx, jw, **KW, **jkw)
    got, (k, v) = P.attention_train(tx, tw, **KW, **tkw, return_kv=True)
    assert got.dtype == DTYPES[dtype]
    assert_rel(want, got, ROUNDED[dtype])
    assert k.shape == v.shape == (B, T, KV, HD)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_core_with_an_offset_is_a_slice_of_the_whole(dtype):
    """`attention_core` on the last rows at their offset equals those rows
    of the whole (what the 32k smoke row holds densely)."""
    tq = both(A["q"], dtype)[1]
    tk, tv = (both(A[n][:, :T], dtype)[1] for n in ("ck", "cv"))
    whole = P.attention_core(tq, tk, tv)
    last = P.attention_core(tq[:, -8:], tk, tv, q_offset=T - 8)
    torch.testing.assert_close(last, whole[:, -8:], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["absolute", "absolute-window", "ring"])
def test_attention_decode(layout, dtype):
    (jx, tx), (jw, tw) = both(A["x1"], dtype), both(A["w"], dtype)
    (jk, tk), (jv, tv) = both(A["ck"], dtype), both(A["cv"], dtype)
    jc = {"k": jk, "v": jv, "pos": jnp.asarray(POS, jnp.int32)}
    tc = {"k": tk, "v": tv, "pos": torch.tensor(POS, dtype=torch.int32)}
    kw = dict(KW)
    if layout == "absolute-window":
        kw.update(window=8, is_global=False)
    if layout == "ring":
        jc["write_idx"] = jnp.asarray(POS % 7, jnp.int32)
        tc["write_idx"] = torch.tensor(POS % 7, dtype=torch.int32)
    want, wc = R.attention_decode(jx, jw, jc, **kw)
    got, gc = P.attention_decode(tx, tw, tc, **kw)
    assert_rel(want, got, ROUNDED[dtype])
    assert gc["k"] is tk and gc["v"] is tv          # written in place
    assert_rel(wc["k"], tk, ROUNDED[dtype])
    assert_rel(wc["v"], tv, EXACT[dtype])
    assert int(gc["pos"]) == int(wc["pos"]) == POS + 1


def test_init_helpers_draw_from_a_generator():
    g = torch.Generator().manual_seed(3)
    a = P.attn_params(g, D, H, KV, HD, torch.float32, qkv_bias=True)
    m = P.mlp_params(g, D, 96, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "wq": (D, H * HD), "wk": (D, KV * HD), "wv": (D, KV * HD),
        "wo": (H * HD, D), "bq": (H * HD,), "bk": (KV * HD,),
        "bv": (KV * HD,)}
    assert all(not a[k].any() for k in ("bq", "bk", "bv"))
    assert {k: v.dtype for k, v in m.items()} == dict.fromkeys(
        ("wi", "wg", "wo"), torch.bfloat16)
    # N(0, 1/fan_in): the sample std of 64 x 64 draws within 10%
    assert abs(float(a["wq"].std()) * D ** 0.5 - 1.0) < 0.1
    assert abs(float(P.dense_init(g, (4096,), torch.float64, scale=0.02)
                     .std()) / 0.02 - 1.0) < 0.1
    again = P.attn_params(torch.Generator().manual_seed(3), D, H, KV, HD,
                          torch.float32, qkv_bias=True)
    assert all(torch.equal(a[k], again[k]) for k in a)


def test_decode_past_the_cache_end_refused_where_the_reference_clamps():
    """A write index past the cache's end: the reference's
    dynamic_update_slice clamps it onto the last slot; the port's in-place
    index_copy_ refuses it (ROADMAP queue 3)."""
    (jx, tx), (jw, tw) = both(A["x1"], "float64"), both(A["w"], "float64")
    (jk, tk), (jv, tv) = both(A["ck"], "float64"), both(A["cv"], "float64")
    pos = S
    _, wc = R.attention_decode(jx, jw, {"k": jk, "v": jv,
                                        "pos": jnp.asarray(pos, jnp.int32)},
                               **KW)
    assert not np.array_equal(np.asarray(wc["v"][:, S - 1]), A["cv"][:, S - 1])
    with pytest.raises(IndexError):
        P.attention_decode(tx, tw, {"k": tk, "v": tv,
                                    "pos": torch.tensor(pos)}, **KW)
