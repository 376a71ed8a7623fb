"""The port's Mamba-2 SSD layer (`repro_torch.models.ssm`) against the
reference's (`repro.models.ssm`), from the same numpy inputs.

Bars, as a fraction of the largest |reference value|:
  - `ssd_chunked` in float64 on the reference test's cases
    (`tests/test_models_parts.py:35`), with and without a carried h0:
    1e-12 (the same operations; sums in other orders);
  - `_causal_conv`: 1e-15 (the same adds in the same order);
  - the layers in float64: 1e-6.  dt = softplus(x @ w_dt) is taken in
    float32 in both (and the decode step runs in float32), and XLA's
    float32 exp and log1p differ from PyTorch's by an ulp (6e-8).
The split of prefill and decode (`tests/test_models_parts.py:51`) holds in
the port alone at 1e-12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as R
import repro_torch.models.ssm as P
from repro_torch.configs.archs import get_arch

CASES = [(8, 4), (16, 8), (12, 12), (16, 4)]
CFG = dataclasses.replace(get_arch("mamba2-2.7b-smoke"), d_model=32,
                          ssm_state=8, ssm_head_dim=8)   # H = 8, P = 8
LAYER_BAR = 1e-6


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    assert want.shape == np.shape(got)
    return np.abs(want - got).max() / np.abs(want).max()


def _ssd_inputs(T, seed=0, Bsz=2, H=3, P_=4, N=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bsz, T, H, P_))
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, T, H))))
    B_in = rng.standard_normal((Bsz, T, N))
    C_in = rng.standard_normal((Bsz, T, N))
    A = -np.exp(np.linspace(-1.0, 0.5, H))
    h0 = rng.standard_normal((Bsz, H, P_, N))
    return xh, dt, B_in, C_in, A, h0


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T,chunk", CASES)
def test_ssd_chunked_matches_reference(T, chunk, carried):
    xh, dt, B_in, C_in, A, h0 = _ssd_inputs(T)
    h0 = h0 if carried else None
    want_y, want_h = R.ssd_chunked(*map(jnp.asarray, (xh, dt, B_in, C_in, A)),
                                   chunk, h0=None if h0 is None
                                   else jnp.asarray(h0))
    y, h = P.ssd_chunked(*map(torch.from_numpy, (xh, dt, B_in, C_in, A)),
                         chunk, h0=None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == h.dtype == torch.float64
    assert _rel(want_y, y) <= 1e-12
    assert _rel(want_h, h) <= 1e-12


def test_ssd_chunk_assert():
    xh, dt, B_in, C_in, A, _ = _ssd_inputs(12)
    with pytest.raises(ValueError, match="% chunk"):
        P.ssd_chunked(*map(torch.from_numpy, (xh, dt, B_in, C_in, A)), 8)


def test_ssd_carried_state_prefill_decode_split():
    """Integrating [0,T) then [T,2T) with carried state == one [0,2T) pass
    (the reference's `test_ssd_carried_state_prefill_decode_split`)."""
    T = 8
    xh, dt, B_in, C_in, A, _ = map(torch.from_numpy, _ssd_inputs(2 * T, 1))
    y_full, h_full = P.ssd_chunked(xh, dt, B_in, C_in, A, 4)
    _, h1 = P.ssd_chunked(xh[:, :T], dt[:, :T], B_in[:, :T], C_in[:, :T], A,
                          4)
    y2, h2 = P.ssd_chunked(xh[:, T:], dt[:, T:], B_in[:, T:], C_in[:, T:], A,
                           4, h0=h1)
    assert _rel(y_full[:, T:].numpy(), y2) <= 1e-12
    assert _rel(h_full.numpy(), h2) <= 1e-12


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 7, 6))
    w = rng.standard_normal((4, 6))
    st = rng.standard_normal((2, 3, 6)) if with_state else None
    want_y, want_st = R._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st))
    y, new = P._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                            None if st is None else torch.from_numpy(st))
    assert _rel(want_y, y) <= 1e-15
    assert _rel(want_st, new) <= 1e-15


def _layer_params(seed=3):
    """The reference's float64 params, its float32 islands (dt_bias, A_log,
    D_skip) and the gate norm drawn away from their constant inits."""
    p = jax.tree.map(np.array, R.ssd_params(jax.random.PRNGKey(seed), CFG,
                                            jnp.float64))
    rng = np.random.default_rng(seed)
    for name in ("dt_bias", "A_log", "D_skip", "gate_norm"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(p[name].shape)
                   ).astype(p[name].dtype)
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


def test_ssd_params_keep_the_float32_islands():
    p = P.ssd_params(torch.Generator().manual_seed(0), CFG, torch.float64)
    want = R.ssd_params(jax.random.PRNGKey(0), CFG, jnp.float64)
    for name, a in want.items():
        assert tuple(p[name].shape) == a.shape, name
        assert str(p[name].dtype).split(".")[-1] == str(a.dtype), name
    assert (p["D_skip"] == 1).all() and not p["A_log"].any()


@pytest.mark.parametrize("T,chunk", [(16, 4), (12, 12)])
def test_ssd_layers_match_reference(T, chunk):
    p, pt = _layer_params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T, CFG.d_model))
    x1 = rng.standard_normal((2, 1, CFG.d_model))
    jp = jax.tree.map(jnp.asarray, p)
    want, wst = R.ssd_layer_train(jnp.asarray(x), jp, CFG, chunk=chunk)
    got, st = P.ssd_layer_train(torch.from_numpy(x), pt, CFG, chunk=chunk)
    assert _rel(want, got) <= LAYER_BAR
    assert _rel(wst["h"], st["h"]) <= LAYER_BAR
    assert _rel(wst["conv"], st["conv"]) <= 1e-15
    want1, wst1 = R.ssd_layer_decode(jnp.asarray(x1), jp, CFG, wst)
    got1, st1 = P.ssd_layer_decode(torch.from_numpy(x1), pt, CFG, st)
    assert _rel(want1, got1) <= LAYER_BAR
    assert _rel(wst1["h"], st1["h"]) <= LAYER_BAR
    # a prefill over T + 1 tokens against prefill over T then one step
    full, fst = P.ssd_layer_train(torch.from_numpy(
        np.concatenate([x, x1], axis=1)), pt, CFG, chunk=T + 1)
    assert _rel(full[:, -1:].numpy(), got1) <= LAYER_BAR
    assert _rel(fst["h"].numpy(), st1["h"]) <= LAYER_BAR
