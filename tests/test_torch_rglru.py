"""The port's RG-LRU block (`repro_torch.models.rglru`) against the
reference's (`repro.models.rglru`), from the same numpy inputs.

Bars, as a fraction of the largest |reference value|:
  - the associative scan against `jax.lax.associative_scan` on float64
    (a, b): 1e-14 (the same odd/even recursion, operation for operation;
    XLA may fuse a2·b1 + b2 into one rounding where PyTorch rounds twice);
  - the layers in float64: 1e-6.  The gates, b_r, b_i and Λ are float32 in
    both, and XLA's float32 exp, sigmoid and log1p differ from PyTorch's
    by an ulp (6e-8).
Train against decode (`tests/test_models_parts.py:73`) holds in the port
alone at the reference's own rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as R
import repro_torch.models.rglru as P

D, W, K, B = 16, 16, 4, 2
LAYER_BAR = 1e-6


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert want.shape == got.shape
    return np.abs(want - got).max() / np.abs(want).max()


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("T", [1, 2, 7, 16, 33])
def test_assoc_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (B, T, W))
    b = rng.standard_normal((B, T, W))
    wa, wb = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    ga, gb = P.assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(wa, ga) <= 1e-14
    assert _rel(wb, gb) <= 1e-14
    # and the recurrence it computes, step by step
    h = np.zeros((B, W))
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(gb[:, t].numpy(), h, rtol=1e-12,
                                   atol=1e-12)


def _params(seed=0):
    p = jax.tree.map(np.array, R.rglru_params(jax.random.PRNGKey(seed), D, W,
                                              K, jnp.float64))
    rng = np.random.default_rng(seed)
    for name in ("b_r", "b_i", "lam"):     # the float32 islands, varied
        p[name] = (p[name] + 0.3 * rng.standard_normal(W)).astype(np.float32)
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


def test_rglru_params_keep_the_float32_islands():
    p = P.rglru_params(torch.Generator().manual_seed(0), D, W, K,
                       torch.float64)
    want = R.rglru_params(jax.random.PRNGKey(0), D, W, K, jnp.float64)
    for name, a in want.items():
        assert tuple(p[name].shape) == a.shape, name
        assert str(p[name].dtype).split(".")[-1] == str(a.dtype), name
    assert (p["lam"] == 0.65).all()


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("T", [1, 6, 13])
def test_rglru_layers_match_reference(T, carried):
    p, pt = _params()
    rng = np.random.default_rng(10 + T)
    x = rng.standard_normal((B, T, D))
    x1 = rng.standard_normal((B, 1, D))
    state = ({"h": rng.standard_normal((B, W)).astype(np.float32),
              "conv": rng.standard_normal((B, K - 1, W))} if carried
             else None)
    jp = jax.tree.map(jnp.asarray, p)
    want, wst = R.rglru_train(jnp.asarray(x), jp, None if state is None
                              else jax.tree.map(jnp.asarray, state))
    got, st = P.rglru_train(torch.from_numpy(x), pt, None if state is None
                            else {k: torch.from_numpy(v)
                                  for k, v in state.items()})
    assert st["h"].dtype == torch.float32
    assert _rel(want, got) <= LAYER_BAR
    assert _rel(wst["h"], st["h"]) <= LAYER_BAR
    assert _rel(wst["conv"], st["conv"]) <= 1e-15
    want1, wst1 = R.rglru_decode(jnp.asarray(x1), jp, wst)
    got1, st1 = P.rglru_decode(torch.from_numpy(x1), pt, st)
    assert _rel(want1, got1) <= LAYER_BAR
    assert _rel(wst1["h"], st1["h"]) <= LAYER_BAR


def test_rglru_train_decode_agree():
    """Recurrent training scan == step-by-step decode (the reference's
    `test_rglru_train_decode_agree`, on the port)."""
    p, pt = _params(2)
    T = 6
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((B, T, D)))
    y_train, st = P.rglru_train(x, pt)
    state = {"h": torch.zeros((B, W), dtype=torch.float64),
             "conv": torch.zeros((B, K - 1, W), dtype=torch.float64)}
    ys = []
    for t in range(T):
        y, state = P.rglru_decode(x[:, t:t + 1], pt, state)
        ys.append(y)
    torch.testing.assert_close(y_train, torch.cat(ys, dim=1), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(st["h"].double(), state["h"].double(),
                               rtol=1e-5, atol=1e-6)
