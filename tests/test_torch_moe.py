"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`), float64, from the same numpy inputs.

Shapes: grok-1's expert layout (8 experts, top-2, no shared experts) and
deepseek-moe's (64 experts, top-6, 2 shared), at narrow D and F; capacity
factors None (no drops), 1.25 and 2.0 over 4 groups of 16 tokens, so the
finite factors drop pairs.  The routing (chosen experts, slots, the keep
mask) is held equal, token by token, to the reference's own (its lines
`moe.py:66-79`, recomputed here); the output and the aux loss within 1e-6
of the largest value: the router runs in float32 in both, so the combine
weights agree to float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as R
import repro_torch.models.moe as P

B, T, D, F = 2, 32, 24, 16
GROUP = 16
SHAPES = {"grok": (8, 2, 0), "deepseek": (64, 6, 2)}
BAR = 1e-6


def _setup(shape, seed=0):
    E, k, S = SHAPES[shape]
    p = jax.tree.map(np.array, R.moe_params(jax.random.PRNGKey(seed), D, F, E,
                                            S, jnp.float64))
    x = np.random.default_rng(seed).standard_normal((B, T, D))
    pt = {name: torch.from_numpy(a) for name, a in p.items()}
    return (E, k), p, pt, x


def _reference_routing(x, router, topk, E, cf, group):
    """`repro/models/moe.py:57-79`: (topi, pos_slot, keep), flattened
    token-major over the groups."""
    N = x.shape[0] * x.shape[1]
    g = min(group, N)
    G = N // g
    C = g if cf is None else max(1, int((g * topk / E) * cf))
    xf = jnp.asarray(x).reshape(G, g, -1)
    logits = jnp.einsum("Ggd,de->Gge", xf.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    _, topi = jax.lax.top_k(probs, topk)
    oh = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    ohf = oh.reshape(G, g * topk, E)
    pos = jnp.cumsum(ohf, axis=1) - ohf
    pos_slot = jnp.sum(pos * ohf, axis=-1).reshape(G, g, topk).astype(
        jnp.int32)
    return (np.asarray(topi).reshape(N, topk),
            np.asarray(pos_slot).reshape(N, topk),
            np.asarray(pos_slot < C).reshape(N, topk))


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert want.shape == got.shape
    return np.abs(want - got).max() / np.abs(want).max()


@pytest.mark.parametrize("cf", [None, 1.25, 2.0])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_ffn_matches_reference(shape, cf):
    (E, k), p, pt, x = _setup(shape)
    want_y, want_aux = R.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                 topk=k, n_experts=E, capacity_factor=cf,
                                 group_size=GROUP)
    xt = torch.from_numpy(x)
    route = P.moe_route(xt, pt["router"], topk=k, n_experts=E,
                        capacity_factor=cf, group_size=GROUP)
    topi, slot, keep = _reference_routing(x, p["router"], k, E, cf, GROUP)
    np.testing.assert_array_equal(route.topi.numpy(), topi)
    np.testing.assert_array_equal(route.slot.numpy(), slot)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    assert keep.all() == (cf is None), "the finite factors drop pairs here"
    y, aux = P.moe_ffn(xt, pt, topk=k, n_experts=E, capacity_factor=cf,
                       group_size=GROUP)
    assert y.dtype == torch.float64 and aux.dtype == torch.float32
    assert _rel(want_y, y) <= BAR
    assert abs(float(aux) - float(want_aux)) <= BAR * abs(float(want_aux))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_decode_shape_one_group_of_the_batch(shape):
    """The decode step's call: (B, 1, D) in one group of B tokens, no
    drops."""
    (E, k), p, pt, x = _setup(shape, seed=1)
    x1 = x[:, :1]
    want, _ = R.moe_ffn(jnp.asarray(x1), jax.tree.map(jnp.asarray, p), topk=k,
                        n_experts=E, capacity_factor=None, group_size=B)
    got, _ = P.moe_ffn(torch.from_numpy(x1), pt, topk=k, n_experts=E,
                       capacity_factor=None, group_size=B)
    assert _rel(want, got) <= BAR


def test_moe_identical_experts_equal_the_plain_ffn():
    """The reference's conservation check (`tests/test_models_parts.py:94`)
    on the port: with no drops and identical experts the combine weights
    sum to 1, so MoE == the plain SwiGLU of expert 0."""
    (E, k), p, pt, x = _setup("grok", seed=3)
    for name in ("wi", "wg", "wo"):
        pt[name] = pt[name][:1].expand_as(pt[name])
    xt = torch.from_numpy(x)
    y, aux = P.moe_ffn(xt, pt, topk=k, n_experts=E, capacity_factor=None,
                       group_size=GROUP)
    ref = (torch.nn.functional.silu(xt @ pt["wg"][0])
           * (xt @ pt["wi"][0])) @ pt["wo"][0]
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)
    assert float(aux) > 0


def test_group_divisibility_refused():
    (E, k), _, pt, x = _setup("grok")
    with pytest.raises(ValueError, match="not divisible by MoE group size"):
        P.moe_ffn(torch.from_numpy(x[:, :5]), pt, topk=k, n_experts=E,
                  group_size=4)


def test_moe_params_draw_the_reference_layout():
    p = P.moe_params(torch.Generator().manual_seed(0), D, F, 64, 2,
                     torch.bfloat16)
    want = R.moe_params(jax.random.PRNGKey(0), D, F, 64, 2, jnp.bfloat16)
    assert sorted(p) == sorted(want)
    for name, a in want.items():
        assert tuple(p[name].shape) == a.shape, name
    assert p["router"].dtype == torch.float32
    assert p["wi"].dtype == torch.bfloat16
    std = float(p["wi"].float().std()) * D ** 0.5
    assert abs(std - 1.0) < 0.05
