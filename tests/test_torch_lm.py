"""The port's dense decoder LM and its serving plan against the reference,
on the four dense archs reduced (`-smoke`): command-r, qwen2.5 (QKV bias,
set to random values: the reference initialises biases to zero),
internlm2, and gemma3 (sliding window on 5 of 6 layers, tied embeddings).
The reference's `init_params` pytree goes through `convert.lm_params`; the
same numpy tokens go to both; the port serves through
`make_serve_plan(model, None, ...)`.

Bars, as a fraction of the largest |reference logit| over the true vocab:
float64 1e-6 (the reference takes rmsnorm's statistics and rope's cos/sin
in float32 whatever the dtype, and XLA's float32 mean, rsqrt, pow, cos and
sin differ from PyTorch's by an ulp, 6e-8, through 4 layers; measured
4.7e-7); float32 2e-4 (float32 sums in other orders through 4 layers and
the vocab projection).  Greedy tokens are equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as R_ARCHS
from repro.configs.archs import get_arch as r_get_arch
from repro.models.lm import _logits as r_logits
from repro.models.lm import xent_loss as r_xent_loss
from repro.models.model import build_model as r_build_model
from repro_torch.configs.archs import ARCHS, get_arch
from repro_torch.convert import lm_params
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.models.lm import _logits, xent_loss
from repro_torch.models.model import build_model
from repro_torch.train.serve import make_serve_plan

DENSE = ["command-r-35b", "gemma3-1b", "internlm2-1.8b", "qwen2.5-32b"]
B, T, STEPS = 2, 24, 4          # T > gemma3-smoke's window of 16
CACHE = T + STEPS + 4
BAR = {"float64": 1e-6, "float32": 2e-4}
TORCH = {"float64": torch.float64, "float32": torch.float32}


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T + 1))


@functools.cache
def _params(arch):
    """The reference's float64 params as numpy arrays (qwen's biases made
    random)."""
    cfg = r_get_arch(arch + "-smoke")
    model = r_build_model(cfg, dtype=jnp.float64)
    params = jax.tree.map(np.array, model.init_params(jax.random.PRNGKey(0)))
    if cfg.qkv_bias:
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            leaf = params["blocks"]["attn"][name]
            params["blocks"]["attn"][name] = rng.standard_normal(leaf.shape)
    return params


@functools.cache
def _reference(arch, dtype):
    """forward logits on T + 1 tokens; prefill (T tokens) logits and cache;
    then STEPS greedy decode steps: logits and tokens each step."""
    cfg = r_get_arch(arch + "-smoke")
    model = r_build_model(cfg, dtype=getattr(jnp, dtype))
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), _params(arch))
    toks = jnp.asarray(_tokens(cfg))
    x, _ = model.forward(params, toks)
    fwd = np.asarray(r_logits(x, params, cfg), np.float64)
    logits, cache = model.prefill(params, {"tokens": toks[:, :T]},
                                  cache_len=CACHE)
    pre = (np.asarray(logits, np.float64),
           {k: np.asarray(cache[k], np.float64) for k in ("k", "v")},
           int(cache["pos"]))
    steps, cur = [], jnp.argmax(logits[..., :cfg.vocab_size], axis=-1)
    for _ in range(STEPS):
        logits, cache = model.decode_step(params, cache, cur)
        cur = jnp.argmax(logits[..., :cfg.vocab_size], axis=-1)
        steps.append((np.asarray(logits, np.float64), np.asarray(cur)))
    return fwd, pre, steps


def _port(arch, dtype):
    cfg = get_arch(arch + "-smoke")
    return cfg, lm_params(_params(arch), cfg, device="cpu",
                          dtype=TORCH[dtype])


def assert_logits(want, got, V, bar):
    want = want[..., :V]
    got = got.detach().double().numpy()[..., :V]
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= bar, f"{err:.3e} > {bar}"


def test_param_counts_equal_the_reference_on_every_arch():
    assert sorted(ARCHS) == sorted(R_ARCHS)
    for name in ARCHS:
        assert ARCHS[name].n_params() == R_ARCHS[name].n_params(), name
        assert (ARCHS[name].n_params_active()
                == R_ARCHS[name].n_params_active()), name
        assert (dataclasses.asdict(get_arch(name + "-smoke"))
                == dataclasses.asdict(r_get_arch(name + "-smoke"))), name


@pytest.mark.parametrize("dtype", sorted(BAR))
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, dtype):
    cfg, model = _port(arch, dtype)
    fwd = _reference(arch, dtype)[0]
    with torch.inference_mode():
        x, aux = model.forward(torch.as_tensor(_tokens(cfg)))
        got = _logits(x, model, cfg)
    assert float(aux) == 0.0 and got.dtype == TORCH[dtype]
    assert_logits(fwd, got, cfg.vocab_size, BAR[dtype])


@pytest.mark.parametrize("dtype", sorted(BAR))
@pytest.mark.parametrize("arch", DENSE)
def test_serve_prefill_and_decode_match_reference(arch, dtype):
    cfg, model = _port(arch, dtype)
    _, (pre_logits, pre_cache, pre_pos), steps = _reference(arch, dtype)
    plan = make_serve_plan(model, None, B, CACHE)
    toks = torch.as_tensor(_tokens(cfg))
    logits, cache = plan.prefill_fn({"tokens": toks[:, :T]})
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert_logits(pre_logits, logits, cfg.vocab_size, BAR[dtype])
    for name in ("k", "v"):
        assert cache[name].shape == pre_cache[name].shape
        assert_logits(pre_cache[name], cache[name], None, BAR[dtype])
    assert int(cache["pos"]) == pre_pos == T
    k_buf = cache["k"]
    cur = logits[..., :cfg.vocab_size].argmax(dim=-1)
    for want_logits, want_tok in steps:
        logits, cache = plan.decode_fn(cache, cur)
        assert_logits(want_logits, logits, cfg.vocab_size, BAR[dtype])
        cur = logits[..., :cfg.vocab_size].argmax(dim=-1)
        np.testing.assert_array_equal(cur.numpy(), want_tok)
    assert cache["k"] is k_buf and int(cache["pos"]) == T + STEPS


@pytest.mark.parametrize("dtype", sorted(BAR))
def test_xent_loss_matches_reference(dtype):
    """Both take the max and the sum in float32 whatever the dtype:
    within 1e-6 relative."""
    rng = np.random.default_rng(2)
    logits = 4 * rng.standard_normal((B, T, 512))
    labels = rng.integers(0, 512, (B, T))
    want = float(r_xent_loss(jnp.asarray(logits, dtype), jnp.asarray(labels)))
    got = float(xent_loss(torch.tensor(logits, dtype=TORCH[dtype]),
                          torch.as_tensor(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_equals_forward_on_one_more_token(arch):
    """The reference's prefill/decode consistency, in the port alone
    (float64; rmsnorm and rope round in float32 on both paths)."""
    cfg, model = _port(arch, "float64")
    toks = torch.as_tensor(_tokens(cfg))
    with torch.inference_mode():
        _, cache = model.prefill({"tokens": toks[:, :T]}, cache_len=CACHE)
        got, _ = model.decode_step(cache, toks[:, T:])
        x, _ = model.forward(toks)
        want = _logits(x[:, -1:], model, cfg)
    assert_logits(want.numpy(), got, cfg.vocab_size, 1e-6)


def test_flash_core_in_the_model_matches_the_reference():
    """With `attn_core = flash_attention` (its plain version on the CPU) the
    float32 internlm2 prefill and decode hold the reference's bar."""
    cfg, model = _port("internlm2-1.8b", "float32")
    model.attn_core = flash_attention
    _, (pre_logits, pre_cache, _), steps = _reference("internlm2-1.8b",
                                                      "float32")
    plan = make_serve_plan(model, None, B, CACHE)
    logits, cache = plan.prefill_fn(
        {"tokens": torch.as_tensor(_tokens(cfg))[:, :T]})
    assert_logits(pre_logits, logits, cfg.vocab_size, BAR["float32"])
    logits, _ = plan.decode_fn(cache,
                               logits[..., :cfg.vocab_size].argmax(-1))
    assert_logits(steps[0][0], logits, cfg.vocab_size, BAR["float32"])


def test_flash_core_refuses_windowed_layers():
    cfg, model = _port("gemma3-1b", "float32")
    model.attn_core = flash_attention
    with pytest.raises(ValueError, match="window"):
        model.forward(torch.as_tensor(_tokens(cfg)))


def test_init_params_draws_from_a_generator():
    cfg = get_arch("internlm2-1.8b-smoke")
    a = build_model(cfg, torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    b = build_model(cfg, torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not a.blocks[0].ln1.any() and not a.final_norm.any()
    assert abs(float(a.embed.detach().std()) / 0.02 - 1.0) < 0.05
    with torch.inference_mode():
        logits, _ = a.prefill({"tokens": torch.zeros((1, 8), dtype=int)})
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    assert (logits[..., cfg.vocab_size:]
            == torch.finfo(torch.float32).min / 8).all()


def test_mesh_and_missing_cuda_refused(monkeypatch):
    cfg = get_arch("internlm2-1.8b-smoke")
    model = build_model(cfg, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        make_serve_plan(model, object(), B, CACHE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
