"""The port's other five LM families and their serving plan against the
reference, on the six non-dense archs reduced (`-smoke`): grok-1 and
deepseek-moe (MoE: top-2 of 8, and top-2 of 8 with a shared expert, the
reduced layouts), mamba2 (SSD, built with ssd_chunk 8 so the prefill's
inter-chunk recurrence runs), recurrentgemma (RG-LRU + local attention:
one (R, R, A) period and an (R, R) remainder, window 32), whisper (encoder
over 16 frames, decoder with cross-attention) and internvl2 (8 image
tokens through the projector, then the LM).

Numpy weights in the layout of the reference's `init_params` pytree go
through `convert.lm_params`, its constant-initialised leaves (norms,
biases and the float32 islands: dt_bias, A_log, D_skip, b_r, b_i, lam)
drawn away from their constants so that they count; the same numpy
tokens, frames and patches go to both;
the port serves through `make_serve_plan(model, None, ...)`.  The
reference's steps run under `jax.jit` (one compile a step shape).

Bars, as in `tests/test_torch_lm.py`, as a fraction of the largest
|reference value| over the true vocab: float64 1e-6 (the reference takes
norm statistics, rope, the router, dt and the RG-LRU gates in float32
whatever the dtype, and XLA's float32 transcendentals differ from
PyTorch's by an ulp), float32 2e-4; Mamba-2's float64 forward over every
position 2e-6 (`SSM_FORWARD_F64`).  Greedy tokens are equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import get_arch as r_get_arch
from repro.models.layers import cross_attention as r_cross_attention
from repro.models.lm import _logits as r_logits
from repro.models.model import build_model as r_build_model
from repro_torch.configs.archs import get_arch
from repro_torch.convert import lm_params
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.models.layers import cross_attention
from repro_torch.models.lm import _logits
from repro_torch.train.serve import make_serve_plan

FAMILIES = ["deepseek-moe-16b", "grok-1-314b", "internvl2-26b",
            "mamba2-2.7b", "recurrentgemma-9b", "whisper-tiny"]
B, T, STEPS = 2, 40, 4          # T > recurrentgemma-smoke's window of 32,
T_SHORT = 24                    # T % 32 != 0; T_SHORT < the window
BAR = {"float64": 1e-6, "float32": 2e-4}
# Mamba-2's forward over every position in float64: dt is float32 in both
# packages, and an ulp of dt (6e-8) moves the log-decay cumsum lcum by
# |lcum| 6e-8 absolute, so exp(lcum) by that relative; |lcum| reaches ~40
# at T = 40 with the drawn A_log and dt_bias (measured 1.165e-6)
SSM_FORWARD_F64 = 2e-6
TORCH = {"float64": torch.float64, "float32": torch.float32}
KW = {"mamba2-2.7b": {"ssd_chunk": 8}}


def _cfgs(arch):
    return r_get_arch(arch + "-smoke"), get_arch(arch + "-smoke")


def _extra(cfg):
    return cfg.vis_seq if cfg.family == "vlm" else 0


def _cache_len(cfg, T):
    return T + _extra(cfg) + STEPS + 4


def _inputs(cfg, T, seed=0):
    """Tokens (B, T + 1) and the stub frontends' embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1))}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, cfg.vis_seq, cfg.vis_dim))
    return out


# the reference's constant-initialised leaves (norms, biases, the float32
# islands) and their init values; drawn here at value + 0.3 N(0, 1)
CONSTANT_LEAVES = {"final_norm": 0.0, "enc_norm": 0.0, "ln": 0.0, "ln1": 0.0,
                   "ln2": 0.0, "lnx": 0.0, "gate_norm": 0.0, "bq": 0.0,
                   "bk": 0.0, "bv": 0.0, "dt_bias": 0.0, "A_log": 0.0,
                   "D_skip": 1.0, "b_r": 0.0, "b_i": 0.0, "lam": 0.65}


@functools.cache
def _params(arch):
    """Numpy weights in the layout and dtypes of the reference's float64
    `init_params` (its shapes from `jax.eval_shape`): each matrix
    N(0, 1/fan_in) (the embedding N(0, 0.02²)), each constant leaf its
    init value + 0.3 N(0, 1), so that every weight counts."""
    cfg = r_get_arch(arch + "-smoke")
    model = r_build_model(cfg, dtype=jnp.float64, **KW.get(arch, {}))
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape)
        if name in CONSTANT_LEAVES:
            a = CONSTANT_LEAVES[name] + 0.3 * z
        else:
            a = z * (0.02 if name == "embed" else leaf.shape[-2] ** -0.5)
        return a.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _cast(params, dtype):
    """The params in `dtype`, the float32 islands kept."""
    return jax.tree.map(lambda a: jnp.asarray(
        a, dtype if a.dtype == np.float64 else a.dtype), params)


def _batch(inputs, n, lib, dtype):
    """The first n tokens and the frontends' inputs, as jax or torch."""
    out = {}
    for k, v in inputs.items():
        v = v[:, :n] if k == "tokens" else v
        if lib == "jax":
            out[k] = jnp.asarray(v, None if k == "tokens" else dtype)
        else:
            out[k] = (torch.as_tensor(v) if k == "tokens"
                      else torch.tensor(v, dtype=dtype))
    return out


def _r_forward(model, params, batch, cfg):
    """The reference's final-normed hidden states over the whole batch,
    and the MoE aux loss (else 0)."""
    if cfg.family == "vlm":
        h0 = model._embed_multimodal(params, batch["tokens"],
                                     batch["patches"])
        return model.lm.forward(params, None, h0=h0)
    if cfg.family == "encdec":
        return model.forward(params, batch["tokens"], batch["frames"]), 0.0
    out = model.forward(params, batch["tokens"])
    return out if cfg.family == "moe" else (out, 0.0)


def _p_forward(model, batch, cfg):
    with torch.inference_mode():
        if cfg.family == "vlm":
            h0 = model._embed_multimodal(batch["tokens"], batch["patches"])
            x, aux = model.lm.forward(None, h0=h0)
            return _logits(x, model.lm, cfg), aux
        if cfg.family == "encdec":
            x = model.forward(batch["tokens"], batch["frames"])
        else:
            x = model.forward(batch["tokens"])
        x, aux = x if isinstance(x, tuple) else (x, None)
        return _logits(x, model, cfg), aux


@functools.cache
def _reference(arch, dtype, T):
    """forward logits (and MoE aux) and prefill logits and cache, both on
    T tokens; then STEPS greedy decode steps."""
    cfg, _ = _cfgs(arch)
    model = r_build_model(cfg, dtype=getattr(jnp, dtype), **KW.get(arch, {}))
    params = _cast(_params(arch), getattr(jnp, dtype))
    inputs = _inputs(cfg, T)
    batch = _batch(inputs, T, "jax", getattr(jnp, dtype))
    def forward(p, b):
        x, aux = _r_forward(model, p, b, cfg)
        return r_logits(x, p, cfg), aux

    fwd, aux = jax.jit(forward)(params, batch)
    prefill = jax.jit(lambda p, b: model.prefill(p, b,
                                                 cache_len=_cache_len(cfg, T)))
    logits, cache = prefill(params, batch)
    pre = (np.asarray(logits, np.float64),
           jax.tree.map(lambda a: np.asarray(a, np.float64), cache))
    decode = jax.jit(model.decode_step)
    steps, cur = [], jnp.argmax(logits[..., :cfg.vocab_size], axis=-1)
    for _ in range(STEPS):
        logits, cache = decode(params, cache, cur)
        cur = jnp.argmax(logits[..., :cfg.vocab_size], axis=-1)
        steps.append((np.asarray(logits, np.float64), np.asarray(cur)))
    return np.asarray(fwd, np.float64), float(aux), pre, steps


def _port(arch, dtype, **kw):
    _, cfg = _cfgs(arch)
    return cfg, lm_params(_params(arch), cfg, device="cpu",
                          dtype=TORCH[dtype], **{**KW.get(arch, {}), **kw})


def assert_close(want, got, bar, V=None):
    want = np.asarray(want, np.float64)[..., :V]
    got = got.detach().double().numpy()[..., :V]
    assert want.shape == got.shape
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= bar, f"{err:.3e} > {bar}"


def _cache_leaves(cache):
    """The cache's float leaves in a fixed order, as the pytree's."""
    leaves = jax.tree.leaves({k: v for k, v in cache.items() if k != "pos"})
    return leaves, int(cache["pos"])


def _serve(arch, dtype, T, core=None):
    """The port's prefill and greedy decode, checked step by step."""
    cfg, model = _port(arch, dtype)
    model.attn_core = core
    fwd, aux, (pre_logits, pre_cache), steps = _reference(arch, dtype, T)
    plan = make_serve_plan(model, None, B, _cache_len(cfg, T))
    batch = _batch(_inputs(cfg, T), T, "torch", TORCH[dtype])
    logits, cache = plan.prefill_fn(batch)
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert_close(pre_logits, logits, BAR[dtype], cfg.vocab_size)
    want_leaves, pos = _cache_leaves(pre_cache)
    got_leaves, got_pos = _cache_leaves(cache)
    assert got_pos == pos == T + _extra(cfg)
    assert len(got_leaves) == len(want_leaves)
    for w, g in zip(want_leaves, got_leaves):
        assert_close(w, g, BAR[dtype])
    cur = logits[..., :cfg.vocab_size].argmax(dim=-1)
    for want_logits, want_tok in steps:
        logits, cache = plan.decode_fn(cache, cur)
        assert_close(want_logits, logits, BAR[dtype], cfg.vocab_size)
        cur = logits[..., :cfg.vocab_size].argmax(dim=-1)
        np.testing.assert_array_equal(cur.numpy(), want_tok)
    assert int(cache["pos"]) == T + _extra(cfg) + STEPS
    return cfg, model


@pytest.mark.parametrize("dtype", sorted(BAR))
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch, dtype):
    cfg, model = _port(arch, dtype)
    fwd, want_aux, _, _ = _reference(arch, dtype, T)
    got, aux = _p_forward(model, _batch(_inputs(cfg, T), T, "torch",
                                        TORCH[dtype]), cfg)
    assert got.dtype == TORCH[dtype]
    bar = (SSM_FORWARD_F64 if (cfg.family, dtype) == ("ssm", "float64")
           else BAR[dtype])
    assert_close(fwd, got, bar, cfg.vocab_size)
    if cfg.family == "moe":
        assert aux.dtype == torch.float32
        assert abs(float(aux) - want_aux) <= 1e-6 * abs(want_aux)


@pytest.mark.parametrize("dtype", sorted(BAR))
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_prefill_and_decode_match_reference(arch, dtype):
    _serve(arch, dtype, T)


@pytest.mark.parametrize("dtype", sorted(BAR))
def test_hybrid_within_the_window_matches_reference(dtype):
    """T_SHORT < the window: the ring cache is zero-padded, not rolled."""
    _serve("recurrentgemma-9b", dtype, T_SHORT)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_equals_forward_on_one_more_token(arch):
    """The reference's prefill/decode consistency
    (`tests/test_models_smoke.py:52`), in the port alone, float64; the MoE
    forward with no drops (moe_cf=None), as the reference's, and Mamba-2's
    in one chunk of T + 1."""
    kw = {"moe_cf": None} if "moe" in arch or "grok" in arch else {}
    cfg, model = _port(arch, "float64", **kw)
    if cfg.family == "ssm":
        model.ssd_chunk = T + 1
    full = _batch(_inputs(cfg, T), T + 1, "torch", torch.float64)
    with torch.inference_mode():
        _, cache = model.prefill(_batch(_inputs(cfg, T), T, "torch",
                                        torch.float64),
                                 cache_len=_cache_len(cfg, T))
        got, _ = model.decode_step(cache, full["tokens"][:, T:])
    want, _ = _p_forward(model, full, cfg)
    assert_close(want[:, -1:].numpy(), got, 1e-6, cfg.vocab_size)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-26b",
                                  "whisper-tiny"])
def test_flash_core_in_the_model_matches_the_reference(arch):
    """K7's plain version (`flash_attention` on CPU tensors) as the causal
    attention core of the MoE LM, the VLM's LM and whisper's decoder:
    float32 prefill and decode at the reference's bar."""
    _serve(arch, "float32", T, core=flash_attention)


def test_flash_core_refuses_softcap_and_windows():
    """grok's softcapped and recurrentgemma's windowed attention stay on
    the dense core: the hybrid has no core to set, grok refuses one."""
    cfg, model = _port("grok-1-314b", "float32")
    model.attn_core = flash_attention
    with pytest.raises(ValueError, match="softcap"):
        model.forward(_batch(_inputs(cfg, T), T, "torch",
                             torch.float32)["tokens"])
    assert not hasattr(_port("recurrentgemma-9b", "float32")[1],
                       "attn_core")


def test_cross_attention_matches_reference():
    """float64 within 1e-6: both take the softmax sum in float32, which
    XLA and PyTorch add in different orders (measured 7.7e-8), as every
    attention here (`tests/test_torch_lm_layers.py`)."""
    rng = np.random.default_rng(5)
    H, KV, hd, D, S = 4, 2, 8, 32, 11
    w = {"wq": rng.standard_normal((D, H * hd)) / 6,
         "wo": rng.standard_normal((H * hd, D)) / 6}
    x = rng.standard_normal((B, 5, D))
    k = rng.standard_normal((B, S, KV, hd))
    v = rng.standard_normal((B, S, KV, hd))
    for dtype, bar in (("float64", 1e-6), ("float32", 2e-6)):
        cast = lambda a: jnp.asarray(a, dtype)
        want = r_cross_attention(cast(x), jax.tree.map(cast, w), cast(k),
                                 cast(v), n_heads=H, n_kv=KV, hd=hd)
        tt = lambda a: torch.tensor(a, dtype=TORCH[dtype])
        got = cross_attention(tt(x), {n: tt(a) for n, a in w.items()},
                              tt(k), tt(v), n_heads=H, n_kv=KV, hd=hd)
        assert got.dtype == TORCH[dtype]
        assert_close(want, got, bar)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_draws_every_family_from_a_generator(arch):
    _, cfg = _cfgs(arch)
    from repro_torch.models.model import build_model
    models = [build_model(cfg, torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0)) for _ in range(2)]
    names = [n for n, _ in models[0].named_parameters()]
    assert names == [n for n, _ in models[1].named_parameters()]
    assert all(torch.equal(p, q) for p, q in zip(models[0].parameters(),
                                                 models[1].parameters()))
    # the reference's params, weight for weight
    assert (sum(p.numel() for p in models[0].parameters())
            == sum(a.size for a in jax.tree.leaves(_params(arch))))
    batch = _batch(_inputs(cfg, 8), 8, "torch", torch.float32)
    with torch.inference_mode():
        logits, _ = models[0].prefill(batch)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    assert (logits[..., cfg.vocab_size:]
            == torch.finfo(torch.float32).min / 8).all()


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_has_the_reference_layout(arch):
    """Every leaf of `init_cache` (and its pos) as the reference's: the
    same structure, shapes and dtypes (an SSM or RG-LRU state in float32
    in a float64 model)."""
    r_cfg, cfg = _cfgs(arch)
    want = r_build_model(r_cfg, dtype=jnp.float64, **KW.get(arch, {})
                         ).init_cache(B, 24)
    model = _port(arch, "float64")[1]
    got = model.init_cache(B, 24)
    w_leaves, w_tree = jax.tree.flatten(want)
    g_leaves, g_tree = jax.tree.flatten(got)
    assert g_tree == w_tree
    for w, g in zip(w_leaves, g_leaves):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()
