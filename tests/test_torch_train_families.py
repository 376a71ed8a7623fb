"""Every family's training loss and its gradient against the reference, on
the reduced archs (`-smoke`) in float64: internlm2 (dense), deepseek-moe
(MoE with a shared expert, the aux loss), mamba2 (SSD, ssd_chunk 8 so the
inter-chunk recurrence runs), recurrentgemma (one (R, R, A) period and an
(R, R) remainder, T past its window of 32), whisper (encoder over 16
frames, decoder with cross-attention) and internvl2 (8 image tokens, the
loss on the text positions only).

Numpy weights in the reference's `init_params` layout (its shapes from
`jax.eval_shape`, the constant-initialised leaves drawn away from their
constants) go to the port through `convert.lm_params`; the batch is
`data.pipeline.synth_batch`'s in both packages.  The reference's
`jax.value_and_grad(model.loss)` runs under `jax.jit`; the port's
`model.loss` under `torch.autograd.grad`, each gradient leaf read back by
name through `convert.named_leaves`.

Bars.  The loss (float32 in both: the cross-entropy takes its max and sum
statistics in float32) within 1e-6 relative.  Each gradient leaf within
GRAD of its largest |reference value|: 1e-6, the bar of the LM forward
parity (`tests/test_torch_lm_families.py`); both packages scale every
token's softmax gradient by the float32 1/sum, which rounds differently
in XLA and PyTorch (measured 5e-7 to 9e-7 on the float64 leaves).  Two
stated exceptions: the float32 leaves of a float64 model (the router, the
SSD's dt_bias, A_log, D_skip, the RG-LRU's b_r, b_i, lam), whose
gradients are float32 sums over the batch's B·T tokens, at
B·T·2^-24 = 4.8e-6 (measured up to 1.14e-6); Mamba-2's, at SSM_GRAD_F64
(the families test's SSM_FORWARD_F64 reason: dt is float32, so an ulp of
dt moves the log-decay cumsum; the gradient sums that over every
position; measured up to 1.88e-6).

`remat=True` and `remat="dots"` give every gradient bitwise that of
`remat=False`: checkpointing only recomputes (or keeps) the same ops.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import get_arch as r_get_arch
from repro.data.pipeline import synth_batch as r_synth_batch
from repro.models.model import build_model as r_build_model
from repro_torch.configs.archs import get_arch
from repro_torch.convert import lm_params, named_leaves
from repro_torch.data.pipeline import synth_batch

FAMILIES = ["internlm2-1.8b", "deepseek-moe-16b", "mamba2-2.7b",
            "recurrentgemma-9b", "whisper-tiny", "internvl2-26b"]
B, T = 2, 40
GRAD = 1e-6
F32_LEAF_GRAD = B * T * 2.0 ** -24
SSM_GRAD_F64 = 4e-6
KW = {"mamba2-2.7b": {"ssd_chunk": 8}}
CONSTANT_LEAVES = {"final_norm": 0.0, "enc_norm": 0.0, "ln": 0.0, "ln1": 0.0,
                   "ln2": 0.0, "lnx": 0.0, "gate_norm": 0.0, "bq": 0.0,
                   "bk": 0.0, "bv": 0.0, "dt_bias": 0.0, "A_log": 0.0,
                   "D_skip": 1.0, "b_r": 0.0, "b_i": 0.0, "lam": 0.65}


@functools.cache
def ref_params(arch):
    """Numpy weights in the layout and dtypes of the reference's float64
    `init_params`: each matrix N(0, 1/fan_in) (the embedding N(0, 0.02²)),
    each constant leaf its init value + 0.3 N(0, 1)."""
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


def batches(arch, seed=0, step=3, b=B, t=T):
    """The same synthetic batch for both packages, the stubs in float64."""
    r = r_synth_batch(r_get_arch(arch + "-smoke"), seed, step, b, t)
    r = {k: v if k in ("tokens", "labels") else jnp.asarray(v, jnp.float64)
         for k, v in r.items()}
    p = synth_batch(get_arch(arch + "-smoke"), seed, step, b, t)
    p = {k: v if k in ("tokens", "labels") else v.double()
         for k, v in p.items()}
    return r, p


@functools.cache
def reference(arch):
    """(loss, ce, aux, gradient pytree as numpy)."""
    cfg = r_get_arch(arch + "-smoke")
    model = r_build_model(cfg, dtype=jnp.float64, **KW.get(arch, {}))
    (loss, m), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        ref_params(arch), batches(arch)[0])
    return (float(loss), float(m["ce"]), float(m["aux"]),
            jax.tree.map(np.asarray, g))


def port(arch, **kw):
    return lm_params(ref_params(arch), get_arch(arch + "-smoke"),
                     device="cpu", dtype=torch.float64,
                     **{**KW.get(arch, {}), **kw})


def port_grads(model, batch):
    params = dict(model.named_parameters())
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, dict(zip(params, grads))


def leaf_bar(arch, want):
    if arch == "mamba2-2.7b":
        return SSM_GRAD_F64
    return F32_LEAF_GRAD if want.dtype == np.float32 else GRAD


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradient_match_reference(arch):
    want_loss, want_ce, want_aux, want_g = reference(arch)
    model = port(arch)
    loss, metrics, grads = port_grads(model, batches(arch)[1])
    assert loss.dtype == metrics["ce"].dtype == torch.float32
    assert abs(loss.item() - want_loss) <= 1e-6 * abs(want_loss)
    assert abs(metrics["ce"].item() - want_ce) <= 1e-6 * abs(want_ce)
    assert abs(metrics["aux"].item() - want_aux) <= 1e-6 * abs(want_aux)
    if get_arch(arch + "-smoke").family == "moe":
        assert want_aux > 0        # the total carries 0.01 aux
    named = list(named_leaves(want_g, model))
    assert [n for n, _ in named] == list(grads)
    for name, want in named:
        got = grads[name]
        assert got.dtype == model.get_parameter(name).dtype, name
        assert tuple(got.shape) == want.shape, name
        err = np.abs(got.double().numpy() - want).max()
        scale = np.abs(want).max()
        assert err <= leaf_bar(arch, want) * scale, \
            f"{name}: {err / scale:.3e}"


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gradients_are_bitwise(arch, remat):
    batch = batches(arch)[1]
    base = port_grads(port(arch), batch)
    got = port_grads(port(arch, remat=remat), batch)
    assert torch.equal(got[0], base[0])
    for name, g in base[2].items():
        assert torch.equal(got[2][name], g), name


def test_remat_dots_keeps_the_projections():
    """"dots" keeps the outputs of the matmuls with no batch dimension:
    its backward runs as many of them as without remat (their gradients),
    remat=True's recomputes every one besides."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountMM.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in (False, True, "dots"):
        model = port("internlm2-1.8b", remat=remat)
        loss, _ = model.loss(batches("internlm2-1.8b")[1])
        CountMM.n = 0
        with CountMM():
            loss.backward()
        counts[remat] = CountMM.n
    assert counts[False] == counts["dots"] < counts[True], counts


def test_remat_rejects_an_unknown_policy():
    model = port("internlm2-1.8b", remat="all")
    with pytest.raises(ValueError, match="remat"):
        model.loss(batches("internlm2-1.8b")[1])


@pytest.mark.parametrize("arch", ["mamba2-2.7b"])
def test_ssd_gradient_is_finite_past_exp_overflow(arch):
    """A chunk of 256 whose log-decay spans more than float32's exp range
    (dt ~ 2, A = -exp(2)): the masked decays' exponents would overflow, and
    the gradient stays finite (the reference's exp-then-select gives inf
    times 0 there)."""
    cfg = get_arch(arch + "-smoke")
    from repro_torch.models.model import build_model
    model = build_model(cfg, torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for blk in model.blocks:
            blk.ssd["dt_bias"].fill_(2.0)
            blk.ssd["A_log"].fill_(2.0)
    batch = synth_batch(cfg, 0, 0, 1, 256)
    loss, _, grads = port_grads(model, batch)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
