"""The port's gradient-compression collectives (`dist/collectives.py`)
against the reference's (`repro.dist.collectives`): the int8 quantisation
and error feedback bitwise on the same numpy inputs, the reference's own
properties (`tests/test_dist.py:15-50`: the round-to-nearest bound, the
residual carried, the bucket round trip) on the port, and both on the
gradients of a training step (the reduced internlm2, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.dist.collectives import EFState as REFState
from repro.dist.collectives import _quant_int8 as r_quant_int8
from repro.dist.collectives import bucketize as r_bucketize
from repro.dist.collectives import ef_compress as r_ef_compress
from repro_torch.configs.archs import get_arch
from repro_torch.data.pipeline import synth_batch
from repro_torch.dist.collectives import (EFState, _quant_int8, bucketize,
                                          ef_compress, ef_init)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import make_train_step


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((6, 5)) * 3).astype(np.float32),
            "b": (rng.standard_normal(7) * 1e-3).astype(np.float32),
            "c": {"d": np.zeros((3, 3), np.float32)}}


def test_int8_quant_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32) * 3.0)
    q, scale = _quant_int8(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    err = (q.float() * scale - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6
    q0, s0 = _quant_int8(torch.zeros(4))
    assert float(s0) == 1.0 and not q0.any()


def test_quant_and_error_feedback_bitwise_the_reference():
    """Five rounds of ef_compress on the same gradients (a leaf of zeros
    included): updates and residuals bitwise."""
    grads = [_tree(s) for s in range(5)]
    x = grads[0]["a"]
    q, s = _quant_int8(torch.from_numpy(x))
    rq, rs = r_quant_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    state = ef_init({k: torch.from_numpy(v) if k != "c" else
                     {"d": torch.from_numpy(v["d"])}
                     for k, v in grads[0].items()})
    rstate = REFState(residual=jax.tree.map(jnp.zeros_like, grads[0]))
    for g in grads:
        tg = {"a": torch.from_numpy(g["a"]), "b": torch.from_numpy(g["b"]),
              "c": {"d": torch.from_numpy(g["c"]["d"])}}
        deq, state = ef_compress(tg, state)
        rdeq, rstate = r_ef_compress(jax.tree.map(jnp.asarray, g), rstate)
        for got, want in ((deq, rdeq), (state.residual, rstate.residual)):
            for path in (("a",), ("b",), ("c", "d")):
                gt, wt = got, want
                for k in path:
                    gt, wt = gt[k], wt[k]
                np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def test_error_feedback_accumulates_residual():
    """EF property: the sum of dequantized updates converges to the sum of
    the true gradients (the bias is carried, not lost)."""
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(256)
                         .astype(np.float32) * 0.01)
    state = ef_init({"g": g})
    total = torch.zeros(256)
    for _ in range(50):
        deq, state = ef_compress({"g": g}, state)
        total += deq["g"]
    rel = float((total - 50 * g).norm() / (50 * g).norm())
    assert rel < 0.05, rel
    assert isinstance(state, EFState)


def test_bucketize_roundtrip_and_buckets_bitwise_the_reference():
    tree = {"a": np.arange(10.0, dtype=np.float32).reshape(2, 5),
            "b": np.arange(7.0, dtype=np.float32),
            "c": {"d": np.ones((3, 3), np.float32)}}
    tt = {"a": torch.from_numpy(tree["a"]), "b": torch.from_numpy(tree["b"]),
          "c": {"d": torch.from_numpy(tree["c"]["d"])}}
    buckets, unpack = bucketize(tt, bucket_bytes=40)
    rbuckets, _ = r_bucketize(jax.tree.map(jnp.asarray, tree), 40)
    assert len(buckets) == len(rbuckets) > 1
    for b, rb in zip(buckets, rbuckets):
        np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    out = unpack(buckets)
    for k in ("a", "b"):
        assert torch.equal(out[k], tt[k])
    assert torch.equal(out["c"]["d"], tt["c"]["d"])


def test_bucketize_restores_mixed_dtypes():
    tree = {"w": torch.randn(3, 4, dtype=torch.bfloat16),
            "n": torch.arange(5, dtype=torch.int32),
            "x": torch.randn(2, dtype=torch.float32)}
    buckets, unpack = bucketize(tree, bucket_bytes=16)
    assert all(b.dtype == torch.float32 for b in buckets)
    assert all(b.numel() == 4 for b in buckets[:-1])
    out = unpack(buckets)
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v), k


def test_on_a_training_steps_gradients():
    """The float32 gradients of one accumulated step of the reduced
    internlm2: each leaf's error within scale/2 plus the product's own
    rounding (an ulp of the leaf's largest value); the buckets round-trip
    bitwise."""
    cfg = get_arch("internlm2-1.8b-smoke")
    model = build_model(cfg, torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    plan = make_train_step(model, AdamW(lr=1e-3), accum=2)
    _, _, grads = plan.grad_fn(synth_batch(cfg, 0, 0, 4, 32))
    deq, state = ef_compress(grads, ef_init(grads))
    for name, g in grads.items():
        scale = g.abs().max() / 127.0
        err = (deq[name] - g).abs().max()
        ulp = torch.finfo(torch.float32).eps * g.abs().max()
        assert err <= scale / 2 + ulp, name
        assert torch.equal(state.residual[name], g - deq[name])
    buckets, unpack = bucketize(grads, bucket_bytes=1 << 16)
    out = unpack(buckets)
    assert all(torch.equal(out[n], g) for n, g in grads.items())
