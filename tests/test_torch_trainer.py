"""The port's training path against the reference's, on the CPU: the data
pipeline, `pick_accum`, AdamW and its cosine schedule, and
`make_train_step` (loss, gradient, update, accumulation) on
internlm2-1.8b reduced (`-smoke`) in float64; then the reference's own
trainer cases (`tests/test_trainer.py`) on the port, the refusals, a
bitwise resume and `launch/train.py`.

Bars.
- The data: bitwise (`tests/test_checkpoint_fault.py:92`'s case).
- `cosine_schedule`: within one float32 ulp of the value and one of the
  cosine (XLA's and PyTorch's float32 cos differ by an ulp at some angles;
  (1 + cos) carries it into the value).  `AdamW.update` on the same numpy
  inputs: every output within
  ADAM_ULPS float32 ulps of its leaf's largest value (the same float32
  formula; XLA may fuse the multiply-adds, and its pow and sqrt may round
  differently).
- `make_train_step`, step by step: each of three steps starts the port
  from the reference's parameters and state (`convert.lm_params`,
  `convert.adamw_state`), so a step's differences are its own.  Loss and
  grad_norm within 1e-6 relative; the gradients are held at 1e-6 of each
  leaf's largest value (`tests/test_torch_train_families.py`), so `mu`,
  linear in them, within 1e-6 of its leaf's largest value and `nu`,
  quadratic, within 2e-6.  The parameters: Adam divides by sqrt(vhat) +
  eps, so a gradient error e moves an element whose gradient is near eps
  (1e-8) by up to lr·e/eps.  `adam_param_bar` derives each element's
  bound from the reference's own state: with the gradient off by at most
  e = 1e-6 (max|g| of the leaf + |g|) (the gradient bar, and the clip
  scale's relative error), mhat moves by (1 - b1) e / b1c, vhat by
  (1 - b2)(2|g| e + e²) / b2c, sqrt(vhat) by at most min(sqrt(dv),
  dv / (2 sqrt(vhat))), and the update by lr times the change of mhat /
  (sqrt(vhat) + eps) over those intervals, plus 2 float32 ulps of the
  parameter (both round it to float32 and back).  Measured: the widest
  element at 0.46 of its bound.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as R_ARCHS
from repro.configs.archs import get_arch as r_get_arch
from repro.data.pipeline import DataPipeline as RDataPipeline
from repro.data.pipeline import synth_batch as r_synth_batch
from repro.models.model import build_model as r_build_model
from repro.optim.adamw import AdamW as RAdamW
from repro.optim.adamw import cosine_schedule as r_cosine_schedule
from repro.train.trainer import make_train_step as r_make_train_step
from repro.train.trainer import pick_accum as r_pick_accum
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs.archs import ARCHS, get_arch
from repro_torch.convert import adamw_state, lm_params, named_leaves
from repro_torch.data.pipeline import DataPipeline, synth_batch
from repro_torch.dist.fault import TrainSupervisor
from repro_torch.kernels.flashattn.ops import flash_attention
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm
from repro_torch.train.trainer import (load_params, make_train_step,
                                       pick_accum, train_state)

ARCH = "internlm2-1.8b"
ADAM_ULPS = 4
GRAD = 1e-6
F32_ULP = 2.0 ** -23


def test_synth_batch_is_bitwise_the_reference_every_family():
    for arch in ("internlm2-1.8b", "whisper-tiny", "internvl2-26b"):
        rcfg, cfg = r_get_arch(arch + "-smoke"), get_arch(arch + "-smoke")
        for seed, step in ((0, 0), (3, 17)):
            want = r_synth_batch(rcfg, seed, step, 4, 16)
            got = synth_batch(cfg, seed, step, 4, 16)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
            assert got["tokens"].dtype == torch.int64
            if "frames" in got or "patches" in got:
                stub = got.get("frames", got.get("patches"))
                assert stub.dtype == torch.float32


def test_data_determinism_and_cursor():
    """`tests/test_checkpoint_fault.py::test_data_determinism_and_cursor`
    on the port, against the reference's pipeline."""
    cfg = get_arch("internlm2-1.8b-smoke")
    b1 = synth_batch(cfg, seed=3, step=17, batch=4, seq_len=16)
    b2 = synth_batch(cfg, seed=3, step=17, batch=4, seq_len=16)
    b3 = synth_batch(cfg, seed=3, step=18, batch=4, seq_len=16)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < cfg.vocab_size

    pipe = DataPipeline(cfg, batch=2, seq_len=8, seed=0, start_step=5)
    rpipe = RDataPipeline(r_get_arch("internlm2-1.8b-smoke"), batch=2,
                          seq_len=8, seed=0, start_step=5)
    for _ in range(3):
        got, want = next(pipe), next(rpipe)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    assert pipe.cursor() == rpipe.cursor() == 8
    pipe.close()
    rpipe.close()


def test_pick_accum_matches_reference_every_arch():
    for name in ARCHS:
        for suffix in ("", "-smoke"):
            cfg, rcfg = get_arch(name + suffix), r_get_arch(name + suffix)
            for batch in (1, 2, 4, 8, 16, 64, 256):
                for seq in (32, 128, 1024, 4096, 32768):
                    assert pick_accum(cfg, batch, seq) == r_pick_accum(
                        rcfg, batch, seq), (name + suffix, batch, seq)
    assert sorted(ARCHS) == sorted(R_ARCHS)


@pytest.mark.parametrize("args", [(1.0, 10, 110, 0.1), (3e-4, 20, 200, 0.1),
                                  (3e-3, 0, 50, 0.0)])
def test_cosine_schedule_within_one_ulp(args):
    steps = np.arange(0, args[2] + 20)
    want = np.asarray(jax.vmap(r_cosine_schedule(*args))(
        jnp.asarray(steps, jnp.int32)))
    got = cosine_schedule(*args)(torch.as_tensor(steps, dtype=torch.int32))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    # one float32 ulp of the value, and one ulp of the cosine carried
    # through (1 + cos) (an ulp of cos, or of 1 + cos where its rounding
    # flips): XLA's and PyTorch's float32 cos differ by an ulp at some
    # angles, which near cos = -1 is many ulps of the value
    peak, warmup, total, floor = args
    prog = np.clip((steps - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = np.cos(np.pi * prog).astype(np.float32)
    ulp_cos = np.maximum(np.spacing(np.abs(cos)), np.spacing(1 + cos))
    bar = np.spacing(np.abs(want)) + peak * (1 - floor) * 0.5 * ulp_cos
    assert (np.abs(got - want) <= bar).all()


def _adam_inputs(seed, dtype):
    """Params, gradients of mixed magnitudes (some near eps) as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (4, 3, 2)}
    params = {k: rng.standard_normal(s).astype(dtype)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s)
                  ).astype(dtype) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("clip,wd", [(0.0, 0.0), (1.0, 0.1), (1e-3, 0.0)])
def test_adamw_update_matches_reference(clip, wd, dtype):
    """Three updates on the same numpy params, gradients and state, a
    cosine schedule; with clipping (1e-3 clips every step) and decay."""
    params, grads = _adam_inputs(0, dtype)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd, clip_norm=clip)
    ropt = RAdamW(lr=r_cosine_schedule(1e-2, 1, 5), **kw)
    opt = AdamW(lr=cosine_schedule(1e-2, 1, 5), **kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = ropt.init(rp)
    pp = {k: torch.tensor(v) for k, v in params.items()}
    ps = opt.init(pp)
    for g in grads:
        rp, rs, rm = ropt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 rs, rp)
        _, ps, pm = opt.update({k: torch.tensor(v) for k, v in g.items()},
                               ps, pp)
        assert int(ps.step) == int(rs.step)
        for k in ("grad_norm", "lr"):
            assert abs(float(pm[k]) - float(rm[k])) <= \
                ADAM_ULPS * F32_ULP * abs(float(rm[k])), k
        for got, want in ((pp, rp), (ps.mu, rs.mu), (ps.nu, rs.nu)):
            for k, w in want.items():
                w = np.asarray(w)
                assert got[k].dtype == torch.from_numpy(w).dtype
                err = np.abs(got[k].numpy() - w).max()
                assert err <= ADAM_ULPS * F32_ULP * np.abs(w).max(), k


@functools.cache
def _ref_params():
    from test_torch_train_families import ref_params
    return ref_params(ARCH)


def adam_param_bar(p, mu, nu, mu_old, step, lr, b1, b2, eps):
    """Each element's bound on |port - reference| after one AdamW step
    from the same state, with the gradient known within GRAD (see the
    module docstring); numpy, from the reference's new state."""
    p, mu, nu, mu_old = (np.asarray(a, np.float64)
                         for a in (p, mu, nu, mu_old))
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    g = (mu - b1 * mu_old) / (1 - b1)
    e = GRAD * (np.abs(g).max() + np.abs(g))
    dm = (1 - b1) * e / b1c
    dv = (1 - b2) * (2 * np.abs(g) * e + e * e) / b2c
    r = np.sqrt(nu / b2c)
    dr = np.minimum(np.sqrt(dv), dv / np.maximum(2 * r, 1e-300))
    rmin = np.maximum(r - dr, 0.0)
    mhat = np.abs(mu) / b1c
    d_delta = dm / (rmin + eps) + mhat * dr / ((r + eps) * (rmin + eps))
    return lr * d_delta + 2 * F32_ULP * np.abs(p)


@functools.cache
def _reference_steps(accum):
    """The reference's three steps from its own states: for each, (params
    and state before, batch step, params, state and metrics after) as
    numpy."""
    cfg = r_get_arch(ARCH + "-smoke")
    model = r_build_model(cfg, dtype=jnp.float64)
    opt = RAdamW(lr=r_cosine_schedule(1e-3, 1, 10))
    plan = r_make_train_step(model, opt, mesh=None, accum=accum,
                             donate=False)
    params, state = _ref_params(), opt.init(_ref_params())
    out = []
    for s in range(3):
        batch = r_synth_batch(cfg, 0, s, 4, 32)
        new_p, new_s, m = plan.step_fn(params, state, batch)
        np_ = lambda t: jax.tree.map(np.asarray, t)
        out.append((np_(params), np_(state), s, np_(new_p), np_(new_s),
                    {k: float(v) for k, v in m.items()}))
        params, state = new_p, new_s
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_reference_step_by_step(accum):
    cfg = get_arch(ARCH + "-smoke")
    opt = AdamW(lr=cosine_schedule(1e-3, 1, 10))
    widest = 0.0
    for params, state, s, want_p, want_s, want_m in _reference_steps(accum):
        model = lm_params(params, cfg, device="cpu", dtype=torch.float64)
        plan = make_train_step(model, opt, accum=accum)
        st, m = plan.step_fn(adamw_state(state, model),
                             synth_batch(cfg, 0, s, 4, 32))
        assert int(st.step) == s + 1
        expect = {"loss", "grad_norm", "lr"} | (
            {"ce", "aux"} if accum == 1 else set())
        assert set(m) == set(want_m) == expect
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - want_m[k]) <= 1e-6 * abs(want_m[k]), k
        mu_old = dict(named_leaves(state.mu, model))
        nus = dict(named_leaves(want_s.nu, model))
        for (name, mu), (_, p) in zip(named_leaves(want_s.mu, model),
                                      named_leaves(want_p, model)):
            for got, want, bar in ((st.mu[name], mu, 1e-6),
                                   (st.nu[name], nus[name], 2e-6)):
                err = np.abs(got.numpy() - want).max()
                assert err <= bar * np.abs(want).max(), name
            bound = adam_param_bar(p, mu, nus[name], mu_old[name], s + 1,
                                   want_m["lr"], opt.b1, opt.b2, opt.eps)
            got = model.get_parameter(name).detach().numpy()
            assert (np.abs(got - p) <= bound).all(), name
            widest = max(widest, float((np.abs(got - p) / bound).max()))
    assert widest > 0.0


# ---- the reference's trainer cases (tests/test_trainer.py) on the port --

def _setup(accum=1, lr=1e-3):
    cfg = get_arch("internlm2-1.8b-smoke")
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    opt = AdamW(lr=lr, weight_decay=0.0)
    plan = make_train_step(model, opt, mesh=None, accum=accum, donate=False)
    return cfg, model, opt, opt.init(model), plan


def test_loss_decreases_over_steps():
    cfg, model, opt, opt_state, plan = _setup()
    losses = []
    for s in range(8):
        batch = synth_batch(cfg, seed=0, step=s % 2, batch=4, seq_len=32)
        opt_state, m = plan.step_fn(opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_grad_accum_equivalence():
    """accum=2 over batch 8 == accum=1 over the same batch 8 (same
    update), within the reference's 1e-4."""
    cfg, m1, _, o1, plan1 = _setup(accum=1)
    _, m2, _, o2, plan2 = _setup(accum=2)
    batch = synth_batch(cfg, seed=1, step=0, batch=8, seq_len=32)
    plan1.step_fn(o1, batch)
    plan2.step_fn(o2, batch)
    d = max(float((a - b).abs().max().detach())
            for a, b in zip(m1.parameters(), m2.parameters()))
    assert d < 1e-4, f"accum changed the update by {d}"


def test_adamw_against_manual_step():
    opt = AdamW(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                clip_norm=0.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    st = opt.init(p)
    opt.update({"w": torch.tensor([0.5, 0.5])}, st, p)
    want = 1.0 - 0.1 * (0.5 / (0.5 + 1e-8))
    np.testing.assert_allclose(float(p["w"][0]), want, rtol=1e-5)


def test_clip_norm_applies():
    opt = AdamW(lr=0.0, clip_norm=1.0, weight_decay=0.0)
    p = {"w": torch.ones(4)}
    _, _, m = opt.update({"w": torch.full((4,), 100.0)}, opt.init(p), p)
    assert float(m["grad_norm"]) > 1.0  # reported norm is pre-clip
    assert float(global_norm([torch.full((4,), 100.0)])) == 200.0


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=110, floor_frac=0.1)
    at = lambda s: float(lr(torch.tensor(s)))
    assert at(0) == 0.0
    np.testing.assert_allclose(at(10), 1.0, rtol=1e-5)
    assert 0.09 < at(110) < 0.12
    assert at(60) < 1.0


def test_pick_accum_scales_with_size():
    cfg_big = get_arch("grok-1-314b")
    cfg_small = get_arch("internlm2-1.8b")
    assert pick_accum(cfg_big, 16, 4096) > pick_accum(cfg_small, 16, 4096)
    assert pick_accum(cfg_small, 1, 128) == 1


# ---- the port's own contracts --------------------------------------------

def test_donate_false_leaves_the_state_given():
    cfg, model, opt, st, plan = _setup()
    before = {n: t.clone() for n, t in st.mu.items()}
    new, _ = plan.step_fn(st, synth_batch(cfg, 0, 0, 2, 16))
    assert int(st.step) == 0 and int(new.step) == 1
    assert all(torch.equal(st.mu[n], t) for n, t in before.items())
    assert any(not torch.equal(new.mu[n], t) for n, t in before.items())


def test_refuses_a_mesh_and_an_attention_core():
    cfg, model, opt, st, _ = _setup()
    with pytest.raises(NotImplementedError, match="item 16"):
        make_train_step(model, opt, mesh=object())
    model.attn_core = flash_attention
    plan = make_train_step(model, opt)
    with pytest.raises(ValueError, match="dense attention core"):
        plan.step_fn(st, synth_batch(cfg, 0, 0, 2, 16))


def test_resume_is_bitwise(tmp_path):
    """Two steps, a save through `TrainSupervisor`, a restore into a fresh
    model, then step 3: bitwise an uninterrupted step 3, the data cursor
    included."""
    cfg = get_arch("internlm2-1.8b-smoke")

    def fresh():
        model = build_model(cfg, torch.float32, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        opt = AdamW(lr=cosine_schedule(1e-3, 1, 10))
        return model, opt, make_train_step(model, opt, accum=2)

    model, opt, plan = fresh()
    st = opt.init(model)
    pipe = DataPipeline(cfg, batch=4, seq_len=16, seed=0)
    sup = TrainSupervisor(str(tmp_path), save_every=2, device="cpu")
    for step in (1, 2):
        st, _ = plan.step_fn(st, next(pipe))
        sup.maybe_save(step, train_state(model, st),
                       {"cursor": pipe.cursor()})
    st, m3 = plan.step_fn(st, next(pipe))
    pipe.close()

    model2, opt2, plan2 = fresh()
    like = train_state(model2, opt2.init(model2))
    step, state, extra = sup.resume_or_init(lambda: like, like)
    assert step == 2 and extra["cursor"] == 2
    load_params(model2, state["params"])
    pipe2 = DataPipeline(cfg, batch=4, seq_len=16, seed=0,
                         start_step=extra["cursor"])
    st2, m3b = plan2.step_fn(state["opt"], next(pipe2))
    pipe2.close()
    assert type(st2).__name__ == "AdamWState" and int(st2.step) == 3
    assert torch.equal(m3["loss"], m3b["loss"])
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(a, b), n
    for n in st.mu:
        assert torch.equal(st.mu[n], st2.mu[n])
        assert torch.equal(st.nu[n], st2.nu[n])


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main
    args = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--save-every", "2",
            "--ckpt-dir", str(tmp_path)]
    m = main(args + ["--steps", "2"])
    assert math.isfinite(float(m["loss"]))
    assert ckpt_lib.available_steps(str(tmp_path / "internlm2-1.8b-smoke")) \
        == [2]
    m = main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "from step 0" in out and "from step 2" in out
    assert math.isfinite(float(m["loss"]))
    with pytest.raises(NotImplementedError, match="item 16"):
        main(args + ["--production-mesh"])
