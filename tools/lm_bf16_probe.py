#!/usr/bin/env python3
"""How far a bf16 LM of the zoo sits from f32 (and f64), layer by layer,
and whether an MoE's routing flips: the evidence behind `chip_smoke.py`'s
`LM_HOLD_BLOCKS` and `RoutingReplay`.

    python3 tools/lm_bf16_probe.py card [--out FILE]
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/lm_bf16_probe.py \\
        reference [--layers 1,2,4] [--T 256]

``card`` (one NVIDIA H100, the port only): mamba2-2.7b (64 layers),
deepseek-moe-16b's first 2 blocks and recurrentgemma-9b (38 layers) at
full width, weights from the smoke's seeded generator, the smoke's
prompts (`chip_smoke.family_batch`).  The same weights run the prefill in
bf16, f32 and, where it fits, f64; printed: the logits' relative norm of
each pair, the last token's residual stream (each pre-norm input) of each
pair every 4th norm, the MoE tokens routed to other experts in each
layer (all tokens and the last ones), and decode at T against `forward`
on T + 1 in f32.  Exits non-zero where CUDA is absent.

``reference`` (the CPU, imports JAX and the reference package): Mamba-2
at full width (vocab cut to 512), the given depths, one prompt of T
tokens, numpy weights in the reference's layout (`convert.lm_params` for
the port): the final hidden state of the last token in bf16 against f32,
in the reference and in the port, and the two packages against each
other in each dtype: whether the port's bf16 drift is the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (arch, requests, prompt, cache_len, blocks or None for all, f64 too)
CARD_CASES = (("mamba2-2.7b", 2, 2048, 2064, None, True),
              ("deepseek-moe-16b", 2, 2048, 2064, 2, True),
              ("recurrentgemma-9b", 2, 3072, 3088, None, False))


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def card(out_path):
    import torch
    if not torch.cuda.is_available():
        print("lm_bf16_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.models.lm as lm
    import repro_torch.models.moe as moe
    from repro_torch.configs.archs import get_arch
    from repro_torch.models.model import build_model
    dev = torch.device("cuda", 0)
    print(cs.gpu_line())
    real_rms, real_route = lm.rmsnorm, moe.moe_route
    norms, routes = [], []

    def rec_rms(x, scale, eps=1e-5):
        norms.append(x[:, -1].double().clone())
        return real_rms(x, scale, eps)

    def rec_route(x, router, **kw):
        r = real_route(x, router, **kw)
        routes.append(r.topi.sort(dim=-1).values)
        return r

    def prefill(cfg, dtype, sd, batch, cache_len):
        m = build_model(cfg, dtype)
        m.load_state_dict({k: sd[k] for k in m.state_dict()})
        norms.clear()
        routes.clear()
        lm.rmsnorm, moe.moe_route = rec_rms, rec_route
        try:
            with torch.inference_mode():
                logits, cache = m.prefill(batch, cache_len)
        finally:
            lm.rmsnorm, moe.moe_route = real_rms, real_route
        return m, cache, (logits[..., :cfg.vocab_size], list(norms),
                          list(routes))

    def compare(a, b, B):
        out = {"logits_rel": rel(a[0], b[0]),
               "residual_rel": [rel(x, y) for x, y in zip(a[1], b[1])]}
        if a[2]:
            out["rerouted"] = [int((x != y).any(-1).sum())
                               for x, y in zip(a[2], b[2])]
            out["rerouted_last"] = [
                int((x.reshape(B, -1, x.shape[-1])[:, -1]
                     != y.reshape(B, -1, y.shape[-1])[:, -1]).any(-1).sum())
                for x, y in zip(a[2], b[2])]
        return out

    report = {"device": cs.gpu_line(), "cases": {}}
    for arch, B, T, cache_len, blocks, f64 in CARD_CASES:
        t = time.perf_counter()
        cfg = get_arch(arch)
        if blocks:
            cfg = dataclasses.replace(cfg, n_layers=blocks)
        mb = build_model(cfg, torch.bfloat16).init_params(
            torch.Generator(dev).manual_seed(cs.LM_SEED))
        sd = mb.state_dict()
        batch = cs.family_batch(cfg, B, T, dev, cs.LM_SEED)
        _, _, ob = prefill(cfg, torch.bfloat16, sd, batch, cache_len)
        m32, c32, o32 = prefill(cfg, torch.float32, sd, batch, cache_len)
        case = {"layers": cfg.n_layers, "bf16_vs_f32": compare(ob, o32, B)}
        if f64:
            _, _, o64 = prefill(cfg, torch.float64, sd, batch, cache_len)
            case["f32_vs_f64"] = compare(o32, o64, B)
            case["bf16_vs_f64"] = compare(ob, o64, B)
            del o64
        with torch.inference_mode():
            tok = o32[0].argmax(-1)
            dec, _ = m32.decode_step(c32, tok)
            full = dict(batch, tokens=torch.cat([batch["tokens"], tok], 1))
            fwd = cs.family_forward_last(m32, cfg, full)
        V = cfg.vocab_size
        case["f32_decode_vs_forward"] = rel(dec[..., :V], fwd[..., :V])
        case["seconds"] = time.perf_counter() - t
        report["cases"][arch] = case
        for what in ("bf16_vs_f32", "f32_vs_f64", "bf16_vs_f64"):
            if what in case:
                c = case[what]
                print(f"{arch} L={cfg.n_layers} {what}: logits "
                      f"{c['logits_rel']:.4e}; residual stream every 4th "
                      f"norm {[round(x, 5) for x in c['residual_rel'][::4]]}"
                      + (f"; rerouted a layer {c['rerouted']}, last tokens "
                         f"{c['rerouted_last']}" if "rerouted" in c else ""))
        print(f"{arch}: f32 decode at T against forward on T + 1 "
              f"{case['f32_decode_vs_forward']:.4e} ({case['seconds']:.1f} s)")
        del mb, sd, m32, c32
        torch.cuda.empty_cache()
    print(json.dumps(report))
    if out_path:
        Path(out_path).write_text(json.dumps(report, indent=1))
    return 0


def reference(layers, T):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs.archs import MAMBA2_2_7B
    from repro.models.model import build_model as r_build_model
    from repro_torch.convert import lm_params
    jax.config.update("jax_enable_x64", True)
    cfg = dataclasses.replace(MAMBA2_2_7B, n_layers=max(layers),
                              vocab_size=512)
    shapes = jax.eval_shape(r_build_model(cfg, dtype=jnp.bfloat16)
                            .init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    consts = {"final_norm": 0.0, "ln": 0.0, "gate_norm": 0.0, "dt_bias": 0.0,
              "A_log": 0.0, "D_skip": 1.0}

    def draw(path, leaf):     # the reference's init distributions
        name = path[-1].key
        if name in consts:
            return np.full(leaf.shape, consts[name], np.float32)
        scale = {"conv_w": 0.5, "embed": 0.02}.get(name,
                                                   leaf.shape[-2] ** -0.5)
        return rng.standard_normal(leaf.shape, dtype=np.float32) * scale

    base = jax.tree_util.tree_map_with_path(draw, shapes)
    island = jax.tree.map(lambda s: s.dtype == jnp.float32, shapes)
    toks = rng.integers(0, cfg.vocab_size, (1, T))
    for L in layers:
        c = dataclasses.replace(cfg, n_layers=L)
        p = dict(base, blocks=jax.tree.map(lambda a: a[:L], base["blocks"]))
        last = {}
        for dt in ("bfloat16", "float32"):
            jd = getattr(jnp, dt)
            rp = jax.tree.map(lambda a, i: jnp.asarray(
                a, jnp.float32 if i else jd), p, island)
            x = jax.jit(r_build_model(c, dtype=jd).forward)(rp,
                                                           jnp.asarray(toks))
            last["reference", dt] = torch.from_numpy(
                np.asarray(x, np.float64)[0, -1])
            pm = lm_params(p, c, device="cpu", dtype=getattr(torch, dt))
            with torch.inference_mode():
                last["port", dt] = pm.forward(torch.as_tensor(toks))[0, -1]
        print(f"L={L}: bf16 against f32, reference "
              f"{rel(last['reference', 'bfloat16'], last['reference', 'float32']):.4e}"
              f", port {rel(last['port', 'bfloat16'], last['port', 'float32']):.4e}"
              f"; port against reference, f32 "
              f"{rel(last['port', 'float32'], last['reference', 'float32']):.4e}"
              f", bf16 "
              f"{rel(last['port', 'bfloat16'], last['reference', 'bfloat16']):.4e}",
              flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("card")
    c.add_argument("--out")
    r = sub.add_parser("reference")
    r.add_argument("--layers", default="1,2,4")
    r.add_argument("--T", type=int, default=256)
    args = ap.parse_args()
    if args.mode == "card":
        return card(args.out)
    return reference([int(x) for x in args.layers.split(",")], args.T)


if __name__ == "__main__":
    sys.exit(main())
