"""Mamba-2 / SSD (state-space duality) layer [arXiv:2405.21060] — the
counterpart of `repro.models.ssm`.

Training/prefill uses the chunked block decomposition: quadratic
attention-like compute *within* chunks + a linear recurrence *across* chunk
states (a Python loop over the T / chunk chunks).  Decode is the O(1)
recurrent step h' = exp(dt·A) h + dt·x⊗B, y = C·h.

Shapes: x (B, T, D); inner width d_in = expand·D split into H heads of P;
state N per head shared B/C.  The reference keeps dt_bias, A_log and D_skip
in float32 whatever the model's dtype, takes dt in float32 and runs the
whole decode step in float32: so does this module, so a float64 model
rounds where the reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import NORMAL, draw, rmsnorm


def softplus(x):
    """The reference's `jax.nn.softplus`: max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def ssd_spec(cfg, dtype):
    D, din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K = cfg.ssm_heads, cfg.ssm_conv
    f32 = torch.float32
    return {
        "w_x": ((D, din), dtype, NORMAL),
        "w_z": ((D, din), dtype, NORMAL),
        "w_B": ((D, N), dtype, NORMAL),
        "w_C": ((D, N), dtype, NORMAL),
        "w_dt": ((D, H), dtype, NORMAL),
        "dt_bias": ((H,), f32, 0.0),
        "A_log": ((H,), f32, 0.0),      # A = -exp(A_log) = -1
        "D_skip": ((H,), f32, 1.0),
        "conv_w": ((K, din + 2 * N), dtype, ("normal", 0.5)),
        "gate_norm": ((din,), dtype, 0.0),
        "w_out": ((din, D), dtype, NORMAL),
    }


def ssd_params(generator, cfg, dtype, device=None):
    return draw(generator, ssd_spec(cfg, dtype), device)


def _causal_conv(u, w, state=None):
    """Depthwise causal conv. u (B, T, C), w (K, C). state: (B, K-1, C) tail of
    the previous tokens (decode) or None (train: left-pad zeros).
    Returns (y (B,T,C), new_state (B, K-1, C))."""
    K = w.shape[0]
    B, T, C = u.shape
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)                 # (B, K-1+T, C)
    y = torch.zeros_like(u)
    for k in range(K):
        y = y + ext[:, k:k + T, :] * w[k]
    new_state = ext[:, T:, :] if K > 1 else state
    return y, new_state


def ssd_chunked(xh, dt, B_in, C_in, A, chunk: int, h0=None):
    """Chunked SSD scan.

    xh (B,T,H,P), dt (B,T,H) [post-softplus], B_in/C_in (B,T,N), A (H,) (<0).
    h0: initial state (B,H,P,N) or None. Returns (y (B,T,H,P), h_final).
    The state and decay math is in result_type(float32, xh.dtype)."""
    Bsz, T, H, P = xh.shape
    N = B_in.shape[-1]
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"seq {T} % chunk {L} != 0")
    nc = T // L
    f32 = torch.promote_types(torch.float32, xh.dtype)

    xc = xh.reshape(Bsz, nc, L, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, L, H).to(f32)
    Bc = B_in.reshape(Bsz, nc, L, N).to(f32)
    Cc = C_in.reshape(Bsz, nc, L, N).to(f32)

    dA = dtc * A                                        # (B,c,L,H) log-decay
    lcum = torch.cumsum(dA, dim=2)                      # inclusive
    # ---- intra-chunk (attention-like) ----
    # decay[l,s] = exp(lcum[l] - lcum[s]) for s<=l else 0.  The masked
    # exponents go to -inf before the exp (the reference takes exp first,
    # then selects 0): the same values, but exp of a masked entry
    # overflows at long chunks (lcum[l] - lcum[s] > 0 for s > l), and
    # the select's backward then multiplies that inf by 0
    dec = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]   # (B,c,L,S,H)
    ar = torch.arange(L, device=xh.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    dec = torch.exp(torch.where(mask, dec, -torch.inf))
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    scores = cb[..., None] * dec * dtc[:, :, None, :, :]    # (B,c,L,S,H)
    del dec
    y_intra = torch.einsum("bclsh,bcshp->bclhp", scores, xc)
    del scores

    # ---- chunk states ----
    last = lcum[:, :, -1:, :]                                # (B,c,1,H)
    decay_to_end = torch.exp(last - lcum)                    # (B,c,L,H)
    S_c = torch.einsum("bclh,bcln,bclhp->bchpn", decay_to_end * dtc, Bc, xc)

    # ---- inter-chunk recurrence (a loop over chunks) ----
    chunk_decay = torch.exp(last[:, :, 0, :])                # (B,c,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
         if h0 is None else h0)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_starts = torch.stack(starts, dim=1)                    # (B,c,H,P,N)

    # ---- contribution of carried-in state ----
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cc, torch.exp(lcum),
                           h_starts)
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    return y.to(xh.dtype), h


def _in_proj(x, p, cfg, conv_state):
    """The projections and the causal conv: (xi, Bv, Cv, z, dt, conv
    state)."""
    din, N = cfg.d_inner, cfg.ssm_state
    conv_in = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], dim=-1)
    cy, conv_new = _causal_conv(conv_in, p["conv_w"], conv_state)
    cy = F.silu(cy)
    dt = softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    return (cy[..., :din], cy[..., din:din + N], cy[..., din + N:],
            x @ p["w_z"], dt, conv_new)


def ssd_layer_train(x, p, cfg, chunk=256, state=None):
    """Full mamba2 block. x (B,T,D) -> (y (B,T,D), new_state dict)."""
    din, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    B, T, D = x.shape
    xi, Bv, Cv, z, dt, conv_new = _in_proj(
        x, p, cfg, None if state is None else state["conv"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, T, H, P)
    y, h_fin = ssd_chunked(xh, dt, Bv, Cv, A, chunk,
                           h0=None if state is None else state["h"])
    y = y + p["D_skip"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(B, T, din)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h_fin, "conv": conv_new}


def ssd_layer_decode(x, p, cfg, state):
    """One-token decode. x (B,1,D); state dict(h (B,H,P,N) f32, conv)."""
    din, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    B = x.shape[0]
    xi, Bv, Cv, z, dt, conv_new = _in_proj(x, p, cfg, state["conv"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, 1, H, P).float()
    dA = torch.exp(dt[:, 0] * A)                              # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0],
                       Bv[:, 0].float())
    h = state["h"] * dA[..., None, None] + upd
    # h is the prefill's state: wider than float32 in a float64 model
    y = torch.einsum("bn,bhpn->bhp", Cv[:, 0].float().to(h.dtype), h)
    y = y + p["D_skip"][None, :, None] * xh[:, 0]
    y = y.reshape(B, 1, din).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["w_out"], {"h": h, "conv": conv_new}
