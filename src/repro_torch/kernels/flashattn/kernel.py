"""Flash attention, forward (K7) — the counterpart of
`repro.kernels.flashattn.kernel`.

`flash_attention_plain` is the plain version: the reference's
`_flash_kernel` as torch operations, vectorised over (batch, head,
q-block) and looping over K/V blocks with the online-softmax recurrence
[Dao et al.]

    m' = max(m, rowmax(s));  p = exp(s - m')
    l' = l·exp(m - m') + rowsum(p);  acc' = acc·exp(m - m') + p @ V

under the reference's rules: q is cast to float32 and multiplied by
``hd**-0.5`` before the products, masked scores are -1e30 (not -inf), K/V
blocks above the diagonal are skipped by the reference's ``upper``
formula, ``l = max(l, 1e-30)``, and the output is cast to q's dtype (so a
float64 input is computed in float32, as the reference's
``astype(float32)`` does).  GQA maps head h to kv head ``h // (H // KV)``.

`flash_attention_kernel` is the wrapper of the CUDA kernel, which
replaces the TPU kernel
`repro.kernels.flashattn.kernel.flash_attention_pallas`: on CUDA tensors it
checks its inputs and launches the kernel (or raises); on CPU tensors, and
only there, it runs `flash_attention_plain`.  The kernel has two forms,
chosen statically from (dtype, hd) by `form_of`:

- ``"sm90"`` (`csrc/flash_attention_sm90.cu`), bfloat16 at the head dims
  of `SM90_HEAD_DIMS`: both products on the tensor cores (wgmma), tiles by
  TMA, 128 query rows and 128 keys a tile.  It scales the float32 scores
  (not q) and rounds P to bfloat16 before P V, as SDPA does, so it lies
  within 3·2^-8·max|v| elementwise and 2^-8 by relative norm of the plain
  version;
- ``"cuda_core"`` (`csrc/flash_attention.cu`), everything else: float32
  FMAs on the CUDA cores, 64 x 64 tiles, within 2e-5 (float32, float64)
  or 2 bfloat16 ulps of the plain version.

Neither form follows ``block_q`` and ``block_k`` (chosen for the TPU's
VMEM), so sums are taken in another order.  A form that fails to build or
launch raises: the wrapper never falls back to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "flash_attention.cu"          # the CUDA-core form
SM90_SOURCE = "flash_attention_sm90.cu"  # the tensor-core form
HEAD_DIMS = (16, 32, 64, 128, 256)   # the CUDA-core form's instantiations
# the (dtype, hd) instantiations of the tensor-core form
SM90_HEAD_DIMS = {torch.bfloat16: (64, 128)}
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# both C entries: (dtype_id, hd, causal, q, k, v, o, B, T, S, H, KV, scale,
# stream)
ARGTYPES = ((ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 4
            + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_void_p))
MASKED = -1e30

# launches of the CUDA kernel (either form) since the counter was last set
# to 0, and of its tensor-core form alone
launches = 0
launches_sm90 = 0


def flash_attention_plain(q, k, v, *, causal=True, block_q=128,
                          block_k=128):
    """q (B, T, H, hd); k/v (B, S, KV, hd) -> (B, T, H, hd), with
    T % block_q == 0 and S % block_k == 0 (`ops.flash_attention` pads)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    assert T % block_q == 0 and S % block_k == 0
    g = H // KV
    nq, nblk = T // block_q, S // block_k
    scale = 1.0 / float(hd) ** 0.5
    # (B, H, nq, bq, hd); k, v as (B, H, S, hd) by the GQA head map
    qf = (q.float() * scale).reshape(B, nq, block_q, H, hd) \
        .permute(0, 3, 1, 2, 4)
    kv_of = torch.arange(H, device=q.device) // g
    kf = k.permute(0, 2, 1, 3)[:, kv_of]
    vf = v.permute(0, 2, 1, 3)[:, kv_of]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, H, nq, block_q), -torch.inf, **f32)
    l = torch.zeros((B, H, nq, block_q), **f32)
    acc = torch.zeros((B, H, nq, block_q, hd), **f32)
    qi = torch.arange(nq, device=q.device)
    rows = (qi[:, None] * block_q
            + torch.arange(block_q, device=q.device))[:, :, None]
    if causal:
        # K/V block j contributes only if j*block_k <= (qi+1)*block_q - 1
        upper = torch.clamp((qi * block_q + block_q + block_k - 1)
                            // block_k, max=nblk).tolist()
    else:
        upper = [nblk] * nq
    for j in range(max(upper)):
        i0 = next(i for i in range(nq) if upper[i] > j)  # upper ascends
        kb = kf[:, :, j * block_k:(j + 1) * block_k].float()
        vb = vf[:, :, j * block_k:(j + 1) * block_k].float()
        s = qf[:, :, i0:] @ kb[:, :, None].transpose(-1, -2)
        if causal:
            cols = j * block_k + torch.arange(block_k, device=q.device)
            s = torch.where(cols <= rows[i0:], s, MASKED)
        m_old = m[:, :, i0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        l[:, :, i0:] = l[:, :, i0:] * alpha + p.sum(dim=-1)
        acc[:, :, i0:] = acc[:, :, i0:] * alpha[..., None] \
            + p @ vb[:, :, None]
        m[:, :, i0:] = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return out.permute(0, 2, 3, 1, 4).reshape(B, T, H, hd)


def form_of(dtype, hd) -> str:
    """The kernel form that takes (dtype, hd) on the card: "sm90" or
    "cuda_core"."""
    return "sm90" if hd in SM90_HEAD_DIMS.get(dtype, ()) else "cuda_core"


@functools.lru_cache(maxsize=None)
def _bind(form):
    from repro_torch.kernels.build import load
    if form == "sm90":
        fn = load(SM90_SOURCE).flash_attention_sm90_launch
    else:
        fn = load(SOURCE).flash_attention_launch
    fn.argtypes = list(ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q, k, v, *, causal=True, block_q=128,
                           block_k=128):
    """q (B, T, H, hd); k/v (B, S, KV, hd) -> (B, T, H, hd).

    T % block_q == 0, S % block_k == 0 (`ops.flash_attention` pads), as the
    reference's `flash_attention_pallas` asserts.  GQA by head mapping."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, not "
                         f"{q.device.type}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd) and k, v (B, S, KV, hd), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if T % block_q or S % block_k:
        raise ValueError(f"T = {T} and S = {S} must be multiples of "
                         f"block_q = {block_q} and block_k = {block_k}")
    if q.dtype not in DTYPE_IDS:
        raise TypeError(f"the flash attention kernel takes float32, bfloat16 "
                        f"or float64, not {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel is compiled for head "
                         f"dims {HEAD_DIMS}, got hd = {hd}")
    if KV < 1 or H % KV:
        raise ValueError(f"H = {H} query heads must be a multiple of "
                         f"KV = {KV} kv heads")
    if not (1 <= B < 2 ** 16 and 1 <= H < 2 ** 16 and 1 <= T < 2 ** 31
            and 1 <= S < 2 ** 31):
        raise ValueError(f"shape out of the kernel's range: B={B}, T={T}, "
                         f"S={S}, H={H}")
    for what, x, shape in (("q", q, (B, T, H, hd)), ("k", k, (B, S, KV, hd)),
                           ("v", v, (B, S, KV, hd))):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{what} must be a {q.dtype} tensor on "
                             f"{q.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous with shape {shape}, "
                             f"got {tuple(x.shape)}")
    return _launch(form_of(q.dtype, hd), q, k, v, causal)


def _launch(form, q, k, v, causal):
    """One launch of `form` on checked CUDA tensors."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if form == "sm90" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the sm90 flash attention form reads q, k and v "
                         "by TMA: their storage must be 16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _bind(form)(DTYPE_IDS[q.dtype], hd, int(bool(causal)),
                         q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, T, S, H, KV,
                         1.0 / float(hd) ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention ({form} form) launch failed: "
                           f"CUDA error {rc}")
    global launches, launches_sm90
    launches += 1
    launches_sm90 += form == "sm90"
    return out
