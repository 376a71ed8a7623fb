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

`flash_attention_kernel` is the wrapper of the CUDA kernel
`csrc/flash_attention.cu`, which replaces the TPU kernel
`repro.kernels.flashattn.kernel.flash_attention_pallas`: on CUDA tensors it
checks its inputs and launches the kernel (or raises); on CPU tensors, and
only there, it runs `flash_attention_plain`.  The kernel tiles by 64 query
rows and 64 keys, whatever ``block_q`` and ``block_k`` say (they were
chosen for the TPU's VMEM), so its sums are taken in another order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
MASKED = -1e30

# launches of the CUDA kernel since the counter was last set to 0
launches = 0


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


@functools.lru_cache(maxsize=None)
def _bind():
    from repro_torch.kernels.build import load
    fn = load(SOURCE).flash_attention_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, i32, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                   ctypes.c_float, vp]
    fn.restype = i32
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
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _bind()(DTYPE_IDS[q.dtype], hd, int(bool(causal)), q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H,
                     KV, 1.0 / float(hd) ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out
