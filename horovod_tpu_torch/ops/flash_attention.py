"""Flash attention: a hand-written CUDA forward kernel plus its plain
PyTorch version.

Counterpart of :mod:`horovod_tpu.ops.pallas_attention`.  The forward on
a CUDA tensor is the kernel in ``kernels/flash_attn_fwd.cu`` (one CTA
per (batch*head, 64-row query tile), online softmax over kv tiles in
registers); on a CPU tensor it is :func:`flash_attention_reference`, a
blockwise emulation of the same grid order and masking.  The dispatch
follows the tensor's device only: a CUDA tensor launches the kernel or
raises, it never falls back to the plain version.

The backward recomputes attention in plain torch, exactly as
``_flash_vjp_bwd`` recomputes it in plain XLA (exact, O(S^2) memory).
"""

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# Kernel launches since the last reset; bumped by the CUDA path only.
launches = 0


def _kernel_lib():
    from .. import kernels
    lib = kernels.load("flash_attn_fwd.cu")
    fn = lib.hvd_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool) -> torch.Tensor:
    """Launch the CUDA kernel on ``[BH, S, D]`` tensors; returns
    ``[BH, Sq, D]`` in ``q.dtype``.  The kernel's tile is fixed at 64 x 64,
    whatever blocks the caller asked the plain version for."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}"
                             ", not a CUDA device")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v must share "
                             "dtype and device")
        if t.dim() != 3:
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"[BH, S, D], got {tuple(t.shape)}")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if k.shape != (BH, Skv, D) or v.shape != (BH, Skv, D):
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not one of "
                         f"{tuple(_DTYPE_CODES)}")
    # The kernel reads rows as 16-byte vectors; a fresh allocation is
    # aligned, a view at an odd offset may not be.
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hvd_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, Sq, Skv, D, _DTYPE_CODES[q.dtype], float(scale),
            int(bool(causal)), stream)
    if err != 0:
        msg = (lib.hvd_cuda_error_string(err).decode() if err > 0
               else "unsupported head dim or dtype")
        raise RuntimeError(f"flash attention kernel launch failed: {msg}")
    launches += 1
    return out


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float, causal: bool,
                              block_q: int = 128,
                              block_k: int = 128) -> torch.Tensor:
    """Plain-torch forward on ``[BH, S, D]``: the TPU kernel's grid order
    (q blocks, then kv blocks in sequence), its causal block skip, its
    finite -1e30 mask and its ``l == 0 -> 1`` rule, all in fp32."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(BH, Sq, D, dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, bq):
        qb = qf[:, q0:q0 + bq]
        rows = qb.shape[1]
        qpos = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        m = torch.full((BH, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros(BH, rows, 1, device=q.device)
        acc = torch.zeros(BH, rows, D, device=q.device)
        for k0 in range(0, Skv, bk):
            if causal and k0 > q0 + bq - 1:
                break
            # The tail block is cut at Skv, which masks the padded keys.
            s = torch.matmul(qb, kf[:, k0:k0 + bk].transpose(1, 2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + s.shape[2],
                                    device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2, keepdim=True)
            acc = acc * corr + torch.matmul(p, vf[:, k0:k0 + bk])
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, q0:q0 + rows] = (acc / l).to(q.dtype)
    return out


def _attention_probs(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        Sq, Skv = s.shape[-2], s.shape[-1]
        mask = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Skv, device=s.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        if q.is_cuda:
            return flash_attention_cuda(q, k, v, scale, causal)
        return flash_attention_reference(q, k, v, scale, causal,
                                         block_q, block_k)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        scale = ctx.scale
        p = _attention_probs(q, k, scale, ctx.causal)
        do32 = do.float()
        dv = torch.matmul(p.transpose(1, 2), do32)
        dp = torch.matmul(do32, v.float().transpose(1, 2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.matmul(ds, k.float()) * scale
        dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Flash attention on ``[B, S, H, D]`` tensors (the JAX package's
    layout).  ``block_q``/``block_k`` set the plain version's blocking;
    the CUDA kernel's tile is fixed."""
    B, Sq, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    def bhsd(x):
        return x.transpose(1, 2).reshape(B * H, x.shape[1], D)

    out = _FlashAttention.apply(bhsd(q), bhsd(k), bhsd(v), float(scale),
                                bool(causal), int(block_q), int(block_k))
    return out.reshape(B, H, Sq, D).transpose(1, 2)
