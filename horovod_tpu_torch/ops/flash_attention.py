"""Flash attention: a hand-written CUDA forward kernel plus its plain
PyTorch version.

Counterpart of :mod:`horovod_tpu.ops.pallas_attention`.  The forward on
a CUDA tensor is the kernel in ``kernels/flash_attn_fwd.cu`` (one unit
of work per (batch*head, query tile), online softmax over kv tiles in
registers); on a CPU tensor it is :func:`flash_attention_reference`, a
blockwise emulation of the same grid order and masking.  The dispatch
follows the tensor's device only: a CUDA tensor launches the kernel or
raises, it never falls back to the plain version or to another body.

The kernel has three bodies, picked by :func:`_body_for`: fp32 inputs
run the scalar fp32 body; bf16/fp16 with head dim 64 or 128 run the
Hopper body (TMA + wgmma, 128 x 128 tiles); other 16-bit head dims run
the mma.sync body (64 x 64 tiles).

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
BODY_FP32, BODY_MMA, BODY_WGMMA = 0, 1, 2
BODY_NAMES = {BODY_FP32: "fp32 scalar", BODY_MMA: "mma.sync",
              BODY_WGMMA: "wgmma"}
WGMMA_HEAD_DIMS = (64, 128)
_ERRORS = {-1: "the body does not take this dtype and head dim",
           -2: "cuTensorMapEncodeTiled refused a TMA tensor map"}
# The C entry's answer when the output was complete without a kernel (it
# is empty, or there is no key and it was zeroed): nothing is counted.
_NO_LAUNCH = -3

# Kernel launches since the last reset, in total and per body; bumped by
# the CUDA path only.
launches = 0
launches_by_body = {BODY_FP32: 0, BODY_MMA: 0, BODY_WGMMA: 0}

_entry = None


def _body_for(dtype: torch.dtype, head_dim: int) -> int:
    """The kernel body a CUDA call with this dtype and head dim runs."""
    if dtype == torch.float32:
        return BODY_FP32
    if head_dim in WGMMA_HEAD_DIMS:
        return BODY_WGMMA
    return BODY_MMA


def _kernel_lib():
    """The kernel library and its C entry, argument types set once per
    loaded library."""
    global _entry
    from .. import kernels
    lib = kernels.load("flash_attn_fwd.cu")
    if _entry is None or _entry[0] is not lib:
        fn = lib.hvd_flash_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _entry = (lib, fn)
    return _entry


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool,
                         body: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on ``[BH, S, D]`` tensors; returns
    ``[BH, Sq, D]`` in ``q.dtype``.  ``body`` defaults to
    ``_body_for(dtype, D)``; naming another one (as ``chip_smoke.py``
    does to time the mma.sync body) runs that body or raises.  The
    kernel's tile is fixed by the body, whatever blocks the caller
    asked the plain version for."""
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
    if body is None:
        body = _body_for(q.dtype, D)
    elif body not in BODY_NAMES:
        raise ValueError(f"flash_attention_cuda: body {body} is not one of "
                         f"{tuple(BODY_NAMES)}")
    # The kernel reads rows as 16-byte vectors (TMA wants 16-byte-aligned
    # bases); a fresh allocation is aligned, a view at an odd offset may
    # not be.
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    lib, fn = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, Sq, Skv, D, _DTYPE_CODES[q.dtype], body, float(scale),
                 int(bool(causal)), stream)
    if err == _NO_LAUNCH:
        return out
    if err != 0:
        msg = (lib.hvd_cuda_error_string(err).decode() if err > 0
               else _ERRORS.get(err, f"error {err}"))
        raise RuntimeError(f"flash attention kernel launch failed "
                           f"({BODY_NAMES[body]} body, {q.dtype}, head dim "
                           f"{D}): {msg}")
    launches += 1
    launches_by_body[body] += 1
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
