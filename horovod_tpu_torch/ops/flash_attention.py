"""Flash attention: hand-written CUDA forward and backward kernels plus
their plain PyTorch versions.

Counterpart of :mod:`horovod_tpu.ops.pallas_attention`.  The forward on
a CUDA tensor is the kernel in ``kernels/flash_attn_fwd.cu`` (one unit
of work per (batch*head, query tile), online softmax over kv tiles in
registers); on a CPU tensor it is :func:`flash_attention_reference`, a
blockwise emulation of the same grid order and masking.  The dispatch
follows the tensor's device only: a CUDA tensor launches the kernel or
raises, it never falls back to the plain version or to another body.

The forward kernel has three bodies, picked by :func:`_body_for`: fp32
inputs run the scalar fp32 body; bf16/fp16 with head dim 64 or 128 run
the Hopper body (TMA + wgmma, 128 x 128 tiles); other 16-bit head dims
run the mma.sync body (64 x 64 tiles).

The backward, picked by :func:`_bwd_path_for`: on a CUDA tensor in
bf16/fp16 with head dim 64 or 128 it is the kernel in
``kernels/flash_attn_bwd.cu`` (tiled, from the log-sum-exp the forward's
wgmma body saves; :func:`flash_attention_bwd_reference` is its blockwise
plain version); everywhere else it is :func:`flash_attention_bwd_plain`,
which recomputes attention in plain torch exactly as ``_flash_vjp_bwd``
recomputes it in plain XLA (exact, O(S^2) memory).
"""

import ctypes
import math
from typing import Optional

import torch

from ..common.timeline import span

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
BWD_KERNEL, BWD_PLAIN = "kernel", "plain"
# Kernels one backward call launches: the dq kernel, then the dkdv kernel.
_BWD_KERNELS_PER_CALL = 2

# Kernel launches since the last reset, in total and per body, and of
# the backward's kernels; bumped by the CUDA paths only.
launches = 0
launches_by_body = {BODY_FP32: 0, BODY_MMA: 0, BODY_WGMMA: 0}
bwd_launches = 0

# Per kernel source: the loaded library and its C entry.
_entries = {}


def _body_for(dtype: torch.dtype, head_dim: int) -> int:
    """The kernel body a CUDA call with this dtype and head dim runs."""
    if dtype == torch.float32:
        return BODY_FP32
    if head_dim in WGMMA_HEAD_DIMS:
        return BODY_WGMMA
    return BODY_MMA


def _bwd_path_for(device: torch.device, dtype: torch.dtype,
                  head_dim: int) -> str:
    """The backward a call with this device, dtype and head dim takes:
    the kernel where the forward runs the wgmma body (which saves the
    log-sum-exp the kernel reads), the plain recompute everywhere else."""
    if device.type == "cuda" and _body_for(dtype, head_dim) == BODY_WGMMA:
        return BWD_KERNEL
    return BWD_PLAIN


# The C entries' arguments: pointers and the stream as c_void_p, sizes,
# codes and flags as c_int, the scale as c_float.
_ARGTYPES = {
    # q, k, v, o, lse; bh, sq, skv, d, dtype, body; scale; causal; stream
    "flash_attn_fwd.cu": ("hvd_flash_attn_fwd",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                              ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    # q, k, v, do, lse, dq, dk, dv, delta; bh, sq, skv, d, dtype; scale;
    # causal; stream
    "flash_attn_bwd.cu": ("hvd_flash_attn_bwd",
                          [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
                              ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}


def _kernel_lib(source: str = "flash_attn_fwd.cu"):
    """A kernel library and its C entry, argument types set once per
    loaded library."""
    from .. import kernels
    lib = kernels.load(source)
    entry = _entries.get(source)
    if entry is None or entry[0] is not lib:
        name, argtypes = _ARGTYPES[source]
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        entry = _entries[source] = (lib, fn)
    return entry


def _launch_error(lib, err: int, what: str) -> RuntimeError:
    msg = (lib.hvd_cuda_error_string(err).decode() if err > 0
           else _ERRORS.get(err, f"error {err}"))
    return RuntimeError(f"{what}: {msg}")


def _check_cuda(fn_name: str, names, tensors, dtype, device):
    for name, t in zip(names, tensors):
        if not t.is_cuda:
            raise ValueError(f"{fn_name}: {name} is on {t.device}, not a "
                             "CUDA device")
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{fn_name}: {', '.join(names)} must share "
                             "dtype and device")
        if t.dim() != 3:
            raise ValueError(f"{fn_name}: {name} must be [BH, S, D], got "
                             f"{tuple(t.shape)}")


def _aligned(*tensors):
    """Contiguous copies where needed, at 16-byte-aligned bases: the
    kernels read rows as 16-byte vectors (TMA wants aligned bases); a
    fresh allocation is aligned, a view at an odd offset may not be."""
    out = (t.contiguous() for t in tensors)
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in out)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool,
                         body: Optional[int] = None):
    """Launch the CUDA kernel on ``[BH, S, D]`` tensors; returns the
    output, ``[BH, Sq, D]`` in ``q.dtype``, and each row's log-sum-exp of
    the scaled, masked scores, which the backward kernels read: fp32
    ``[BH, Sq]`` from the wgmma body (undefined where there is no key),
    None from the others.
    ``body`` defaults to ``_body_for(dtype, D)``; naming another one
    (as ``chip_smoke.py`` does to time the mma.sync body) runs that body
    or raises.  The kernel's tile is fixed by the body, whatever blocks
    the caller asked the plain version for."""
    global launches
    _check_cuda("flash_attention_cuda", ("q", "k", "v"), (q, k, v),
                q.dtype, q.device)
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
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty(BH, Sq, dtype=torch.float32, device=q.device)
           if body == BODY_WGMMA else None)
    lib, fn = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), BH, Sq, Skv, D,
                 _DTYPE_CODES[q.dtype], body, float(scale),
                 int(bool(causal)), stream)
    if err != 0 and err != _NO_LAUNCH:
        raise _launch_error(lib, err, f"flash attention kernel launch "
                            f"failed ({BODY_NAMES[body]} body, {q.dtype}, "
                            f"head dim {D})")
    if err == 0:
        launches += 1
        launches_by_body[body] += 1
    return out, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, scale: float, causal: bool):
    """Launch the backward kernels on ``[BH, S, D]`` tensors in bf16 or
    fp16 at head dim 64 or 128, with ``lse`` the forward's fp32
    ``[BH, Sq]`` log-sum-exp; returns ``(dq, dk, dv)`` in the input type
    and ``delta``, fp32 ``[BH, Sq]`` row sums of P o dP."""
    global bwd_launches
    _check_cuda("flash_attention_bwd_cuda", ("q", "k", "v", "do"),
                (q, k, v, do), q.dtype, q.device)
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    if (k.shape != (BH, Skv, D) or v.shape != (BH, Skv, D)
            or do.shape != q.shape):
        raise ValueError(f"flash_attention_bwd_cuda: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and do {tuple(do.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if _bwd_path_for(q.device, q.dtype, D) != BWD_KERNEL:
        raise ValueError(f"flash_attention_bwd_cuda: no kernel for "
                         f"{q.dtype} at head dim {D}")
    if (lse.dtype != torch.float32 or lse.shape != (BH, Sq)
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd_cuda: lse must be float32 "
                         f"{(BH, Sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    q, k, v, do = _aligned(q, k, v, do)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(BH, Sq, dtype=torch.float32, device=q.device)
    if not (BH and Sq and Skv):
        # No pair of a query and a key: every gradient is 0.
        for t in (dq, dk, dv, delta):
            t.zero_()
        return dq, dk, dv, delta
    lib, fn = _kernel_lib("flash_attn_bwd.cu")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), BH, Sq, Skv, D, _DTYPE_CODES[q.dtype],
                 float(scale), int(bool(causal)), stream)
    if err != 0:
        raise _launch_error(lib, err, f"flash attention backward launch "
                            f"failed ({q.dtype}, head dim {D})")
    bwd_launches += _BWD_KERNELS_PER_CALL
    return dq, dk, dv, delta


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float, causal: bool,
                              block_q: int = 128, block_k: int = 128,
                              return_lse: bool = False):
    """Plain-torch forward on ``[BH, S, D]``: the TPU kernel's grid order
    (q blocks, then kv blocks in sequence), its causal block skip, its
    finite -1e30 mask and its ``l == 0 -> 1`` rule, all in fp32.  With
    ``return_lse`` also each row's ``m + log(l)``, fp32 ``[BH, Sq]``, as
    the wgmma body writes it."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(BH, Sq, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(BH, Sq, device=q.device) if return_lse else None
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
        if return_lse:
            lse[:, q0:q0 + rows] = (m + torch.log(l))[..., 0]
    return (out, lse) if return_lse else out


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  lse: torch.Tensor, scale: float,
                                  causal: bool, block_q: int = 64,
                                  block_k: int = 64):
    """Plain-torch version of ``kernels/flash_attn_bwd.cu`` on ``[BH, S,
    D]``, blockwise in fp32: P recomputed per block from the scores and
    ``lse`` (masked entries exactly 0), then the dq kernel's two sweeps
    over the kv blocks (Delta = rowsum(P o dP), then dS = P o (dP - Delta)
    and dq += scale dS . k) and the dkdv kernel's walk of each kv block
    over the q blocks that see it (dv += P^T . do, dk += scale dS^T . q).
    Returns ``(dq, dk, dv)`` in the input type and Delta, fp32
    ``[BH, Sq]``."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    bq, bk = max(1, min(block_q, Sq)), max(1, min(block_k, Skv))
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lse = lse.float()
    dq = torch.zeros(BH, Sq, D, device=q.device)
    dk = torch.zeros(BH, Skv, D, device=q.device)
    dv = torch.zeros(BH, Skv, D, device=q.device)
    delta = torch.zeros(BH, Sq, device=q.device)

    def blocks(q0, k0):
        """P and dP of one block; None where causality masks all of it."""
        if causal and k0 > q0 + bq - 1:
            return None
        qb = qf[:, q0:q0 + bq]
        kb = kf[:, k0:k0 + bk]
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale
        p = torch.exp(s - lse[:, q0:q0 + bq, None])
        if causal:
            qpos = torch.arange(q0, q0 + qb.shape[1], device=q.device)
            kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            p = torch.where(qpos[:, None] >= kpos[None, :], p,
                            torch.zeros_like(p))
        dp = torch.matmul(dof[:, q0:q0 + bq],
                          vf[:, k0:k0 + bk].transpose(1, 2))
        return p, dp

    for q0 in range(0, Sq, bq):
        for k0 in range(0, Skv, bk):
            pd = blocks(q0, k0)
            if pd is not None:
                delta[:, q0:q0 + bq] += (pd[0] * pd[1]).sum(dim=2)
        for k0 in range(0, Skv, bk):
            pd = blocks(q0, k0)
            if pd is not None:
                ds = pd[0] * (pd[1] - delta[:, q0:q0 + bq, None])
                dq[:, q0:q0 + bq] += torch.matmul(ds, kf[:, k0:k0 + bk])
    for k0 in range(0, Skv, bk):
        for q0 in range(0, Sq, bq):
            pd = blocks(q0, k0)
            if pd is not None:
                p, dp = pd
                ds = p * (dp - delta[:, q0:q0 + bq, None])
                dv[:, k0:k0 + bk] += torch.matmul(p.transpose(1, 2),
                                                  dof[:, q0:q0 + bq])
                dk[:, k0:k0 + bk] += torch.matmul(ds.transpose(1, 2),
                                                  qf[:, q0:q0 + bq])
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype), delta)


def _attention_probs(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        Sq, Skv = s.shape[-2], s.shape[-1]
        mask = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Skv, device=s.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              scale: float, causal: bool):
    """The exact backward on ``[BH, S, D]``: attention recomputed in fp32
    over the whole S x S matrix, as ``_flash_vjp_bwd`` does in XLA.
    Returns ``(dq, dk, dv)`` in the input type."""
    p = _attention_probs(q, k, scale, causal)
    do32 = do.float()
    dv = torch.matmul(p.transpose(1, 2), do32)
    dp = torch.matmul(do32, v.float().transpose(1, 2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        ctx.scale, ctx.causal = scale, causal
        ctx.bwd_path = _bwd_path_for(q.device, q.dtype, q.shape[-1])
        with span("flash.fwd"):
            if q.is_cuda:
                out, lse = flash_attention_cuda(q, k, v, scale, causal)
            else:
                out, lse = flash_attention_reference(
                    q, k, v, scale, causal, block_q, block_k), None
            # lse is None unless the backward is the kernel, which reads it.
            ctx.save_for_backward(q, k, v, lse)
            return out

    @staticmethod
    def backward(ctx, do):
        with span("flash.bwd", path=ctx.bwd_path):
            q, k, v, lse = ctx.saved_tensors
            if ctx.bwd_path == BWD_KERNEL:
                dq, dk, dv, _ = flash_attention_bwd_cuda(
                    q, k, v, do, lse, ctx.scale, ctx.causal)
            else:
                dq, dk, dv = flash_attention_bwd_plain(
                    q, k, v, do, ctx.scale, ctx.causal)
            return dq, dk, dv, None, None, None, None


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
