"""Adasum reduction: scale-insensitive gradient combining.

Counterpart of :mod:`horovod_tpu.ops.adasum` (reference: ops/adasum/
adasum.h:38-547).  Each pairwise merge is

    a' = (1 - a.b / (2 |a|^2)) a + (1 - a.b / (2 |b|^2)) b

with the dot products and norms taken per tensor, over the whole
tensor, at every level, in fp64 for fp16/bf16 inputs and fp32 otherwise;
a zero norm leaves its coefficient at 1.  The member count must be a
power of two.

The ladder is recursive doubling: at level k member i exchanges its
current vector with member i ^ 2^k (``dist.batch_isend_irecv``) and both
compute the same merge, since the rule is symmetric under swapping its
operands.  A fused response packs its tensors into one buffer, so each
level exchanges one buffer; the dots stay per tensor segment.
"""

import math
from typing import Callable, List, Sequence, Tuple

import torch

from . import fusion_buffer as fb


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def check_group_size(n: int):
    if not _is_pow2(n):
        raise ValueError(
            f"Adasum requires a power-of-2 world size, got {n} "
            "(matching the reference implementation's constraint).")


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the dot products for inputs of ``dtype``."""
    return torch.float64 if dtype in (torch.float16, torch.bfloat16) \
        else torch.float32


def merge(v: torch.Tensor, u: torch.Tensor,
          segments: Sequence[Tuple[int, int]],
          acc: torch.dtype) -> torch.Tensor:
    """One level's pairwise merge of two fp32 buffers, with each
    ``(offset, length)`` segment's dots taken on its own."""
    out = torch.zeros_like(v)
    for off, n in segments:
        vs, us = v[off:off + n], u[off:off + n]
        va, ua = vs.to(acc), us.to(acc)
        dot = torch.dot(va, ua)
        nv = torch.dot(va, va)
        nu = torch.dot(ua, ua)
        one = torch.ones((), dtype=acc, device=v.device)
        cv = torch.where(nv != 0, 1.0 - dot / (2.0 * nv), one)
        cu = torch.where(nu != 0, 1.0 - dot / (2.0 * nu), one)
        out[off:off + n] = cv.float() * vs + cu.float() * us
    return out


def ladder(members: List[torch.Tensor],
           segments: Sequence[Tuple[int, int]],
           acc: torch.dtype) -> List[torch.Tensor]:
    """Every member's result of the recursive-doubling ladder, computed
    in one process (each level merges member i with member i ^ 2^k)."""
    check_group_size(len(members))
    vs = list(members)
    for k in range(int(math.log2(len(vs)))):
        d = 1 << k
        vs = [merge(vs[i], vs[i ^ d], segments, acc) for i in range(len(vs))]
    return vs


def adasum_allreduce(arrays: Sequence[torch.Tensor], prescale: float,
                     postscale: float, ranks: Sequence[int], my_index: int,
                     exchange: Callable[[torch.Tensor, int], torch.Tensor],
                     buffers: fb.FusionBuffers = None) -> List[torch.Tensor]:
    """Adasum of one fused response across the group ``ranks`` (this
    rank is ``ranks[my_index]``).  ``exchange(v, peer_rank)`` sends ``v``
    to ``peer_rank`` and returns what it sent back.  The tensors share
    one dtype and device; each is prescaled in its dtype, merged in
    fp32, cast back and postscaled, as the JAX body does per tensor."""
    check_group_size(len(ranks))
    dtype, device = arrays[0].dtype, arrays[0].device
    numels = [a.numel() for a in arrays]
    offsets, total = fb.layout(numels, dtype)
    out = buffers.get(device, dtype, total) if buffers is not None else None
    flat = fb.pack(arrays, prescale, out=out)
    segments = list(zip(offsets, numels))
    acc = acc_dtype(dtype)
    v = flat.float()
    for k in range(int(math.log2(len(ranks)))):
        peer = ranks[my_index ^ (1 << k)]
        v = merge(v, exchange(v, peer), segments, acc)
    outs = [torch.empty(a.shape, dtype=dtype, device=device) for a in arrays]
    fb.unpack(v.to(dtype), outs, postscale)
    return outs


def adasum_reduce_ingraph(x: torch.Tensor, axis_name, n: int,
                          eps: float = 0.0) -> torch.Tensor:
    """Adasum over a mesh axis of ``n`` members, inside
    :func:`horovod_tpu_torch.parallel.shard_map`: the same ladder, each
    level's exchange a ``ppermute`` with the member ``i ^ 2^k``.  Merges
    in fp32 with the dots in :func:`acc_dtype`; returns ``x.dtype``."""
    from ..parallel.collectives import ppermute
    check_group_size(n)
    acc = acc_dtype(x.dtype)
    v = x.float()
    for k in range(int(math.log2(n))):
        d = 1 << k
        u = ppermute(v, [(i, i ^ d) for i in range(n)], axis_name)
        va, ua = v.to(acc).reshape(-1), u.to(acc).reshape(-1)
        dot = torch.dot(va, ua)
        nv = torch.dot(va, va)
        nu = torch.dot(ua, ua)
        one = torch.ones((), dtype=acc, device=v.device)
        cv = torch.where(nv != 0, 1.0 - dot / (2.0 * nv + eps), one)
        cu = torch.where(nu != 0, 1.0 - dot / (2.0 * nu + eps), one)
        v = cv.float() * v + cu.float() * u
    return v.to(x.dtype)


def adasum_hierarchical_ingraph(x: torch.Tensor, local_axis: str,
                                cross_axis: str, n_cross: int
                                ) -> torch.Tensor:
    """Hierarchical Adasum: mean over the host-local axis, Adasum across
    hosts (the reference's AdasumGpuAllreduceOp)."""
    from ..parallel.collectives import allreduce_mean
    return adasum_reduce_ingraph(allreduce_mean(x, local_axis), cross_axis,
                                 n_cross)
