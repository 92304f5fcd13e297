"""Sequence/context-parallel attention over mesh axes.

Counterpart of :mod:`horovod_tpu.parallel.attention`, in two forms:

* :func:`ring_attention` — blockwise attention with online (flash-
  style) softmax accumulation while K/V blocks rotate around the mesh
  axis ring by :func:`~.collectives.ppermute` (memory stays
  O(S_local) per block).
* :func:`ulysses_attention` — all-to-all reshuffle from sequence-sharded
  to head-sharded, full attention per head group, all-to-all back.

Both are called inside :func:`~.collectives.shard_map` with the sequence
dimension sharded over ``axis_name``; both match full (unsharded)
softmax attention, including causal masking with global positions.
Scores, softmax and the value products are fp32 whatever the input type
(the JAX functions' ``preferred_element_type=float32``): 16-bit inputs
are upcast before each product.  Every step is differentiable through
the collectives' autograd rules.
"""

import math
from typing import Optional

import torch

from .collectives import alltoall, axis_index, axis_size, ppermute


def _block_scores(q, k, scale):
    # q: [B, Sq, H, D], k: [B, Skv, H, D] -> [B, H, Sq, Skv] in f32
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _pv(p, v):
    # p: [B, H, Sq, Skv] f32, v: [B, Skv, H, D] -> [B, Sq, H, D] in f32
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def _causal_mask(q_pos, k_pos):
    return (q_pos[:, None] >= k_pos[None, :])[None, None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``axis_name``.

    Shapes (per shard): q/k/v ``[B, S_local, H, D]``; returns
    ``[B, S_local, H, D]`` in q's dtype.  K/V rotate around the ring;
    softmax is accumulated online with the running-max trick, so the
    result is exact (not approximate) regardless of ring size.  The
    JAX scan becomes a loop of ``n`` steps; the rotation after the last
    block, whose result the JAX scan drops, is not made.
    """
    n = axis_size(axis_name)
    my_idx = axis_index(axis_name)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    zero = torch.tensor(0.0, device=dev)

    # Running accumulators in f32: m (max), l (denominator), o (weighted
    # values).
    m = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev)

    q_pos = my_idx * Sq + torch.arange(Sq, device=dev)  # global q positions
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_blk, v_blk = k, v
    for step in range(n):
        # Block currently held arrived from rank (my_idx - step) mod n.
        src = (my_idx - step) % n
        s = _block_scores(q, k_blk, scale)          # [B,H,Sq,Skv]
        if causal:
            k_pos = src * Skv + torch.arange(Skv, device=dev)
            s = torch.where(_causal_mask(q_pos, k_pos), s, neg_inf)
        blk_max = s.amax(dim=-1)                    # [B,H,Sq]
        m_new = torch.maximum(m, blk_max)
        # Guard fully-masked blocks (all -inf): exp(-inf - -inf) -> use
        # a finite stand-in; their weights are zero anyway.
        m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
        p = torch.exp(s - m_safe[..., None])        # [B,H,Sq,Skv]
        p = torch.where(torch.isneginf(s), zero, p)
        corr = torch.where(torch.isneginf(m), zero,
                           torch.exp(m - m_safe))   # rescale old acc
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + _pv(p, v_blk)
        m = m_new
        if step < n - 1:
            # Rotate K/V one hop around the ring.
            k_blk = ppermute(k_blk, perm, axis_name)
            v_blk = ppermute(v_blk, perm, axis_name)
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully-masked rows
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp", causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention via the Ulysses all-to-all reshuffle.

    Per-shard shapes ``[B, S_local, H, D]`` with ``H`` divisible by the
    axis size.  Sequence-sharded tensors are all-to-all'd into
    head-sharded full-sequence tensors, attended normally, and
    reshuffled back: two tiled all-to-alls per tensor.
    """
    B, S_local, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    def to_headsharded(x):
        # [B, S_local, H, D] -> [B, S_global, H/n, D]
        return alltoall(x, axis_name, split_axis=2, concat_axis=1)

    def to_seqsharded(x):
        return alltoall(x, axis_name, split_axis=1, concat_axis=2)

    qh, kh, vh = (to_headsharded(t) for t in (q, k, v))
    s = _block_scores(qh, kh, scale)                # [B,h,Sg,Sg]
    if causal:
        pos = torch.arange(qh.shape[1], device=q.device)
        s = s.masked_fill(~_causal_mask(pos, pos), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return to_seqsharded(_pv(p, vh).to(q.dtype))


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Unsharded full attention (test oracle and single-device path)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _block_scores(q, k, scale)
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        mask = _causal_mask(torch.arange(Sq, device=q.device),
                            torch.arange(Sk, device=q.device))
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return _pv(p, v).to(q.dtype)
