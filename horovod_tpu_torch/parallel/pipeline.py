"""Pipeline parallelism over a mesh axis (GPipe-style).

Counterpart of :mod:`horovod_tpu.parallel.pipeline`: each rank on the
``pp`` axis holds ONE stage's parameters; microbatches stream through a
loop of S + M - 1 ticks for S stages and M microbatches, each tick
applying the local stage and :func:`~.collectives.ppermute`-ing the
activations one hop forward.  Differentiable end to end: the
permutation's backward is the reverse permutation, which gives the
backward schedule.

Every rank runs the stage and the permutation on every tick, and every
rank's loss reaches every tick's permutation in its graph, because each
collective (and each collective of its backward) must be entered by
every member of its group, in the same order.

Constraints (standard for SPMD pipelining): every stage maps
activations of one shape to the same shape; stage parameters carry a
leading stage dimension sharded over ``pp``.
"""

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from .collectives import _group, axis_index, axis_size, ppermute


class _BcastFromLast(torch.autograd.Function):
    """Broadcast-from-last-stage as a sum of the masked outputs over the
    axis, with the cotangent rule the JAX package pins: the identity
    (each rank's cotangent stays on that rank; only the last stage's
    reaches the stages, through the pipeline's permutations)."""

    @staticmethod
    def forward(ctx, masked, axis_name):
        out = masked.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM,
                        group=_group(axis_name).pg)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   axis_name: str = "pp", vary_axes=()):
    """Run microbatches through the pipeline; returns outputs
    ``[M, ...]`` replicated to every stage.

    ``stage_fn(params, x) -> y`` is this rank's stage (its slice of
    ``stage_params``); ``x_microbatches`` is ``[M, B_micro, ...]``
    (replicated input; only stage 0 reads it).  ``vary_axes`` is
    accepted for the JAX signature and ignored: it types the JAX scan's
    carry as varying over other mesh axes, and PyTorch has no such
    typing.
    """
    del vary_axes
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    M = x_microbatches.shape[0]
    total = M + n - 1
    fwd_perm = [(i, i + 1) for i in range(n - 1)]

    buf = torch.zeros_like(x_microbatches[0])
    emitted = []
    for t in range(total):
        if idx == 0:
            # Stage 0 ingests microbatch t while it exists.  Its buffer
            # is the zeros of a permutation that sends it nothing;
            # adding them keeps that permutation's backward in this
            # rank's graph.
            x_in = x_microbatches[min(t, M - 1)] + buf
        else:
            x_in = buf
        y = stage_fn(stage_params, x_in)
        # The last stage emits microbatch t-(n-1) at tick t.
        if t >= n - 1:
            emitted.append(y)
        if t < total - 1:
            buf = ppermute(y, fwd_perm, axis_name)
    outputs = torch.stack(emitted)
    # Outputs live on the last stage; every other stage contributes
    # zeros, still in its graph, so that its backward runs through
    # every tick as the last stage's does.
    keep = torch.tensor(idx == n - 1, device=outputs.device)
    outputs = torch.where(keep, outputs, torch.zeros_like(outputs))
    return _BcastFromLast.apply(outputs, axis_name)


def stack_stage_params(init_fn, rngs, n_stages: int):
    """Host helper: initialize ``n_stages`` stages and stack their
    parameter trees (tensors in tuples, lists or dicts) along a leading
    dim (shard it over the pp axis)."""
    trees = [tree_flatten(init_fn(rngs[i])) for i in range(n_stages)]
    stacked = [torch.stack(leaves) for leaves in zip(*(t[0] for t in trees))]
    return tree_unflatten(stacked, trees[0][1])
