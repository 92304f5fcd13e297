"""Model-side layers for DTensor parameters.

What a model calls where its tensors may lie on a mesh (the sharded
steps of :mod:`horovod_tpu_torch.training`): attention on each rank's
own batch and head shards, and the vocab-parallel lookup of a
row-sharded embedding table.  On plain tensors each is the plain call.
These hold the placement decisions the JAX package leaves to XLA's
GSPMD; the models import them from here.
"""

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from .collectives import axis_group


def on_local_shards(fn, q, k, v, *extras):
    """``fn(q, k, v, *extras)`` on ``[B, S, heads, head_dim]`` tensors.
    On DTensors (a sharded step) attention runs on each rank's own
    shards: the batch and head dims keep their shards, every other
    placement is gathered, ``fn`` sees local tensors (the flash kernel
    takes no DTensor) and its output goes back onto the mesh with the
    placements its inputs came in with.  Each extra is ``(tensor or
    None, {q dim: its dim})``: it is cut as q is along the dims named;
    a plain extra is a whole tensor, equal on every rank."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, *[e for e, _ in extras])
    mesh = q.device_mesh
    keep = tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in q.placements)
    q, k, v = (t.redistribute(mesh, keep).to_local() for t in (q, k, v))
    local_extras = []
    for e, dims in extras:
        if e is not None:
            placed = tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and
                           p.dim in dims else Replicate() for p in keep)
            e = (e.redistribute(mesh, placed) if isinstance(e, DTensor)
                 else distribute_tensor(e.to(q.device), mesh, placed,
                                        src_data_rank=None)).to_local()
        local_extras.append(e)
    out = fn(q, k, v, *local_extras)
    return DTensor.from_local(out, mesh, keep, run_check=False)


def embed(ids, table):
    """``F.embedding(ids, table)``.  A DTensor table sharded over its
    rows (the vocab-sharded embedding of the rules) is looked up as
    Megatron's vocab-parallel embedding: each rank gathers the ids that
    fall in its rows and zeros the others, and the partial lookups are
    all-reduced over the sharding axes (what XLA inserts for a
    vocab-sharded gather)."""
    if not (isinstance(table, DTensor) and
            any(p.is_shard(0) for p in table.placements)):
        return F.embedding(ids, table)
    mesh = table.device_mesh
    rows_at = tuple(p.is_shard(0) for p in table.placements)
    table = table.redistribute(mesh, [Shard(0) if r else Replicate()
                                      for r in rows_at])
    if not isinstance(ids, DTensor):
        ids = distribute_tensor(ids.to(table.device), mesh,
                                [Replicate()] * mesh.ndim,
                                src_data_rank=None)
    ids = ids.redistribute(mesh, [Replicate() if r else p
                                  for r, p in zip(rows_at, ids.placements)])
    # This rank's rows see only its ids: their gradient is partial over
    # the axes that shard the ids.
    local_ids = ids.to_local()
    local_table = table.to_local(grad_placements=[
        Shard(0) if r else (Partial() if p.is_shard() else Replicate())
        for r, p in zip(rows_at, ids.placements)])
    block = 0
    for i, r in enumerate(rows_at):
        if r:
            block = block * mesh.size(i) + mesh.get_local_rank(i)
    lo = block * local_table.shape[0]
    inside = (local_ids >= lo) & (local_ids < lo + local_table.shape[0])
    out = F.embedding(torch.where(inside, local_ids - lo, 0), local_table)
    out = out * inside[..., None].to(out.dtype)
    axes = tuple(n for n, r in zip(mesh.mesh_dim_names, rows_at) if r)
    out = _SumOverShards.apply(out, axis_group(axes, mesh))
    return DTensor.from_local(
        out, mesh, [Replicate() if r else p
                    for r, p in zip(rows_at, ids.placements)],
        run_check=False)


class _SumOverShards(torch.autograd.Function):
    """All-reduce of the rows' partial lookups, whose sum every rank
    then holds: the gradient of each partial is the whole one's."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None
