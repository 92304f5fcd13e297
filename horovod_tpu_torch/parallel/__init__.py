"""Sharded execution over a named mesh of ranks: the mesh
(:mod:`.mesh`), partition rules that place parameters as ``DTensor``
(:mod:`.sharding`), collectives over mesh axes inside
:func:`shard_map` (:mod:`.collectives`), and the layers a model calls
on DTensor parameters (:mod:`.layers`).

Sequence-parallel attention (:mod:`.attention`), expert parallelism
(:mod:`.moe`) and pipeline parallelism (:mod:`.pipeline`) run inside
:func:`shard_map` on those collectives.

Counterpart of :mod:`horovod_tpu.parallel`, less its ``_compat``
module: ``pvary`` marks a value as varying over mesh axes for JAX's
replication typing, which PyTorch does not have.
"""

from .mesh import (build_hierarchical_mesh, build_mesh, local_mesh,
                   mesh_axis_size, parse_mesh_axes, replicated, sharded)
from .collectives import (allgather, allreduce_max, allreduce_mean,
                          allreduce_min, allreduce_prod, allreduce_sum,
                          alltoall, axis_index, axis_size, broadcast,
                          hierarchical_allreduce_sum, neighbor_shift,
                          ppermute, reduce_scatter, shard_map)

__all__ = [
    "build_mesh", "build_hierarchical_mesh", "local_mesh", "sharded",
    "replicated", "mesh_axis_size", "parse_mesh_axes", "shard_map",
    "allreduce_sum", "allreduce_mean", "allreduce_min", "allreduce_max",
    "allreduce_prod", "allgather", "reduce_scatter", "broadcast",
    "alltoall", "ppermute", "neighbor_shift", "axis_index", "axis_size",
    "hierarchical_allreduce_sum",
]

from .attention import (reference_attention, ring_attention,
                        ulysses_attention)
__all__ += ["ring_attention", "ulysses_attention", "reference_attention"]
