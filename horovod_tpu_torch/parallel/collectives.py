"""In-graph collective primitives over named mesh axes.

Counterpart of :mod:`horovod_tpu.parallel.collectives`.  The functions
are called inside :func:`shard_map`, which hands each rank its shard of
whole tensors and binds the mesh, so that ``axis_name`` (one mesh axis,
or a tuple of them: one group over the flattened axes, the first one
major) resolves to the group of ranks that share this rank's
coordinates on every other axis.  They are PyTorch collectives on those
groups, autograd-aware where the JAX one has a transpose (sums, gathers,
scatters, all-to-alls and permutations), and they wait for their result.

Two things have no counterpart: JAX's varying-axis typing (``pvary``;
PyTorch tracks no replication, so ``shard_map`` checks none) and a
compiled program (each call runs eagerly).  Without the typing,
``shard_map`` differentiates as JAX's unchecked transpose does (its
``check_vma=False`` rule, where a sum's transpose is a sum): it sums an
input's cotangent over the mesh axes its spec leaves unnamed and divides
an output's by the size of those axes, which gives the gradients
``jax.grad`` of the checked ``shard_map`` gives where the replication
holds.

:class:`count_collectives` counts the bytes of every collective the
process issues, by kind, including those DTensor inserts.
:func:`install_gloo_cuda_route` routes DTensor's all-gather of CUDA
tensors through pinned host memory where gloo carries the mesh's CUDA
tensors: gloo's coalesced all-gather, which the functional all-gather
calls, reads a CUDA pointer as host memory.
"""

import contextvars
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dnn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._python_dispatch import TorchDispatchMode

from .mesh import PartitionSpec

AxisNames = Union[str, Sequence[str]]

_MESH: contextvars.ContextVar = contextvars.ContextVar("hvd_mesh",
                                                       default=None)
# Each mesh keeps its axis groups ({axes: _AxisGroup}) under this
# attribute, so that they live and die with it.
_GROUPS_ATTR = "_hvd_axis_groups"


class _AxisGroup:
    """The ranks of one group of a mesh axis (or axes): ``members`` in
    axis order, ``index`` this rank's position, ``pg`` their group."""

    def __init__(self, pg, members: List[int], index: int):
        self.pg, self.members, self.index = pg, members, index
        self.size = len(members)


def _axes(axis_name: AxisNames) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _group(axis_name: AxisNames, mesh: Optional[DeviceMesh] = None
           ) -> _AxisGroup:
    mesh = mesh if mesh is not None else _MESH.get()
    if mesh is None:
        raise RuntimeError("a mesh collective runs inside shard_map, which "
                           "binds the mesh its axis names refer to")
    axes = _axes(axis_name)
    groups = getattr(mesh, _GROUPS_ATTR, None)
    if groups is None:
        groups = {}
        setattr(mesh, _GROUPS_ATTR, groups)
    g = groups.get(axes)
    if g is not None:
        return g
    names = list(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} is not one of the mesh's {names}")
    coord = mesh.get_coordinate()
    grid = mesh.mesh
    # Fix this rank's coordinate on the other axes, then read the ranks
    # along ``axes`` in their given order (the first one major).
    index = [slice(None) if n in axes else coord[i]
             for i, n in enumerate(names)]
    sub = grid[tuple(index)]
    kept = [n for n in names if n in axes]
    sub = sub.permute(*[kept.index(a) for a in axes]).reshape(-1)
    members = [int(r) for r in sub]
    if members != sorted(members):
        raise ValueError(f"axes {axes} order the ranks {members} against "
                         "their group's rank order; name them in mesh order")
    me = dist.get_rank()
    if len(axes) == 1:
        pg = mesh.get_group(axes[0])
    elif len(members) == dist.get_world_size():
        pg = dist.group.WORLD
    else:
        pg = dist.new_group(members, use_local_synchronization=True)
    g = _AxisGroup(pg, members, members.index(me))
    groups[axes] = g
    return g


def axis_group(axis_name: AxisNames, mesh: Optional[DeviceMesh] = None):
    """The process group of this rank's group along mesh axis (or axes)
    ``axis_name`` of ``mesh`` (by default the mesh :func:`shard_map`
    binds)."""
    return _group(axis_name, mesh).pg


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

class _Cut(torch.autograd.Function):
    """This member's block of a whole tensor along ``dim``; the whole
    tensor is the same on every member, so its gradient is the members'
    block gradients gathered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        step = x.shape[dim] // group.size
        return x.narrow(dim, group.index * step, step).clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(ctx.group.size)]
        dist.all_gather(parts, g, group=ctx.group.pg)
        return torch.cat(parts, dim=ctx.dim), None, None


class _Assemble(torch.autograd.Function):
    """The members' blocks concatenated along ``dim``: a whole tensor
    that every member then holds, so each block's gradient is that
    member's own slice of the whole one's."""

    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.group = dim, group
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(group.size)]
        dist.all_gather(parts, y, group=group.pg)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        step = g.shape[ctx.dim] // ctx.group.size
        return (g.narrow(ctx.dim, ctx.group.index * step, step).contiguous(),
                None, None)


class _SumGrad(torch.autograd.Function):
    """The identity, whose gradient is summed over ``group``: every member
    holds the same value (an input its spec leaves replicated over the
    group's axes), so the value's gradient is every member's
    contribution (the transpose of JAX's implicit ``pvary``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group.pg)
        return g, None


class _ShareGrad(torch.autograd.Function):
    """The identity, whose gradient is divided by ``copies``: an output
    its spec leaves replicated over axes of that many ranks is one value,
    whose cotangent every one of them carries into the backward."""

    @staticmethod
    def forward(ctx, y, copies):
        ctx.copies = copies
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.copies, None


def _unnamed(spec: PartitionSpec, mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh axes, in mesh order, that no entry of ``spec`` names."""
    named = {a for entry in spec if entry is not None for a in _axes(entry)}
    return tuple(n for n in mesh.mesh_dim_names if n not in named)


def _local(x: torch.Tensor, spec: PartitionSpec, mesh: DeviceMesh
           ) -> torch.Tensor:
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        g = _group(entry, mesh)
        if x.shape[d] % g.size:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"over {g.size} ranks of {entry}")
        x = _Cut.apply(x, d, g)
    unnamed = _unnamed(spec, mesh)
    if x.requires_grad and unnamed:
        x = _SumGrad.apply(x, _group(unnamed, mesh))
    return x


def _assemble(y: torch.Tensor, spec: PartitionSpec, mesh: DeviceMesh
              ) -> torch.Tensor:
    unnamed = _unnamed(spec, mesh)
    if y.requires_grad and unnamed:
        names = list(mesh.mesh_dim_names)
        y = _ShareGrad.apply(y, math.prod(mesh.mesh.shape[names.index(a)]
                                          for a in unnamed))
    for d, entry in enumerate(spec):
        if entry is not None:
            y = _Assemble.apply(y, d, _group(entry, mesh))
    return y


def _tree(spec, value, fn):
    if isinstance(spec, PartitionSpec):
        return fn(value, spec)
    if isinstance(spec, (tuple, list)):
        if not isinstance(value, (tuple, list)) or len(value) != len(spec):
            raise ValueError(f"specs {spec} do not match the values' "
                             "structure")
        return type(value)(_tree(s, v, fn) for s, v in zip(spec, value))
    raise TypeError(f"a spec is a PartitionSpec or a tuple of them, got "
                    f"{spec!r}")


def shard_map(fn: Callable, mesh: DeviceMesh, in_specs, out_specs
              ) -> Callable:
    """``fn`` per rank on its shards: each argument is a whole tensor,
    equal on every rank, cut by ``in_specs`` (a PartitionSpec for every
    argument, or one per argument, nested as the arguments are); the
    mesh is bound while ``fn`` runs; each output is put back together
    by ``out_specs`` (gathered over every axis that names a dim, taken
    as this rank's value where none does).  Differentiable as one
    global function: every rank holds the same whole inputs and
    outputs, and a whole input's gradient is whole on every rank, summed
    over the axes its spec leaves unnamed."""
    def run(*args):
        specs = in_specs
        if isinstance(specs, PartitionSpec):
            specs = (specs,) * len(args)
        locals_ = _tree(tuple(specs), args,
                        lambda x, s: _local(x, s, mesh))
        token = _MESH.set(mesh)
        try:
            out = fn(*locals_)
            return _tree(out_specs, out,
                         lambda y, s: _assemble(y, s, mesh))
        finally:
            _MESH.reset(token)
    return run


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def allreduce_sum(x: torch.Tensor, axis_name: AxisNames = "dp"
                  ) -> torch.Tensor:
    """Sum-allreduce over mesh axis(es)."""
    g = _group(axis_name)
    return dnn.all_reduce(x, op=dist.ReduceOp.SUM, group=g.pg)


def allreduce_mean(x: torch.Tensor, axis_name: AxisNames = "dp"
                   ) -> torch.Tensor:
    return allreduce_sum(x, axis_name) / _group(axis_name).size


def _reduce_plain(x: torch.Tensor, op, axis_name) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=_group(axis_name).pg)
    return out


def allreduce_min(x: torch.Tensor, axis_name: AxisNames = "dp"
                  ) -> torch.Tensor:
    return -_reduce_plain(-x, dist.ReduceOp.MAX, axis_name)


def allreduce_max(x: torch.Tensor, axis_name: AxisNames = "dp"
                  ) -> torch.Tensor:
    return _reduce_plain(x, dist.ReduceOp.MAX, axis_name)


def allreduce_prod(x: torch.Tensor, axis_name: AxisNames = "dp"
                   ) -> torch.Tensor:
    # No product allreduce in XLA: gather, then reduce (as the JAX one).
    return torch.prod(allgather(x, axis_name, axis=0, tiled=False), dim=0)


def allgather(x: torch.Tensor, axis_name: AxisNames = "dp",
              axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Gather shards from all members along ``axis``: concatenated
    (``tiled``) or stacked on a new axis ``axis``."""
    g = _group(axis_name)
    parts = dnn.all_gather(x.contiguous(), group=g.pg)
    if tiled:
        return torch.cat(parts, dim=axis)
    return torch.stack(parts, dim=axis)


def reduce_scatter(x: torch.Tensor, axis_name: AxisNames = "dp",
                   axis: int = 0) -> torch.Tensor:
    """Sum, then keep this member's block along ``axis``."""
    g = _group(axis_name)
    if x.shape[axis] % g.size:
        raise ValueError(f"dim {axis} of size {x.shape[axis]} does not "
                         f"split over {g.size} members")
    chunks = [c.contiguous() for c in x.chunk(g.size, dim=axis)]
    out = torch.empty_like(chunks[g.index])
    return dnn.reduce_scatter(out, chunks, group=g.pg)


def broadcast(x: torch.Tensor, root_rank: int = 0,
              axis_name: AxisNames = "dp") -> torch.Tensor:
    """``root_rank``'s value (an index along the axis) on every member:
    a select and a sum, as the JAX one lowers it."""
    keep = axis_index(axis_name) == root_rank
    return allreduce_sum(x if keep else torch.zeros_like(x), axis_name)


def alltoall(x: torch.Tensor, axis_name: AxisNames = "dp",
             split_axis: int = 0, concat_axis: int = 0) -> torch.Tensor:
    """Even all-to-all: block j of ``split_axis`` goes to member j; the
    blocks received are concatenated along ``concat_axis`` in member
    order."""
    g = _group(axis_name)
    if x.shape[split_axis] % g.size:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {g.size} members")
    send = torch.stack(x.chunk(g.size, dim=split_axis)).contiguous()
    recv = dnn.all_to_all_single(torch.empty_like(send), send, group=g.pg)
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


def alltoallv(x: torch.Tensor, send_counts: torch.Tensor,
              axis_name: AxisNames = "dp"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uneven all-to-all, as the JAX one: the counts are exchanged (a
    tiny all-to-all) and the caller lays out and slices the padded
    buffer.  Returns ``(x, received counts)``."""
    g = _group(axis_name)
    counts = send_counts.reshape(g.size).contiguous()
    recv = dnn.all_to_all_single(torch.empty_like(counts), counts,
                                 group=g.pg)
    return x, recv.reshape(g.size)


def ppermute(x: torch.Tensor, perm, axis_name: AxisNames = "dp"
             ) -> torch.Tensor:
    """Point-to-point permutation: for each ``(src, dst)`` pair of axis
    indices, ``dst`` receives ``src``'s value; a member no pair sends to
    gets zeros.  Carried by an uneven all-to-all (gloo's send and recv
    read a CUDA pointer as host memory)."""
    g = _group(axis_name)
    perm = [(int(s), int(d)) for s, d in perm]
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts) or \
            len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"perm {perm} is not a permutation")
    n = x.numel()
    flat = x.reshape(-1).contiguous()
    send = [0] * g.size
    recv = [0] * g.size
    for s, d in perm:
        if s == g.index:
            send[d] = n
        if d == g.index:
            recv[s] = n
    out = torch.empty(sum(recv), dtype=x.dtype, device=x.device)
    got = dnn.all_to_all_single(out, flat[:sum(send)],
                                output_split_sizes=recv,
                                input_split_sizes=send, group=g.pg)
    if not sum(recv):
        # Nothing arrives; the empty result keeps this rank's part of
        # the exchange (and of its backward) in the graph.
        return torch.zeros_like(x) + got.sum()
    return got.reshape(x.shape)


def neighbor_shift(x: torch.Tensor, shift: int = 1,
                   axis_name: AxisNames = "dp") -> torch.Tensor:
    """Cyclic shift by ``shift`` along the axis ring."""
    n = _group(axis_name).size
    return ppermute(x, [(i, (i + shift) % n) for i in range(n)], axis_name)


def axis_index(axis_name: AxisNames = "dp") -> int:
    """This rank's index along the axis (axes flattened, first major)."""
    return _group(axis_name).index


def axis_size(axis_name: AxisNames = "dp") -> int:
    return _group(axis_name).size


def hierarchical_allreduce_sum(x: torch.Tensor, local_axis: str = "local",
                               cross_axis: str = "cross") -> torch.Tensor:
    """Reduce-scatter over ``local``, allreduce over ``cross``, allgather
    over ``local`` (the reference's NCCLHierarchicalAllreduce); the flat
    tensor is padded to a multiple of the local size."""
    orig_shape = x.shape
    flat = x.reshape(-1)
    n_local = axis_size(local_axis)
    pad = (-flat.shape[0]) % n_local
    flat = torch.nn.functional.pad(flat, (0, pad))
    shard = reduce_scatter(flat, local_axis, axis=0)
    shard = allreduce_sum(shard, cross_axis)
    full = allgather(shard, local_axis, axis=0, tiled=True)
    if pad:
        full = full[:-pad]
    return full.reshape(orig_shape)


# ---------------------------------------------------------------------------
# counting, and the host route of gloo's CUDA all-gather
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(u) for u in t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


# op name -> (kind, index of the argument whose bytes this rank sends)
_COUNTED = {
    "_c10d_functional.all_gather_into_tensor": ("all_gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all_gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all_gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce_scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce_scatter", 0),
    "_c10d_functional.all_reduce": ("all_reduce", 0),
    "_c10d_functional.all_reduce_": ("all_reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all_reduce", 0),
    "_c10d_functional.all_to_all_single": ("all_to_all", 0),
    "_c10d_functional.broadcast": ("broadcast", 0),
    "c10d.allreduce_": ("all_reduce", 0),
    "c10d.allgather_": ("all_gather", 1),
    "c10d._allgather_base_": ("all_gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all_gather", 1),
    "c10d.reduce_scatter_": ("reduce_scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce_scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1),
    "c10d.alltoall_base_": ("all_to_all", 1),
    "c10d.alltoall_": ("all_to_all", 1),
    "c10d.broadcast_": ("broadcast", 0),
}
KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
         "broadcast")


class count_collectives(TorchDispatchMode):
    """Within the context, ``bytes[kind]`` and ``calls[kind]`` count the
    collectives this process issues (the functional ones DTensor
    inserts, and ``torch.distributed``'s): the bytes this rank
    contributes (an all-gather's shard, a reduce-scatter's or an
    all-reduce's whole input, an all-to-all's input)."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in KINDS}
        self.calls = {k: 0 for k in KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # Let DTensor lower the op into plain-tensor collectives
            # first, which come back through this mode.
            return NotImplemented
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        hit = _COUNTED.get(name)
        if hit is not None:
            kind, i = hit
            self.bytes[kind] += _nbytes(args[i] if i < len(args) else None)
            self.calls[kind] += 1
        return func(*args, **kwargs)


# Bytes and calls the host route carried, since the process started.
route_bytes = 0
route_calls = 0
_ROUTE_LIB = None


def _cuda_rides_gloo(group=None) -> bool:
    """Whether ``group`` (by default the world) carries CUDA tensors
    over gloo."""
    cfg = dist.get_backend_config(group)
    backends = dict(part.split(":", 1) for part in cfg.split(",")
                    if ":" in part)
    return backends.get("cuda", cfg) == "gloo"


def _staged_all_gather(x: torch.Tensor, group_size: int,
                       group_name: str) -> torch.Tensor:
    """The functional all-gather of one tensor along dim 0.  Where the
    group carries CUDA tensors over gloo, the payload is copied to host
    memory (pinned for a CUDA tensor), gathered by gloo and copied back;
    a group with a CUDA backend of its own (NCCL) gathers it in place."""
    global route_bytes, route_calls
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    shape = (group_size * x.shape[0],) + tuple(x.shape[1:])
    if not _cuda_rides_gloo(group):
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
    host.copy_(x)
    out = torch.empty(shape, dtype=x.dtype, pin_memory=x.is_cuda)
    dist.all_gather_into_tensor(out, host, group=group)
    route_bytes += _nbytes(x)
    route_calls += 1
    return out.to(x.device)


def _staged_all_gather_coalesced(xs, group_size: int, group_name: str):
    return [_staged_all_gather(x, group_size, group_name) for x in xs]


def _register_route(dispatch_key: str):
    global _ROUTE_LIB
    if _ROUTE_LIB is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _staged_all_gather, dispatch_key)
    lib.impl("all_gather_into_tensor_coalesced",
             _staged_all_gather_coalesced, dispatch_key)
    _ROUTE_LIB = lib


def install_gloo_cuda_route() -> bool:
    """Where the world's CUDA tensors ride gloo, route the functional
    all-gather of CUDA tensors (what DTensor's Shard -> Replicate calls)
    through :func:`_staged_all_gather`, which stages through the host
    only on a group that carries CUDA tensors over gloo.  Returns
    whether it is on.  ``hvd.shutdown()`` takes it down."""
    if not (torch.cuda.is_available() and _cuda_rides_gloo()):
        return False
    _register_route("CUDA")
    return True


def remove_gloo_cuda_route():
    """Give the functional all-gather back its own kernels."""
    global _ROUTE_LIB
    if _ROUTE_LIB is not None:
        _ROUTE_LIB._destroy()
        _ROUTE_LIB = None
