"""Device-mesh construction over the world's ranks.

Counterpart of :mod:`horovod_tpu.parallel.mesh`: a named mesh whose axes
lay the ranks out for data, fully-sharded, tensor, sequence and expert
parallelism.  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world process
group that ``hvd.init()`` joined (or that the caller made with
``torch.distributed.init_process_group``); one rank drives one device,
so a mesh coordinate is a rank.  Building a mesh of two or more axes
makes DeviceMesh's per-axis subgroups, collectively on every rank; no
other group is made, and no process group is initialized here.

Axis conventions (as in the JAX package):

- ``dp``  — data parallel (gradient allreduce axis)
- ``fsdp`` — fully-sharded data parallel (parameter/optimizer sharding)
- ``tp``  — tensor/model parallel
- ``sp``  — sequence/context parallel
- ``ep``  — expert parallel
- ``pp``  — pipeline parallel
- ``cross`` / ``local`` — the 2-level hierarchy of hierarchical
  collectives (across hosts / within a host).

Ranks are laid out row-major: the JAX package's TPU-only
``mesh_utils`` ordering has no counterpart.
"""

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..common import env as env_mod

DEFAULT_AXES = ("dp", "fsdp", "tp", "sp", "ep")

# An axis entry of a spec: one mesh axis name, a tuple of them, or None.
AxisEntry = Union[None, str, Tuple[str, ...]]
MeshLike = Union[DeviceMesh, Mapping[str, int]]


def _factor(n: int, shape: Sequence[int]) -> List[int]:
    """Fill in at most one -1 in `shape` so the product equals n."""
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one -1 allowed in mesh shape")
    known = math.prod(s for s in shape if s != -1)
    if -1 in shape:
        if n % known != 0:
            raise ValueError(f"cannot factor {n} devices into shape {shape}")
        shape[shape.index(-1)] = n // known
    elif known != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return shape


def parse_mesh_axes(spec: str) -> Dict[str, int]:
    """Parse a ``HOROVOD_TPU_MESH_AXES`` spec like ``"dp:4,tp:2"``."""
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        axes[name.strip()] = int(size) if size else -1
    return axes


def resolve_device_type(device_type: Optional[str] = None) -> str:
    """``None`` means the card; with no card the caller must ask for
    ``"cpu"``.  Nothing falls back to the CPU."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch builds its mesh on CUDA devices and none "
                "is available; pass device_type='cpu' to build a CPU mesh")
        return "cuda"
    return device_type


def _require_world():
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the world's process group: call hvd.init() in a "
            "launched job (or torch.distributed.init_process_group)")


def _mesh(device_type: str, ranks, names: Tuple[str, ...]) -> DeviceMesh:
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    if device_type == "cuda":
        from .collectives import install_gloo_cuda_route
        install_gloo_cuda_route()
    return mesh


def build_mesh(axis_sizes: Optional[Dict[str, int]] = None,
               ranks: Optional[Sequence[int]] = None, *,
               device_type: Optional[str] = None) -> DeviceMesh:
    """Build a named mesh over ``ranks`` (default: every rank of the
    world, in order), row-major.

    With no ``axis_sizes`` the axes come from ``HOROVOD_TPU_MESH_AXES``,
    else one data-parallel axis over every rank.  ``axis_sizes`` may
    hold one ``-1``, which absorbs the remaining ranks."""
    device_type = resolve_device_type(device_type)
    _require_world()
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if not axis_sizes:
        spec = env_mod.env_str_opt(env_mod.HOROVOD_TPU_MESH_AXES)
        axis_sizes = parse_mesh_axes(spec) if spec else {"dp": n}
    names = tuple(axis_sizes.keys())
    shape = _factor(n, list(axis_sizes.values()))
    return _mesh(device_type, torch.tensor(ranks).reshape(shape), names)


def build_hierarchical_mesh(ranks: Optional[Sequence[int]] = None, *,
                            device_type: Optional[str] = None
                            ) -> DeviceMesh:
    """2-level ``("cross", "local")`` mesh: ``local`` groups the ranks
    of one host, ``cross`` spans hosts (the reference's cross_comm x
    local_comm).  Hosts come from the launcher's rank contract
    (``HOROVOD_CROSS_RANK`` of each rank, gathered from every rank);
    hosts with unequal rank counts give the flat ``(1, -1)`` mesh."""
    device_type = resolve_device_type(device_type)
    _require_world()
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    mine = env_mod.RankInfo.from_env().cross_rank
    hosts: List[int] = [0] * dist.get_world_size()
    dist.all_gather_object(hosts, mine)
    by_host: Dict[int, List[int]] = {}
    for r in ranks:
        by_host.setdefault(hosts[r], []).append(r)
    counts = {len(v) for v in by_host.values()}
    if len(counts) != 1:
        # Unequal rank counts per host: degrade to a flat mesh.
        grid = torch.tensor(ranks).reshape(1, -1)
    else:
        grid = torch.tensor([by_host[h] for h in sorted(by_host)])
    return _mesh(device_type, grid, ("cross", "local"))


def local_mesh(axis_name: str = "dp", *,
               device_type: Optional[str] = None) -> DeviceMesh:
    """1-D mesh over this process's own device.  A JAX process may own
    several chips; a rank of the port drives one device, so this mesh
    has one member, over a one-rank group made by this rank alone."""
    device_type = resolve_device_type(device_type)
    _require_world()
    me = dist.get_rank()
    if dist.get_world_size() == 1:
        group = dist.group.WORLD
    else:
        group = dist.new_group([me], use_local_synchronization=True)
    return DeviceMesh.from_group(group, device_type, mesh=[me],
                                 mesh_dim_names=(axis_name,))


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, or the mapping itself (a
    mapping stands in for a mesh where only its shape matters)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def mesh_axis_size(mesh: MeshLike, axis: str) -> int:
    return mesh_shape(mesh)[axis]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor, as ``jax.sharding.
    PartitionSpec``: each entry is an axis name, a tuple of axis names
    (major first) or None."""

    def __new__(cls, *entries: AxisEntry):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def spec_placements(spec: Sequence[AxisEntry], mesh: MeshLike,
                    ndim: int) -> Tuple[Placement, ...]:
    """The DTensor placements of ``spec`` on a tensor of ``ndim`` dims:
    one per mesh axis, ``Shard(d)`` where dim ``d`` names the axis (of
    more than one rank), else ``Replicate()``.  A dim sharded by several
    axes nests them in the mesh's axis order, which must be the entry's
    order."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    placements: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if d >= ndim:
            raise ValueError(f"spec {tuple(spec)} has more entries than "
                             f"the tensor's {ndim} dims")
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(
                f"dim {d} is sharded by {axes}, which the mesh {names} "
                "orders otherwise; DTensor nests shards in mesh order")
        for i in where:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims")
            # A shard over one rank is the whole tensor.
            if sizes[names[i]] > 1:
                placements[i] = Shard(d)
    return tuple(placements)


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: how a tensor lies on the
    mesh (``jax.sharding.NamedSharding``).  ``placements(ndim)`` gives
    the DTensor placements and ``distribute(t)`` places a whole tensor,
    equal on every rank, by taking this rank's shard of it."""

    def __init__(self, mesh: MeshLike, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def placements(self, ndim: int) -> Tuple[Placement, ...]:
        return spec_placements(self.spec, self.mesh, ndim)

    def distribute(self, t: torch.Tensor) -> DTensor:
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements(t.dim()))
        t = t.to(self.mesh.device_type)
        return distribute_tensor(t, self.mesh, self.placements(t.dim()),
                                 src_data_rank=None)

    def __repr__(self):
        return f"NamedSharding({mesh_shape(self.mesh)}, {self.spec!r})"


def replicated(mesh: MeshLike) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded(mesh: MeshLike, *spec: AxisEntry) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
