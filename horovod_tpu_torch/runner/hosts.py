"""Host parsing and slot planning for the launcher.

The reference's host/slot math (reference:
runner/common/util/hosts.py:34-156 — ``SlotInfo``, ``parse_hosts``,
``get_host_assignments``): a *slot* is one launched worker process.  On
a GPU host a slot is one process on one card, as the reference's
per-GPU processes are: the worker takes card ``local_rank % cards``
at init (``common/basics.py``).  A host listed with more slots than it
has cards shares cards between its ranks, and CUDA tensors then cross
ranks over gloo instead of NCCL (``ops/dist_ops.py:cuda_transport``).

Counterpart of :mod:`horovod_tpu.runner.hosts`, copied.

Rank-ordering contract (identical to the reference): ranks are assigned
host-major in the order hosts are listed, so consecutive ranks land on
the same host and hierarchical (intra-host, then cross-host) collectives
see contiguous local groups.  ``cross_rank`` indexes a slot's host among all hosts that
have a slot at the same ``local_rank``.
"""

import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple


class HostInfo:
    """One entry of a ``host:slots`` list."""

    def __init__(self, hostname: str, slots: int):
        self.hostname = hostname
        self.slots = slots

    @staticmethod
    def from_string(host_string: str) -> "HostInfo":
        hostname, slots = host_string.strip().split(":")
        return HostInfo(hostname, int(slots))

    def __repr__(self):
        return f"HostInfo({self.hostname}:{self.slots})"

    def __eq__(self, other):
        return (isinstance(other, HostInfo)
                and self.hostname == other.hostname
                and self.slots == other.slots)


@dataclasses.dataclass
class SlotInfo:
    """Full rank identity of one worker slot."""
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_response_string(self) -> str:
        """Wire format served by the elastic rendezvous handler."""
        return ",".join(str(v) for v in (
            self.rank, self.size, self.local_rank, self.local_size,
            self.cross_rank, self.cross_size))


INVALID_SLOT_INFO = SlotInfo(hostname="", rank=-1, local_rank=-1,
                             cross_rank=-1, size=-1, local_size=-1,
                             cross_size=-1)

_HOST_PATTERN = re.compile(r"^[\w.\-]+:[0-9]+$")


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """``"h1:4,h2:4"`` → ``[HostInfo]``; validates every entry."""
    hosts = []
    for host_string in hosts_string.split(","):
        host_string = host_string.strip()
        if not _HOST_PATTERN.match(host_string):
            raise ValueError(
                "Invalid host input %r: expected format "
                "'worker-0:2,worker-1:2'." % host_string)
        hosts.append(HostInfo.from_string(host_string))
    return hosts


def parse_host_files(filename: str) -> str:
    """Read an MPI-style hostfile (``host slots=N``) into the
    comma-separated ``host:N`` form the CLI takes."""
    hosts = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            hostname = line.split()[0]
            slots = 1
            if "=" in line:
                slots = int(line.split("=")[1])
            hosts.append(f"{hostname}:{slots}")
    return ",".join(hosts)


def parse_hosts_and_slots(hosts: str) -> Tuple[List[str], Dict[str, int]]:
    infos = parse_hosts(hosts)
    return ([h.hostname for h in infos],
            {h.hostname: h.slots for h in infos})


def get_host_assignments(hosts: List[HostInfo], min_np: int,
                         max_np: Optional[int] = None) -> List[SlotInfo]:
    """Assign ranks to host slots, host-major.

    Packs as many consecutive ranks as possible onto each host (locality
    for the intra-host leg of hierarchical collectives), stopping at ``max_np``
    total processes; raises if fewer than ``min_np`` slots exist.
    """
    cross_ranks: Dict[int, Dict[str, int]] = collections.defaultdict(dict)
    host_ranks: List[Tuple[HostInfo, List[int]]] = []
    rank = 0
    for host in hosts:
        ranks = []
        for local_rank in range(host.slots):
            if rank == max_np:
                break
            ranks.append(rank)
            rank += 1
            at_local = cross_ranks[local_rank]
            at_local[host.hostname] = len(at_local)
        host_ranks.append((host, ranks))

    world_size = rank
    if world_size < min_np:
        raise ValueError(
            "Requested more processes (%d) than there are available "
            "slots (%d)" % (min_np, world_size))

    alloc: List[SlotInfo] = []
    for host, ranks in host_ranks:
        local_size = len(ranks)
        for local_rank, rank in enumerate(ranks):
            at_local = cross_ranks[local_rank]
            alloc.append(SlotInfo(
                hostname=host.hostname,
                rank=rank,
                local_rank=local_rank,
                cross_rank=at_local[host.hostname],
                size=world_size,
                local_size=local_size,
                cross_size=len(at_local)))
    return alloc


def slot_env_vars(slot: SlotInfo) -> Dict[str, str]:
    """The launcher → worker rank contract (consumed by
    ``horovod_tpu_torch.common.env.RankInfo.from_env``)."""
    return {
        "HOROVOD_HOSTNAME": slot.hostname,
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
    }
