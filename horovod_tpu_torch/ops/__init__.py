from .eager import (Handle, allgather, allgather_async, allreduce,
                    allreduce_async, alltoall, alltoall_async, barrier,
                    broadcast, broadcast_async, grouped_allreduce,
                    grouped_allreduce_async, join, poll, reducescatter,
                    reducescatter_async, synchronize)

__all__ = [
    "Handle", "allreduce", "allreduce_async", "grouped_allreduce",
    "grouped_allreduce_async", "allgather", "allgather_async",
    "broadcast", "broadcast_async", "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async", "join", "barrier",
    "poll", "synchronize",
]
