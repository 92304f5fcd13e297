"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu.

Usage mirrors Horovod (``import horovod_tpu_torch.torch as hvd``):
``hvd.init()``, ``hvd.broadcast_parameters(...)``,
``hvd.DistributedOptimizer(...)``, eager collectives with async handles.
Module paths mirror :mod:`horovod_tpu` (``common/``, ``ops/``,
``torch/``, ``models/``); the port imports torch and never JAX nor any
module of ``horovod_tpu``.  Its kernels are hand-written CUDA for Hopper
(``kernels/``), built at first use.

This slice runs a world of one process; the multi-rank data plane is the
port's slice 2 (see ROADMAP.md).
"""

from .version import __version__

from .common.basics import (Adasum, Average, Max, Min, Product, Sum,
                            ProcessSet, add_process_set,
                            cross_rank, cross_size, global_process_set,
                            gloo_built, gloo_enabled, init, is_homogeneous,
                            is_initialized, local_chips, local_rank,
                            local_size, metrics_snapshot, mpi_built,
                            mpi_enabled, mpi_threads_supported, nccl_built,
                            num_chips, rank, remove_process_set, shutdown,
                            size, slo_status, start_timeline, status,
                            stop_timeline, cuda_built)

from .common.exceptions import HorovodInternalError

from .ops import (Handle, allgather, allgather_async, allreduce,
                  allreduce_async, alltoall, alltoall_async, barrier,
                  broadcast, broadcast_async, grouped_allreduce,
                  grouped_allreduce_async, join, poll, reducescatter,
                  reducescatter_async, synchronize)

__all__ = [
    "__version__",
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "num_chips", "local_chips",
    "is_homogeneous", "mpi_threads_supported", "mpi_built", "mpi_enabled",
    "gloo_built", "gloo_enabled", "nccl_built", "cuda_built",
    "start_timeline", "stop_timeline", "metrics_snapshot", "status",
    "slo_status",
    "ProcessSet", "global_process_set", "add_process_set",
    "remove_process_set",
    "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "Handle", "allreduce", "allreduce_async", "grouped_allreduce",
    "grouped_allreduce_async", "allgather", "allgather_async",
    "broadcast", "broadcast_async", "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async", "join", "barrier", "poll",
    "synchronize",
    "HorovodInternalError",
]
