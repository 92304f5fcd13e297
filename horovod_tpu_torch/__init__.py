"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu.

Usage mirrors Horovod (``import horovod_tpu_torch.torch as hvd``):
``hvd.init()``, ``hvd.broadcast_parameters(...)``,
``hvd.DistributedOptimizer(...)``, eager collectives with async handles.
Module paths mirror :mod:`horovod_tpu` (``common/``, ``ops/``,
``torch/``, ``models/``, ``tune/``, ``checkpoint/``); the port imports
torch and never JAX nor any module of ``horovod_tpu``.  Its kernels are
hand-written CUDA for Hopper (``kernels/``), built at first use.

A world of one process needs no launcher; a larger one is started by
``python -m horovod_tpu_torch.runner.launch -np N -H host:slots ...``
(``runner/``), as ``horovodrun`` starts a Horovod job (see ROADMAP.md
for what is ported).

The root names are those of :mod:`horovod_tpu`.  They load on first
use (a module ``__getattr__``), so that the launcher, which needs only
the standard library, starts without importing torch.
"""

import importlib

from .version import __version__

_BASICS = (
    "Adasum", "Average", "Max", "Min", "Product", "Sum", "ProcessSet",
    "add_process_set", "cluster_metrics_snapshot", "cross_rank",
    "cross_size", "global_process_set", "gloo_built", "gloo_enabled",
    "init", "is_homogeneous", "is_initialized", "local_chips",
    "local_rank", "local_size", "metrics_snapshot", "mpi_built",
    "mpi_enabled", "mpi_threads_supported", "nccl_built", "num_chips",
    "rank", "remove_process_set", "shutdown", "size", "slo_status",
    "start_timeline", "status", "stop_timeline", "cuda_built",
    "rocm_built", "ccl_built", "tune_status", "xla_built", "xla_enabled")
_EXCEPTIONS = ("HorovodInternalError", "HostsUpdatedInterrupt")
_OPS = (
    "Handle", "allgather", "allgather_async", "allreduce",
    "allreduce_async", "alltoall", "alltoall_async", "barrier",
    "broadcast", "broadcast_async", "grouped_allreduce",
    "grouped_allreduce_async", "join", "poll", "reducescatter",
    "reducescatter_async", "synchronize")

# Where each lazy root name lives.
_HOME = {**{n: ".common.basics" for n in _BASICS},
         **{n: ".common.exceptions" for n in _EXCEPTIONS},
         **{n: ".ops" for n in _OPS}}


# Subpackages exported by name, imported on first use.
_SUBPACKAGES = ("parallel", "serve", "sparse")


def __getattr__(name):
    if name in _SUBPACKAGES:
        value = importlib.import_module(f".{name}", __name__)
        globals()[name] = value
        return value
    home = _HOME.get(name)
    if home is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(home, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME) | set(_SUBPACKAGES))


__all__ = [
    "__version__",
    # basics
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "num_chips", "local_chips",
    "is_homogeneous", "mpi_threads_supported", "mpi_built", "mpi_enabled",
    "gloo_built", "gloo_enabled", "nccl_built", "cuda_built", "rocm_built",
    "ccl_built", "xla_built", "xla_enabled",
    "start_timeline", "stop_timeline",
    "metrics_snapshot", "cluster_metrics_snapshot", "tune_status",
    "status", "slo_status",
    "ProcessSet", "global_process_set", "add_process_set",
    "remove_process_set",
    # ops & op constants
    "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "Handle", "allreduce", "allreduce_async", "grouped_allreduce",
    "grouped_allreduce_async", "allgather", "allgather_async",
    "broadcast", "broadcast_async", "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async", "join", "barrier", "poll",
    "synchronize",
    # exceptions
    "HorovodInternalError", "HostsUpdatedInterrupt",
    # subpackages
    "parallel", "serve", "sparse",
]
