"""PyTorch framework binding.

The compatibility surface of the reference's ``horovod.torch``
(reference: torch/mpi_ops.py:85-846 async handle API, torch/optimizer.py
hook-based DistributedOptimizer, torch/functions.py broadcast helpers).

Counterpart of :mod:`horovod_tpu.torch`, without its host staging:
tensors go into the background runtime as they are and results come back
on the device they came in on.  Handles returned by the async API are
:class:`horovod_tpu_torch.ops.Handle` futures; ``synchronize`` maps to
the reference's handle-table WaitForCompletion (torch/mpi_ops.py:
823-846).  Elastic training is ``hvd.elastic``
(:mod:`horovod_tpu_torch.torch.elastic`); ``SyncBatchNorm`` reduces its
moments with the port's allreduce on the tensors' device.
"""

import pickle
from typing import Any, List, Optional

import torch

from ..common import basics
from ..common.basics import (Adasum, Average, Max, Min, Product, Sum,
                             ProcessSet, global_process_set, init,
                             is_homogeneous, is_initialized, local_rank,
                             local_size, cross_rank, cross_size,
                             mpi_built, mpi_enabled, gloo_built,
                             gloo_enabled, nccl_built, rank, shutdown,
                             size, start_timeline, stop_timeline)
from ..common.exceptions import HorovodInternalError
from .. import ops as _ops
from ..ops import Handle, poll
from .compression import Compression

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "cross_rank", "cross_size", "is_initialized", "is_homogeneous",
    "mpi_built", "mpi_enabled", "gloo_built", "gloo_enabled",
    "nccl_built", "start_timeline", "stop_timeline",
    "Average", "Sum", "Adasum", "Min", "Max", "Product", "Compression",
    "ProcessSet", "global_process_set",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_async",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async",
    "synchronize", "poll", "join", "barrier",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object", "allgather_object",
    "SyncBatchNorm", "elastic",
]


def synchronize(handle: Handle):
    """Wait for an async op; failed collectives raise
    HorovodInternalError (reference: torch/mpi_ops.py:823-846)."""
    return handle.wait()


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------
def _allreduce_async(tensor, name, op, prescale_factor,
                     postscale_factor, process_set,
                     compression=Compression.none):
    compressed, ctx = compression.compress(tensor.detach())
    inner = _ops.allreduce_async(
        compressed, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set)
    return _TorchHandle(inner, tensor, ctx, compression)


class _TorchHandle(Handle):
    """Wraps an ops.Handle: decompresses the result, copies it into
    ``inplace_target`` for the in-place variants, and otherwise never
    hands back the caller's own tensor (a world of one returns its
    input unchanged)."""

    def __init__(self, inner: Handle, like: torch.Tensor, ctx,
                 compression, inplace_target: Optional[torch.Tensor] = None):
        self._inner = inner
        self._like = like
        self._ctx = ctx
        self._compression = compression
        self._inplace = inplace_target
        self.name = inner.name

    def done(self) -> bool:
        return self._inner.done()

    def wait(self, timeout: Optional[float] = None):
        result = self._inner.wait(timeout)
        if isinstance(result, tuple):   # alltoall with splits
            out, splits = result
            return self._fresh(out), splits
        t = self._compression.decompress(result, self._ctx)
        if self._inplace is not None:
            if t.data_ptr() != self._inplace.data_ptr():
                self._inplace.copy_(t.reshape(self._inplace.shape))
            return self._inplace
        return self._fresh(t)

    def _fresh(self, t: torch.Tensor) -> torch.Tensor:
        return t.clone() if t.data_ptr() == self._like.data_ptr() else t


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set,
                    compression=Compression.none) -> Handle:
    return _allreduce_async(tensor, name, _resolve(op, average),
                               prescale_factor, postscale_factor,
                               process_set, compression)


def _resolve(op, average):
    if op is not None and average is not None:
        raise ValueError("Cannot specify both 'op' and deprecated "
                         "'average' arguments.")
    if op is None:
        return Average if (average is None or average) else Sum
    return op


def allreduce(tensor, average=None, name=None, compression=Compression.none,
              op=None, prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set) -> torch.Tensor:
    if tensor.requires_grad:
        return _AllreduceFunction.apply(
            tensor, name, _resolve(op, average), prescale_factor,
            postscale_factor, process_set, compression)
    return synchronize(allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        compression=compression))


class _AllreduceFunction(torch.autograd.Function):
    """Differentiable allreduce (reference: torch/mpi_ops.py:163
    HorovodAllreduce autograd.Function)."""

    @staticmethod
    def forward(ctx, tensor, name, op, prescale, postscale, process_set,
                compression):
        ctx.op = op
        ctx.prescale = prescale
        ctx.postscale = postscale
        ctx.process_set = process_set
        ctx.compression = compression
        h = _allreduce_async(tensor, name, op, prescale, postscale,
                                process_set, compression)
        return h.wait()

    @staticmethod
    def backward(ctx, grad_output):
        h = _allreduce_async(grad_output, None, ctx.op, ctx.prescale,
                                ctx.postscale, ctx.process_set,
                                ctx.compression)
        return h.wait(), None, None, None, None, None, None


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=global_process_set) -> Handle:
    """In-place async allreduce: the result is copied back into
    ``tensor`` on synchronize (reference allreduce_async_)."""
    inner = _ops.allreduce_async(
        tensor.detach(), name=name, op=_resolve(op, average),
        prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set)
    return _TorchHandle(inner, tensor, None, Compression.none,
                        inplace_target=tensor)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0,
               process_set=global_process_set) -> torch.Tensor:
    return synchronize(allreduce_async_(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set))


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=global_process_set) -> List[Handle]:
    inners = _ops.grouped_allreduce_async(
        [t.detach() for t in tensors], average=average, name=name, op=op,
        prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set)
    return [_TorchHandle(h, t, None, Compression.none)
            for h, t in zip(inners, tensors)]


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set) -> List[torch.Tensor]:
    return [h.wait() for h in grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set)]


# ---------------------------------------------------------------------------
# allgather / broadcast / alltoall / reducescatter
# ---------------------------------------------------------------------------
def allgather_async(tensor, name=None,
                    process_set=global_process_set) -> Handle:
    inner = _ops.allgather_async(tensor.detach(), name=name,
                                 process_set=process_set)
    return _TorchHandle(inner, tensor, None, Compression.none)


def allgather(tensor, name=None,
              process_set=global_process_set) -> torch.Tensor:
    return synchronize(allgather_async(tensor, name, process_set))


def broadcast_async(tensor, root_rank, name=None,
                    process_set=global_process_set) -> Handle:
    inner = _ops.broadcast_async(tensor.detach(), root_rank, name=name,
                                 process_set=process_set)
    return _TorchHandle(inner, tensor, None, Compression.none)


def broadcast(tensor, root_rank, name=None,
              process_set=global_process_set) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name,
                                       process_set))


def broadcast_async_(tensor, root_rank, name=None,
                     process_set=global_process_set) -> Handle:
    inner = _ops.broadcast_async(tensor.detach(), root_rank, name=name,
                                 process_set=process_set)
    return _TorchHandle(inner, tensor, None, Compression.none,
                        inplace_target=tensor)


def broadcast_(tensor, root_rank, name=None,
               process_set=global_process_set) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set) -> Handle:
    inner = _ops.alltoall_async(tensor.detach(), splits, name=name,
                                process_set=process_set)
    return _TorchHandle(inner, tensor, None, Compression.none)


def alltoall(tensor, splits=None, name=None,
             process_set=global_process_set):
    result = synchronize(alltoall_async(tensor, splits, name,
                                        process_set))
    out, recv_splits = result
    if splits is None:
        return out
    return out, recv_splits


def reducescatter_async(tensor, op=None, name=None,
                        process_set=global_process_set) -> Handle:
    inner = _ops.reducescatter_async(tensor.detach(), name=name, op=op,
                                     process_set=process_set)
    return _TorchHandle(inner, tensor, None, Compression.none)


def reducescatter(tensor, op=None, name=None,
                  process_set=global_process_set) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, op, name, process_set))


def join(device=None) -> int:
    """Block until every rank has joined; returns the last-joined rank
    (reference: torch/mpi_ops.py:846-870)."""
    return _ops.join()


def barrier(process_set=global_process_set):
    return _ops.barrier(process_set)


# ---------------------------------------------------------------------------
# parameter / object broadcast (reference: torch/functions.py:29-262)
# ---------------------------------------------------------------------------
def broadcast_parameters(params, root_rank=0,
                         process_set=global_process_set):
    """In-place broadcast of an iterable of (name, tensor) or a
    state_dict (reference: torch/functions.py:29-67)."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    handles = []
    for name, p in items:
        if p is None or not isinstance(p, torch.Tensor):
            continue
        handles.append(broadcast_async_(p, root_rank,
                                        name=f"bparam/{name}",
                                        process_set=process_set))
    for h in handles:
        h.wait()


def broadcast_optimizer_state(optimizer, root_rank=0,
                              process_set=global_process_set):
    """Broadcast an optimizer's state_dict from root (reference:
    torch/functions.py:69-184).  The root's tensors travel as CPU
    tensors, and ``load_state_dict`` puts them on each rank's own
    parameters' device (a pickled CUDA tensor would come back on the
    root's card index)."""
    state_dict = _to_cpu(optimizer.state_dict()) \
        if basics.rank() == root_rank else None
    # Non-root ranks may have empty state (created lazily at first
    # step): materialize it from the root's pickled structure.
    full = broadcast_object(state_dict, root_rank,
                            name="opt_state_dict",
                            process_set=process_set)
    if basics.rank() != root_rank:
        optimizer.load_state_dict(full)


def _to_cpu(obj):
    """``obj`` with every tensor in its dicts, lists and tuples on the
    CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_object(obj=None, root_rank=0, name="broadcast_object",
                     process_set=global_process_set):
    """Broadcast an arbitrary picklable object (reference:
    torch/functions.py:186-228 — pickle → uint8 tensor → broadcast the
    size, then the payload)."""
    if basics.rank() == root_rank:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8)
        length = torch.tensor([payload.numel()], dtype=torch.int64)
    else:
        length = torch.zeros(1, dtype=torch.int64)
    length = broadcast(length, root_rank, name=f"{name}.len",
                       process_set=process_set)
    if basics.rank() != root_rank:
        payload = torch.zeros(int(length[0]), dtype=torch.uint8)
    payload = broadcast(payload, root_rank, name=f"{name}.data",
                        process_set=process_set)
    return pickle.loads(payload.numpy().tobytes())


def allgather_object(obj, name="allgather_object",
                     process_set=global_process_set):
    """Gather arbitrary picklable objects from all ranks (reference:
    torch/functions.py:230-262)."""
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8)
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64),
                      name=f"{name}.len", process_set=process_set)
    gathered = allgather(payload, name=f"{name}.data",
                         process_set=process_set).numpy()
    out, off = [], 0
    for s in sizes.reshape(-1).tolist():
        out.append(pickle.loads(gathered[off:off + s].tobytes()))
        off += s
    return out


from .optimizer import (DistributedOptimizer,              # noqa: E402
                        _DistributedOptimizer,
                        _DistributedAdasumOptimizer)
from .sync_batch_norm import SyncBatchNorm                 # noqa: E402
from . import elastic                                      # noqa: E402
