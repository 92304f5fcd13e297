"""TensorFlow 2 framework binding.

The compatibility surface of the reference's ``horovod.tensorflow``
(reference: tensorflow/__init__.py — allreduce with the IndexedSlices
sparse path :54-155, grouped_allreduce :156, broadcast_variables :263,
_make_allreduce_grads_fn :334-381, DistributedOptimizer :568-689,
DistributedGradientTape :691+; op wrappers tensorflow/mpi_ops.py).

Counterpart of :mod:`horovod_tpu.tensorflow`.  The TF binding's data
plane is the CPU: eager ops (and the ``tf.py_function`` nodes of traced
ones) hand numpy arrays to the host, which become CPU torch tensors
(``torch.from_numpy``), go through the port's eager ops (gloo for CPU
tensors) and come back as numpy.  Ops traced inside ``tf.function``
lower to TensorFlow's own in-graph collectives (:mod:`.graph_ops`) when
the collective cluster is up, and fall back to ``tf.py_function``
otherwise.  The ``*_op`` scalar queries stay execution-time reads, which
is what elastic graph reuse needs (reference tensorflow/mpi_ops.py:
327-391).
"""

import numpy as np
import tensorflow as tf
import torch

from ..common import basics
from ..common.basics import (Adasum, Average, Max, Min, Product, Sum,
                             ProcessSet, global_process_set, init,
                             is_homogeneous, is_initialized, local_rank,
                             local_size, cross_rank, cross_size,
                             mpi_built, mpi_enabled, gloo_built,
                             gloo_enabled, nccl_built, rank, shutdown,
                             size, start_timeline, stop_timeline)
from .. import ops as _ops
from .. import torch as _hvd_torch
from ..ops.compression import Compression
from ..ops.eager import _resolve_op
from . import graph_ops as _graph
from .graph_ops import (enable_graph_collectives,
                        reset_graph_collectives)

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "cross_rank", "cross_size", "is_initialized", "is_homogeneous",
    "mpi_built", "mpi_enabled", "gloo_built", "gloo_enabled",
    "nccl_built", "start_timeline", "stop_timeline",
    "Average", "Sum", "Adasum", "Min", "Max", "Product", "Compression",
    "ProcessSet", "global_process_set",
    "allreduce", "grouped_allreduce", "allgather", "broadcast",
    "alltoall", "reducescatter", "join", "barrier",
    "size_op", "rank_op", "local_size_op", "local_rank_op",
    "process_set_included_op",
    "broadcast_variables", "broadcast_global_variables",
    "broadcast_object", "allgather_object",
    "DistributedOptimizer", "DistributedGradientTape",
    "SyncBatchNormalization", "elastic", "enable_graph_collectives",
    "reset_graph_collectives",
]


_basics_init = init


def init(comm=None, process_sets=None):
    """hvd.init plus best-effort TF graph-collective setup. The enable
    attempt is unconditional on every rank (a unanimous-feasibility
    vote inside decides; see graph_ops) so ranks cannot diverge between
    the compiled and py_function paths."""
    result = _basics_init(comm=comm, process_sets=process_sets)
    if basics.size() > 1:
        enable_graph_collectives()
    return result


def _to_numpy(tensor) -> np.ndarray:
    if isinstance(tensor, np.ndarray):
        return tensor
    return tensor.numpy() if hasattr(tensor, "numpy") \
        else np.asarray(tensor)


def _host(arr) -> torch.Tensor:
    """A CPU torch tensor holding a copy of a numpy array (TF hands out
    read-only buffers; its bfloat16 arrives as ml_dtypes' bfloat16,
    which torch reads through its bits)."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`_host`."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _eager(tensor) -> bool:
    return not isinstance(tensor, tf.Tensor) or \
        tf.executing_eagerly() or hasattr(tensor, "numpy")


def _run_op(fn, inputs, output_dtype):
    """Run ``fn(np_arrays...) -> np_array`` eagerly or as a graph
    py_function node."""
    if all(_eager(t) for t in inputs):
        return tf.convert_to_tensor(fn(*[_to_numpy(t) for t in inputs]))
    return tf.py_function(
        lambda *ts: fn(*[t.numpy() for t in ts]), inputs, output_dtype)


def allreduce(tensor, average=None, device_dense="", device_sparse="",
              compression=Compression.none, op=None,
              prescale_factor=1.0, postscale_factor=1.0, name=None,
              process_set=global_process_set):
    """Allreduce a tf.Tensor or tf.IndexedSlices across ranks.

    IndexedSlices with Average/Sum use the allgather sparse path
    (reference: tensorflow/__init__.py:54-155)."""
    if isinstance(tensor, tf.IndexedSlices):
        if op not in (None, Average, Sum):
            raise NotImplementedError(
                "IndexedSlices allreduce supports Average and Sum only")
        if op is not None and average is not None:
            raise ValueError("Cannot specify both 'op' and deprecated "
                             "'average' arguments.")
        do_average = (op == Average) if op is not None \
            else (average is None or average)
        values = allgather(tensor.values, process_set=process_set)
        indices = allgather(tensor.indices, process_set=process_set)
        if do_average:
            values = tf.cast(values, tensor.values.dtype) / \
                tf.cast(process_set.size(), tensor.values.dtype)
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)

    def _fn(arr):
        return _numpy(_hvd_torch.allreduce(
            _host(arr), average=average, op=op, name=name,
            compression=compression, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set))

    if not _eager(tensor) and compression is Compression.none:
        resolved = _resolve_op(op, average)
        if resolved in _graph._MERGE_FINAL and \
                _graph._ctx.usable(process_set, tensor.dtype):
            return _graph.allreduce_graph(
                tensor, resolved, prescale_factor, postscale_factor,
                process_set)
    return _run_op(_fn, [tensor],
                   tensor.dtype if hasattr(tensor, "dtype") else None)


def grouped_allreduce(tensors, average=None, compression=Compression.none,
                      op=None, prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set):
    if not tensors:
        return tensors

    def _fn(*arrs):
        compressed, ctxs = [], []
        for a in arrs:
            c, ctx = compression.compress(_host(a))
            compressed.append(c)
            ctxs.append(ctx)
        outs = _hvd_torch.grouped_allreduce(
            compressed, average=average, op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)
        return [_numpy(compression.decompress(o, ctx))
                for o, ctx in zip(outs, ctxs)]

    if all(_eager(t) for t in tensors):
        outs = _fn(*[_to_numpy(t) for t in tensors])
        return [tf.convert_to_tensor(o) for o in outs]
    resolved = _resolve_op(op, average)
    if compression is Compression.none and \
            resolved in _graph._MERGE_FINAL and all(
            _graph._ctx.usable(process_set, t.dtype) for t in tensors):
        return _graph.grouped_allreduce_graph(
            list(tensors), resolved, prescale_factor, postscale_factor,
            process_set)
    return list(tf.py_function(
        lambda *ts: _fn(*[t.numpy() for t in ts]), list(tensors),
        [t.dtype for t in tensors]))


def allgather(tensor, name=None, process_set=global_process_set):
    # CollectiveGatherV2 requires equal shapes on every rank; the
    # negotiated path supports ragged first dims. A dynamic first dim
    # at trace time (e.g. the IndexedSlices sparse path, where slice
    # counts are data-dependent) therefore stays on the negotiated path.
    static_dim0 = (getattr(tensor, "shape", None) is not None and
                   tensor.shape.rank and tensor.shape[0] is not None)
    if not _eager(tensor) and static_dim0 and \
            _graph._ctx.usable(process_set, tensor.dtype):
        return _graph.allgather_graph(tensor, process_set)
    return _run_op(
        lambda a: _numpy(_hvd_torch.allgather(_host(a), name=name,
                                              process_set=process_set)),
        [tensor], tensor.dtype if hasattr(tensor, "dtype") else None)


def broadcast(tensor, root_rank, name=None,
              process_set=global_process_set):
    if not _eager(tensor) and _graph._ctx.usable(process_set,
                                                 tensor.dtype):
        return _graph.broadcast_graph(tensor, root_rank, process_set)
    return _run_op(
        lambda a: _numpy(_hvd_torch.broadcast(_host(a), root_rank,
                                              name=name,
                                              process_set=process_set)),
        [tensor], tensor.dtype if hasattr(tensor, "dtype") else None)


def alltoall(tensor, splits=None, name=None,
             process_set=global_process_set):
    if splits is None:
        return _run_op(
            lambda a: _numpy(_hvd_torch.alltoall(
                _host(a), name=name, process_set=process_set)),
            [tensor], tensor.dtype if hasattr(tensor, "dtype") else None)
    out, recv = _hvd_torch.alltoall(
        _host(_to_numpy(tensor)), _to_numpy(splits).tolist(), name=name,
        process_set=process_set)
    return tf.convert_to_tensor(_numpy(out)), \
        tf.convert_to_tensor(np.asarray(recv))


def reducescatter(tensor, op=None, name=None,
                  process_set=global_process_set):
    # CollectiveReduceScatterV2 needs dim 0 divisible by group size;
    # the eager path implements the uneven-split convention, so only
    # lower when divisibility is statically certain.
    dim0 = tensor.shape[0] if tensor.shape.rank else None
    if not _eager(tensor) and op in (None, Sum, Average) and \
            dim0 is not None and \
            dim0 % max(process_set.size(), 1) == 0 and \
            _graph._ctx.usable(process_set, tensor.dtype):
        return _graph.reducescatter_graph(tensor, op or Sum, process_set)
    return _run_op(
        lambda a: _numpy(_hvd_torch.reducescatter(
            _host(a), op=op, name=name, process_set=process_set)),
        [tensor], tensor.dtype if hasattr(tensor, "dtype") else None)


def join():
    return _ops.join()


def barrier(process_set=global_process_set):
    return _ops.barrier(process_set)


# ---------------------------------------------------------------------------
# graph-execution-time scalar ops (reference: tensorflow/mpi_ops.py:327-391
# — values read at execution, not trace, time: required for elastic)
# ---------------------------------------------------------------------------
def size_op(process_set=global_process_set, name=None):
    return tf.py_function(lambda: process_set.size(), [], tf.int32)


def rank_op(name=None):
    return tf.py_function(lambda: basics.rank(), [], tf.int32)


def local_size_op(name=None):
    return tf.py_function(lambda: basics.local_size(), [], tf.int32)


def local_rank_op(name=None):
    return tf.py_function(lambda: basics.local_rank(), [], tf.int32)


def process_set_included_op(process_set=global_process_set, name=None):
    return tf.py_function(
        lambda: int(process_set.included(basics.rank())), [], tf.int32)


# ---------------------------------------------------------------------------
# variable broadcast / object collectives
# ---------------------------------------------------------------------------
def broadcast_variables(variables, root_rank: int,
                        process_set=global_process_set):
    """Assign every variable its root_rank value (reference:
    tensorflow/__init__.py:263-330 broadcast_global_variables).

    Works both eagerly and inside a traced ``tf.function`` (the
    reference's TF2 examples call it from the first traced train step):
    traced calls lower through the graph broadcast path (in-graph
    collectives or the py_function fallback)."""
    variables = list(variables)
    if tf.executing_eagerly():
        for i, var in enumerate(variables):
            name = getattr(var, "name", None) or f"bcast_var.{i}"
            value = _hvd_torch.broadcast(_host(_to_numpy(var)), root_rank,
                                         name=f"bcast/{name}",
                                         process_set=process_set)
            var.assign(_numpy(value))
        return None
    assigns = []
    for i, var in enumerate(variables):
        name = getattr(var, "name", None) or f"bcast_var.{i}"
        value = broadcast(tf.convert_to_tensor(var), root_rank,
                          name=f"bcast/{name}", process_set=process_set)
        assigns.append(var.assign(value))
    return tf.group(*assigns) if assigns else None


def broadcast_global_variables(root_rank: int):
    if tf.compat.v1.executing_eagerly_outside_functions():
        raise RuntimeError(
            "broadcast_global_variables is graph-mode only; use "
            "broadcast_variables(model.variables, root_rank) in TF2.")
    return broadcast_variables(tf.compat.v1.global_variables(), root_rank)


def broadcast_object(obj=None, root_rank=0, name="broadcast_object",
                     process_set=global_process_set):
    return _hvd_torch.broadcast_object(obj, root_rank, name=name,
                                       process_set=process_set)


def allgather_object(obj, name="allgather_object",
                     process_set=global_process_set):
    return _hvd_torch.allgather_object(obj, name=name,
                                       process_set=process_set)


# ---------------------------------------------------------------------------
# gradient reduction (reference: _make_allreduce_grads_fn,
# tensorflow/__init__.py:334-381)
# ---------------------------------------------------------------------------
def _make_allreduce_grads_fn(name, device_dense, device_sparse,
                             compression, sparse_as_dense, op,
                             gradient_predivide_factor=1.0,
                             groups=None,
                             process_set=global_process_set):
    def _scales():
        # Resolved at call time, not wrap time: size() may change
        # across elastic resets (reference reads size at execution
        # time, tensorflow/mpi_ops.py:327-391).
        if op == Average:
            # Split Average into pre/postscale around Sum so predivide
            # composes exactly (reference tensorflow/__init__.py:337-344).
            return (1.0 / gradient_predivide_factor,
                    gradient_predivide_factor / process_set.size(), Sum)
        return 1.0, 1.0, op

    def allreduce_grads(grads, vars=None):
        prescale, postscale, reduce_op = _scales()
        processed = []
        for grad in grads:
            if grad is not None and sparse_as_dense and \
                    isinstance(grad, tf.IndexedSlices):
                grad = tf.convert_to_tensor(grad)
            processed.append(grad)
        index = [i for i, g in enumerate(processed) if g is not None]
        dense = [processed[i] for i in index]
        if groups is not None and groups > 1:
            reduced = []
            for i in range(0, len(dense), max(1, len(dense) // groups)):
                reduced.extend(grouped_allreduce(
                    dense[i:i + max(1, len(dense) // groups)],
                    compression=compression, op=reduce_op,
                    prescale_factor=prescale, postscale_factor=postscale,
                    process_set=process_set))
        else:
            reduced = grouped_allreduce(
                dense, compression=compression, op=reduce_op,
                prescale_factor=prescale, postscale_factor=postscale,
                process_set=process_set) if dense else []
        out = list(processed)
        for i, g in zip(index, reduced):
            out[i] = g
        return out

    return allreduce_grads


class DistributedGradientTape:
    """GradientTape wrapper whose ``gradient()`` allreduces the result
    (reference: tensorflow/__init__.py:691+).  Pure delegation — NOT a
    tf.GradientTape subclass, so the C-level tape state stays owned by
    the wrapped tape."""

    def __init__(self, gradtape, device_dense="", device_sparse="",
                 compression=Compression.none, sparse_as_dense=False,
                 op=Average, gradient_predivide_factor=1.0,
                 num_groups=None, process_set=global_process_set):
        self._tape = gradtape
        self._allreduce_grads = _make_allreduce_grads_fn(
            "DistributedGradientTape", device_dense, device_sparse,
            compression, sparse_as_dense, op, gradient_predivide_factor,
            num_groups, process_set)

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        return self._tape.__exit__(exc_type, exc, tb)

    def __getattr__(self, item):
        return getattr(self.__dict__["_tape"], item)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        return self._allreduce_grads(grads, sources)


def DistributedOptimizer(optimizer, name=None, device_dense="",
                         device_sparse="", compression=Compression.none,
                         sparse_as_dense=False,
                         backward_passes_per_step=1, op=Average,
                         gradient_predivide_factor=1.0,
                         average_aggregated_gradients=False,
                         num_groups=None,
                         process_set=global_process_set):
    """Wrap a Keras optimizer so apply_gradients() first allreduces the
    gradients (reference: tensorflow/__init__.py:568-689 /
    _keras/__init__.py create_distributed_optimizer)."""
    from .._keras import create_distributed_optimizer
    return create_distributed_optimizer(
        optimizer, name=name, compression=compression,
        sparse_as_dense=sparse_as_dense,
        backward_passes_per_step=backward_passes_per_step, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        average_aggregated_gradients=average_aggregated_gradients,
        num_groups=num_groups, process_set=process_set,
        make_allreduce_grads_fn=_make_allreduce_grads_fn)


from .sync_batch_norm import SyncBatchNormalization  # noqa: E402
from . import elastic  # noqa: E402
