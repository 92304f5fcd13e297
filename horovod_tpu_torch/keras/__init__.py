"""Keras framework binding (reference: horovod/keras/__init__.py — the
``hvd.keras`` surface: DistributedOptimizer, broadcast helpers,
callbacks, elastic).

Counterpart of :mod:`horovod_tpu.keras`, for Keras 3 on its torch
backend (``KERAS_BACKEND=torch``, where Keras keeps variables and
gradients on the card when there is one) and on its TensorFlow backend.
The optimizer wrapper overrides ``BaseOptimizer.apply``, which both
trainers call; under torch it reduces the gradients on their device
through the port's ``grouped_allreduce`` (:mod:`horovod_tpu_torch._keras`).
``set_data_parallel`` keeps its name and raises: Keras 3.13's
``keras.distribution`` has no torch backend.
"""

import contextlib

import keras

from ..common.basics import (Adasum, Average, Max, Min, Product, Sum,
                             ProcessSet, global_process_set, init,
                             is_initialized, local_rank, local_size,
                             cross_rank, cross_size, rank, shutdown,
                             size, mpi_built, mpi_enabled, gloo_built,
                             gloo_enabled, nccl_built)
from ..ops.compression import Compression
from .. import torch as _hvd_torch
from .. import _keras as _impl
from .._keras import broadcast_model, broadcast_variables
from . import callbacks
from . import elastic

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "cross_rank", "cross_size", "is_initialized",
    "mpi_built", "mpi_enabled", "gloo_built", "gloo_enabled",
    "nccl_built",
    "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "Compression", "ProcessSet", "global_process_set",
    "DistributedOptimizer", "broadcast_global_variables",
    "broadcast_variables", "broadcast_model", "allreduce", "allgather",
    "broadcast", "callbacks", "elastic", "load_model",
    "set_data_parallel", "rank_local",
]


@contextlib.contextmanager
def rank_local():
    """Rank-local work (``if hvd.rank() == 0: model.save(...)``).  The
    JAX package's distribution makes variable creation a collective and
    lifts it here; the port installs no distribution, so this is a
    no-op kept for the JAX package's API."""
    yield


def set_data_parallel(seed=None, devices=None):
    """The JAX package's in-graph data-parallel plane.  It has no
    counterpart here: Keras 3.13's ``keras.distribution`` has no torch
    backend, and ``DistributedOptimizer`` reduces the gradients
    itself."""
    raise NotImplementedError(
        "set_data_parallel is not available in horovod_tpu_torch: "
        "Keras 3.13's keras.distribution has no torch backend, and "
        "hvd.DistributedOptimizer reduces the gradients itself (on the "
        "card under KERAS_BACKEND=torch); compile with it and call "
        "model.fit")


def DistributedOptimizer(optimizer, name=None,
                         compression=Compression.none,
                         sparse_as_dense=False,
                         backward_passes_per_step=1,
                         op=Average,
                         gradient_predivide_factor=1.0,
                         average_aggregated_gradients=False,
                         num_groups=None,
                         process_set=global_process_set):
    return _impl.create_distributed_optimizer(
        optimizer, name=name, compression=compression,
        sparse_as_dense=sparse_as_dense,
        backward_passes_per_step=backward_passes_per_step, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        average_aggregated_gradients=average_aggregated_gradients,
        num_groups=num_groups, process_set=process_set)


def broadcast_global_variables(root_rank=0):
    """Keras-3 equivalent of the reference's
    broadcast_global_variables: broadcast every variable tracked by the
    current models via callbacks instead; provided for API parity with
    explicit variables."""
    raise RuntimeError(
        "broadcast_global_variables requires a variable collection; "
        "use broadcast_variables(model.weights, root_rank) or the "
        "BroadcastGlobalVariablesCallback.")


def allreduce(value, name=None, average=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set):
    """Allreduce a Keras value (variable, tensor, numpy array or
    scalar); returns numpy, as the reference's ``K.get_value`` does."""
    out = _hvd_torch.allreduce(_impl._torch_value(value), average=average,
                               op=op, name=name,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor,
                               process_set=process_set)
    return out.cpu().numpy()


def allgather(value, name=None, process_set=global_process_set):
    return _hvd_torch.allgather(_impl._torch_value(value), name=name,
                                process_set=process_set).cpu().numpy()


def broadcast(value, root_rank=0, name=None,
              process_set=global_process_set):
    return _hvd_torch.broadcast(_impl._torch_value(value), root_rank,
                                name=name,
                                process_set=process_set).cpu().numpy()


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a model wrapping its optimizer as a DistributedOptimizer
    (reference: keras/__init__.py load_model)."""
    model = keras.models.load_model(filepath,
                                    custom_objects=custom_objects)
    if model.optimizer is not None:
        model.optimizer = DistributedOptimizer(model.optimizer,
                                               compression=compression)
    return model
