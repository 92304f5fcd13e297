"""Shared Keras implementation used by ``horovod_tpu_torch.keras`` and
``horovod_tpu_torch.tensorflow.keras`` (reference:
horovod/_keras/__init__.py — create_distributed_optimizer via dynamic
subclassing, broadcast helpers).

Counterpart of :mod:`horovod_tpu._keras`, built against Keras 3: the
override point is ``BaseOptimizer.apply``, which the torch trainer's
train step and the TF trainer's ``apply_gradients`` both call.  The
plane follows ``keras.backend.backend()``:

* ``"torch"``: the gradients are torch tensors on Keras's device (the
  card when there is one).  :func:`_torch_grads_fn` hands them as they
  are to the port's ``grouped_allreduce``, which on the card packs them
  with the fusion kernel (``kernels/fusion_buffer.cu``); nothing goes
  through numpy.
* ``"tensorflow"``: the port's TF binding
  (:func:`horovod_tpu_torch.tensorflow._make_allreduce_grads_fn`), whose
  data plane is the CPU.
* ``"jax"`` is not served: the port never loads JAX.

Keras is imported inside the functions, so this module imports without
it.
"""

import numpy as np
import torch

from ..common.basics import Average, Sum, global_process_set
from ..ops.compression import Compression

_BACKENDS = ("torch", "tensorflow")


def _backend() -> str:
    """The active Keras backend, one of ``_BACKENDS``; raises
    ``ValueError`` for any other."""
    import keras
    name = keras.backend.backend()
    if name not in _BACKENDS:
        raise ValueError(
            f"horovod_tpu_torch serves the torch and tensorflow Keras "
            f"backends, and KERAS_BACKEND is {name!r}; set "
            f"KERAS_BACKEND=torch (the JAX backend is served by "
            f"horovod_tpu.keras)")
    return name


def _scales(op, gradient_predivide_factor, process_set):
    # Resolved at call time, never frozen at optimizer creation:
    # process_set.size() changes across elastic resets.
    if op == Average:
        return (1.0 / gradient_predivide_factor,
                gradient_predivide_factor / process_set.size(), Sum)
    return 1.0, 1.0, op


def _torch_value(value) -> torch.Tensor:
    """A Keras variable or tensor as a torch tensor: the backend's own
    tensor on its device under the torch backend, a CPU tensor under the
    TensorFlow backend (whose data plane is the CPU)."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    if _backend() == "torch":
        from keras import ops as K
        return K.convert_to_tensor(value).detach()
    return torch.from_numpy(np.array(value))


def _torch_grads_fn(compression, op, gradient_predivide_factor,
                    process_set):
    """Gradient reduction for the Keras-3 torch backend.

    Keras's torch trainer computes the step eagerly and hands ``apply``
    the ``.grad`` of each variable: torch tensors on Keras's device.
    The non-None ones are compressed and reduced as one group by the
    torch binding's ``grouped_allreduce`` with the prescale and
    postscale of ``_scales`` (so ``gradient_predivide_factor`` composes
    as in the reference), and come back on the same device with the
    same dtype.  On the card the group is packed and scaled by the
    fusion kernel; a failed pack raises, there is no plain fallback."""
    from .. import torch as hvd_torch

    def allreduce_grads(grads, variables=None):
        grads = list(grads)
        index = [i for i, g in enumerate(grads) if g is not None]
        if not index:
            return grads
        prescale, postscale, reduce_op = _scales(
            op, gradient_predivide_factor, process_set)
        compressed, ctxs = [], []
        for i in index:
            c, ctx = compression.compress(_torch_value(grads[i]))
            compressed.append(c)
            ctxs.append(ctx)
        reduced = hvd_torch.grouped_allreduce(
            compressed, op=reduce_op, prescale_factor=prescale,
            postscale_factor=postscale, process_set=process_set)
        for i, r, ctx in zip(index, reduced, ctxs):
            grads[i] = compression.decompress(r, ctx)
        return grads

    return allreduce_grads


def create_distributed_optimizer(optimizer, name=None,
                                 compression=Compression.none,
                                 sparse_as_dense=False,
                                 backward_passes_per_step=1, op=Average,
                                 gradient_predivide_factor=1.0,
                                 average_aggregated_gradients=False,
                                 num_groups=None,
                                 process_set=global_process_set,
                                 make_allreduce_grads_fn=None):
    backend = _backend()
    if make_allreduce_grads_fn is None and backend == "tensorflow":
        from ..tensorflow import _make_allreduce_grads_fn
        make_allreduce_grads_fn = _make_allreduce_grads_fn
    if make_allreduce_grads_fn is not None:
        allreduce_grads = make_allreduce_grads_fn(
            name or "DistributedOptimizer", "", "", compression,
            sparse_as_dense, op, gradient_predivide_factor, num_groups,
            process_set)
    else:
        allreduce_grads = _torch_grads_fn(
            compression, op, gradient_predivide_factor, process_set)

    cls = optimizer.__class__

    class _DistributedOptimizer(cls):
        _hvd_distributed = True

        # The hook point is ``apply``: the torch trainer's train step and
        # the TF trainer's ``apply_gradients`` both reach it.
        def apply(self, grads, trainable_variables=None):
            if self._hvd_backward_passes > 1:
                # Accumulation mode: the reduction moves to
                # _backend_update_step, which Keras calls with the
                # averaged accumulated gradients on update steps only
                # (the torch backend evaluates ops.cond eagerly; TF's
                # tf.cond runs the branch only then), so every rank
                # reduces on the same steps in the same order.
                return super().apply(grads, trainable_variables)
            reduced = self._hvd_allreduce_grads(
                list(grads), trainable_variables)
            return super().apply(reduced, trainable_variables)

        def _clip_gradients(self, grads):
            if self._hvd_backward_passes > 1:
                # Deferred to _backend_update_step, so clipnorm and
                # clipvalue apply to the reduced gradient, as with
                # backward_passes_per_step=1.
                return grads
            return super()._clip_gradients(grads)

        def _backend_update_step(self, grads, trainable_variables,
                                 learning_rate):
            if self._hvd_backward_passes > 1:
                n = self._hvd_backward_passes
                if not self._hvd_average_aggregated:
                    # Keras accumulates the MEAN over the N passes; the
                    # reference default is their SUM (then the reducer
                    # averages across ranks).
                    grads = [g * float(n) if g is not None else None
                             for g in grads]
                grads = self._hvd_allreduce_grads(grads,
                                                  trainable_variables)
                grads = super()._clip_gradients(list(grads))
            super()._backend_update_step(grads, trainable_variables,
                                         learning_rate)

    dist_name = name or "Distributed" + cls.__name__
    _DistributedOptimizer.__name__ = dist_name
    config = optimizer.get_config()
    if backward_passes_per_step > 1:
        # Local accumulation rides Keras 3's own machinery (state in
        # optimizer slots).
        if config.get("gradient_accumulation_steps"):
            raise ValueError(
                "Pass either backward_passes_per_step (horovod API) "
                "or gradient_accumulation_steps (keras API), not "
                "both.")
        config["gradient_accumulation_steps"] = backward_passes_per_step
    new_opt = _DistributedOptimizer.from_config(config)
    new_opt._hvd_allreduce_grads = allreduce_grads
    new_opt._hvd_backward_passes = backward_passes_per_step
    new_opt._hvd_average_aggregated = average_aggregated_gradients
    return new_opt


def _broadcast_assign(variables, root_rank, names, process_set):
    """Broadcast each variable's value from ``root_rank`` (all in
    flight at once) and assign the results in place: the torch tensor
    under the torch backend, numpy under TensorFlow."""
    from .. import torch as hvd_torch
    variables = list(variables)
    handles = [hvd_torch.broadcast_async(
        _torch_value(var), root_rank, name=name, process_set=process_set)
        for var, name in zip(variables, names)]
    on_torch = _backend() == "torch"
    for var, h in zip(variables, handles):
        value = h.wait()
        var.assign(value if on_torch else value.cpu().numpy())


def broadcast_variables(variables, root_rank: int,
                        process_set=global_process_set):
    """Broadcast ``variables`` from ``root_rank``.  They are named by
    their place in the list: Keras's automatic names count the layers a
    process has built, so they can differ between ranks."""
    variables = list(variables)
    _broadcast_assign(variables, root_rank,
                      [f"kbcast/{i}" for i in range(len(variables))],
                      process_set)


def broadcast_model(model, root_rank: int,
                    process_set=global_process_set):
    """Broadcast every weight of ``model`` (``model.weights``, the order
    of ``get_weights``) from ``root_rank``."""
    weights = list(model.weights)
    _broadcast_assign(weights, root_rank,
                      [f"kbcast_model/{i}" for i in range(len(weights))],
                      process_set)
