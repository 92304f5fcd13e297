"""Elastic state for TensorFlow (reference: tensorflow/elastic.py:31,91
— ``run`` wrapper and ``TensorFlowKerasState``).

Counterpart of :mod:`horovod_tpu.tensorflow.elastic`, on the port's
``common/elastic.py``; objects travel through
:func:`horovod_tpu_torch.torch.broadcast_object`.
"""

import numpy as np

from ..common import basics
from ..common.elastic import ObjectState, run_fn
from .. import torch as _hvd_torch
from ..keras.elastic import KerasState as TensorFlowKerasState  # noqa: F401


def _reset():
    basics.shutdown()
    basics.init()
    from . import graph_ops
    if graph_ops._ctx.elastic_graph:
        # Opt-in (HOROVOD_TF_ELASTIC_GRAPH=1): re-form the collective
        # cluster at the new world size via a full TF context reset.
        # Model/functions must be rebuilt in on_reset; see
        # reset_graph_collectives.
        graph_ops.reset_graph_collectives()


def run(func):
    """Elastic retry-loop decorator (reference: tensorflow/elastic.py
    run).  TF connection-class errors (a peer dying inside an
    in-graph CollectiveReduceV2 surfaces as UnavailableError, not
    HorovodInternalError) are translated so the retry loop can
    restore/reset — the eager path's op wrappers already raise
    HorovodInternalError themselves."""
    def tf_guard(state, *args, **kwargs):
        import tensorflow as tf
        from ..common.exceptions import HorovodInternalError
        try:
            return func(state, *args, **kwargs)
        except (tf.errors.UnavailableError, tf.errors.AbortedError,
                tf.errors.CancelledError,
                tf.errors.DeadlineExceededError) as e:
            # Distributed-failure codes only: Unavailable/Aborted are
            # what a dead peer or an abort_collective_ops produces,
            # Cancelled is what subsequent ops on the aborted executor
            # produce, DeadlineExceeded is the collective timeout.
            # Deterministic local failures (InternalError from a
            # compiler bug, InvalidArgument, ...) must SURFACE, not
            # loop the retry forever.
            raise HorovodInternalError(str(e)) from e
    return run_fn(tf_guard, _reset)


class TensorFlowState(ObjectState):
    """Snapshot/restore/sync for a collection of tf.Variables
    (reference: tensorflow/elastic.py TensorFlowState)."""

    def __init__(self, variables=None, **kwargs):
        self.variables = list(variables or [])
        self._saved = None

        def bcast(obj):
            return _hvd_torch.broadcast_object(obj, 0, name="tf_elastic")

        super().__init__(bcast_object=bcast, get_rank=basics.rank,
                         **kwargs)
        self.save()

    def save(self):
        self._saved = [np.array(v) for v in self.variables]
        super().save()

    def _seed_from_snapshot(self):
        if self._saved is not None:
            for var, w in zip(self.variables, self._saved):
                var.assign(w)

    def restore(self):
        self._seed_from_snapshot()
        super().restore()

    def rebuild(self, variables):
        """Re-point the state at freshly built variables and seed them
        from the last snapshot — for HOROVOD_TF_ELASTIC_GRAPH resets,
        where the TF context reset invalidated the old objects (call
        from on_reset after rebuilding the model)."""
        self.variables = list(variables)
        self._seed_from_snapshot()

    def sync(self):
        from . import _host, _numpy
        for i, var in enumerate(self.variables):
            var.assign(_numpy(_hvd_torch.broadcast(
                _host(np.array(var)), 0, name=f"tf_elastic/var.{i}")))
        self._saved = [np.array(v) for v in self.variables]
        super().sync()
