"""Elastic state for Keras models (reference: keras/elastic.py —
``KerasState``: model weights + optimizer state + python attributes).

Counterpart of :mod:`horovod_tpu.keras.elastic`, on the port's
``common/elastic.py``.  Snapshots are numpy copies (what a durable
checkpoint holds); ``sync`` broadcasts each variable's tensor on its
device from rank 0.  A reset re-forms the world and, where the TF
binding's graph collectives are loaded, their cluster: under the torch
backend there is no ``keras.distribution`` mesh to rebuild.
"""

import sys

import numpy as np

from ..common import basics
from ..common.elastic import ObjectState, run_fn
from .._keras import _broadcast_assign


def _reset():
    basics.shutdown()
    basics.init()
    # If the TF graph-collective layer is in play with elastic-graph
    # mode, re-form its cluster at the new world size (guarded on the
    # module being loaded: Keras may run on the torch backend).
    g = sys.modules.get("horovod_tpu_torch.tensorflow.graph_ops")
    if g is not None and g._ctx.elastic_graph:
        g.reset_graph_collectives()


def run(func):
    """Elastic retry-loop decorator for ``func(state, ...)``."""
    return run_fn(func, _reset)


def _broadcast_object(obj, root_rank=0, name="keras_elastic"):
    from ..torch import broadcast_object
    return broadcast_object(obj, root_rank, name=name)


class KerasState(ObjectState):
    """Snapshot/restore/sync for a Keras model + optimizer.

    ``model`` weights and optimizer variables are captured by value on
    ``save()`` and broadcast from rank 0 on ``sync()``; extra kwargs
    ride the pickled-object path (epoch, batch, ...).
    """

    def __init__(self, model, optimizer=None, **kwargs):
        self.model = model
        self.optimizer = optimizer or getattr(model, "optimizer", None)
        self._saved_model_weights = None
        self._saved_opt_weights = None
        super().__init__(bcast_object=_broadcast_object,
                         get_rank=basics.rank, **kwargs)
        self.save()

    def _opt_vars(self):
        if self.optimizer is None:
            return []
        v = getattr(self.optimizer, "variables", [])
        return v() if callable(v) else v

    def save(self):
        self._saved_model_weights = [np.array(w) for w in
                                     self.model.get_weights()]
        self._saved_opt_weights = [np.array(v) for v in self._opt_vars()]
        super().save()

    def _seed_from_snapshot(self):
        if self._saved_model_weights is not None:
            self.model.set_weights(self._saved_model_weights)
        opt_vars = self._opt_vars()
        if self._saved_opt_weights and \
                len(opt_vars) == len(self._saved_opt_weights):
            for var, w in zip(opt_vars, self._saved_opt_weights):
                var.assign(w)

    def restore(self):
        self._seed_from_snapshot()
        super().restore()

    def rebuild(self, model, optimizer=None):
        """Re-point the state at a freshly built model/optimizer and
        seed them from the last snapshot — for
        HOROVOD_TF_ELASTIC_GRAPH resets, where the TF context reset
        invalidated the old objects (call from on_reset after
        rebuilding the model)."""
        self.model = model
        self.optimizer = optimizer or getattr(model, "optimizer", None)
        self._seed_from_snapshot()

    def durable_state_dict(self):
        """ObjectState capture plus model/optimizer weight snapshots.
        Weight lists are rebound whole on ``save()``, so references
        are stable for the async checkpoint writer; indices are
        zero-padded so restore order survives lexicographic
        iteration."""
        d = super().durable_state_dict()
        for i, w in enumerate(self._saved_model_weights or []):
            d["keras/model.%06d" % i] = w
        for i, w in enumerate(self._saved_opt_weights or []):
            d["keras/opt.%06d" % i] = w
        return d

    def load_durable_state_dict(self, items):
        super().load_durable_state_dict(items)
        model_w = [items[k] for k in sorted(items)
                   if k.startswith("keras/model.")]
        opt_w = [items[k] for k in sorted(items)
                 if k.startswith("keras/opt.")]
        if model_w:
            self._saved_model_weights = model_w
        if opt_w:
            self._saved_opt_weights = opt_w
        self._seed_from_snapshot()

    def sync(self):
        weights = list(self.model.weights)
        _broadcast_assign(weights, 0, [f"elastic_keras/model.{i}"
                                       for i in range(len(weights))],
                          basics.global_process_set)
        self._saved_model_weights = [np.array(w) for w in
                                     self.model.get_weights()]
        opt_vars = list(self._opt_vars())
        _broadcast_assign(opt_vars, 0, [f"elastic_keras/opt.{i}"
                                        for i in range(len(opt_vars))],
                          basics.global_process_set)
        self._saved_opt_weights = [np.array(v) for v in opt_vars]
        super().sync()
