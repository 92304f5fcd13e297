"""Shared Keras callback implementations (reference:
horovod/_keras/callbacks.py, re-exported by keras/callbacks.py:22-160).

Counterpart of :mod:`horovod_tpu._keras.callbacks`, on the port's ops:
the broadcast moves each variable's tensor on its device, and the metric
average reduces a float64 CPU tensor per metric.
"""

import numpy as np
import torch

import keras

from ..common import basics
from ..common.basics import Average
from .. import torch as _hvd_torch
from . import broadcast_model, broadcast_variables


class BroadcastGlobalVariablesCallbackImpl:
    def __init__(self, backend, root_rank, device="", *args):
        super().__init__(*args)
        self.backend = backend
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        broadcast_model(self.model, self.root_rank)
        if hasattr(self.model, "optimizer") and \
                self.model.optimizer is not None:
            opt_vars = getattr(self.model.optimizer, "variables", None)
            if callable(opt_vars):
                opt_vars = opt_vars()
            if opt_vars:
                broadcast_variables(opt_vars, self.root_rank)
        self.broadcast_done = True


class MetricAverageCallbackImpl:
    def __init__(self, backend, *args):
        super().__init__(*args)
        self.backend = backend

    def _average_metrics_in_place(self, logs):
        logs = logs or {}
        for metric, value in list(logs.items()):
            if isinstance(value, (int, float, np.floating, np.integer)):
                logs[metric] = float(_hvd_torch.allreduce(
                    torch.tensor(float(value), dtype=torch.float64),
                    op=Average, name=f"metric.{metric}"))

    def on_epoch_end(self, epoch, logs=None):
        self._average_metrics_in_place(logs)


class LearningRateScheduleCallbackImpl:
    """Multiply the lr by ``multiplier`` over [start_epoch, end_epoch)
    (reference: keras/callbacks.py LearningRateScheduleCallback)."""

    def __init__(self, backend, initial_lr, multiplier, start_epoch=0,
                 end_epoch=None, staircase=True, momentum_correction=True,
                 steps_per_epoch=None, *args):
        super().__init__(*args)
        self.backend = backend
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = None
        if initial_lr is None:
            raise ValueError("initial_lr is required")
        if callable(multiplier):
            self.staircase = False
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def _in_range(self, epoch):
        return self.start_epoch <= epoch and \
            (self.end_epoch is None or epoch < self.end_epoch)

    def _set_lr(self, lr):
        self.model.optimizer.learning_rate = lr

    def _get_lr(self):
        return float(keras.ops.convert_to_numpy(
            self.model.optimizer.learning_rate))

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_range(epoch):
            self._set_lr(self.initial_lr * self.multiplier(epoch))

    def on_batch_begin(self, batch, logs=None):
        if self.staircase or not self._in_range(self.current_epoch):
            return
        if self.steps_per_epoch is None:
            raise ValueError(
                "steps_per_epoch is required for non-staircase "
                "schedules")
        epoch = self.current_epoch + float(batch) / self.steps_per_epoch
        self._set_lr(self.initial_lr * self.multiplier(epoch))

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = self._get_lr()


class LearningRateWarmupCallbackImpl(LearningRateScheduleCallbackImpl):
    """Gradual lr warmup from lr/size to lr over warmup_epochs
    (reference: keras/callbacks.py LearningRateWarmupCallback; the
    Goyal et al. linear-scaling warmup)."""

    def __init__(self, backend, initial_lr, warmup_epochs=5,
                 momentum_correction=True, steps_per_epoch=None,
                 verbose=0, *args):
        def multiplier(epoch):
            size = basics.size()
            return 1.0 / size + epoch * (1.0 - 1.0 / size) / warmup_epochs

        super().__init__(backend, initial_lr, multiplier,
                         start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch, *args)
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0 and \
                basics.rank() == 0:
            print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {self._get_lr()}.")


class BestModelCheckpointImpl:
    """ModelCheckpoint that only saves on rank 0, after averaging the
    monitored metric (reference: keras/callbacks.py:151
    BestModelCheckpoint)."""

    def __init__(self, *args, **kwargs):
        if kwargs.get("save_best_only") is False:
            raise ValueError(
                "BestModelCheckpoint requires save_best_only=True")
        kwargs["save_best_only"] = True
        super().__init__(*args, **kwargs)

    def on_epoch_end(self, epoch, logs=None):
        if basics.rank() == 0:
            super().on_epoch_end(epoch, logs)
