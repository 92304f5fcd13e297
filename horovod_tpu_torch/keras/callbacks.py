"""Keras callbacks (reference: horovod/keras/callbacks.py:22-160 —
thin subclasses binding the shared impls to keras.callbacks.Callback).

Counterpart of :mod:`horovod_tpu.keras.callbacks`, on the port's
:mod:`horovod_tpu_torch._keras.callbacks`.
"""

import keras

from .._keras import callbacks as _impl


class BroadcastGlobalVariablesCallback(
        _impl.BroadcastGlobalVariablesCallbackImpl,
        keras.callbacks.Callback):
    """Broadcast model + optimizer state from root_rank after the first
    batch (when all variables exist)."""

    def __init__(self, root_rank=0, device=""):
        super().__init__(keras.backend, root_rank, device)


class MetricAverageCallback(_impl.MetricAverageCallbackImpl,
                            keras.callbacks.Callback):
    """Average epoch metrics over all ranks before logging."""

    def __init__(self):
        super().__init__(keras.backend)


class LearningRateScheduleCallback(_impl.LearningRateScheduleCallbackImpl,
                                   keras.callbacks.Callback):
    def __init__(self, initial_lr, multiplier, start_epoch=0,
                 end_epoch=None, staircase=True,
                 momentum_correction=True, steps_per_epoch=None):
        super().__init__(keras.backend, initial_lr, multiplier,
                         start_epoch, end_epoch, staircase,
                         momentum_correction, steps_per_epoch)


class LearningRateWarmupCallback(_impl.LearningRateWarmupCallbackImpl,
                                 keras.callbacks.Callback):
    def __init__(self, initial_lr, warmup_epochs=5,
                 momentum_correction=True, steps_per_epoch=None,
                 verbose=0):
        super().__init__(keras.backend, initial_lr, warmup_epochs,
                         momentum_correction, steps_per_epoch, verbose)


class BestModelCheckpoint(_impl.BestModelCheckpointImpl,
                          keras.callbacks.ModelCheckpoint):
    def __init__(self, filepath, monitor="val_loss", verbose=0,
                 save_best_only=True, save_weights_only=False,
                 mode="auto", **kwargs):
        super().__init__(filepath=filepath, monitor=monitor,
                         verbose=verbose, save_best_only=save_best_only,
                         save_weights_only=save_weights_only, mode=mode,
                         **kwargs)
