"""Synchronized batch normalization for Keras/TF.

Reference: tensorflow/sync_batch_norm.py:26-60 — batch moments are
computed across ALL ranks by allreducing the stacked
[mean, mean-of-squares] so every worker normalizes with global batch
statistics (essential when per-worker batches are small).

Counterpart of :mod:`horovod_tpu.tensorflow.sync_batch_norm`, copied
whole on the port's TF binding.  Implemented as a Keras layer on the
TensorFlow backend: local moments →
one stacked-moment allreduce (Average, via the binding's graph-aware
op, so tf.function traces get a tf.py_function node) → global mean/var
→ normalize.  Inference uses the moving statistics like plain
BatchNormalization.
"""

import numpy as np
import keras
from keras import ops as K

from ..common import basics
from ..common.basics import Average, global_process_set


class SyncBatchNormalization(keras.layers.BatchNormalization):
    """Drop-in BatchNormalization with cross-rank batch statistics.
    Requires the TensorFlow Keras backend (under torch, use
    horovod_tpu_torch.torch.SyncBatchNorm)."""

    def __init__(self, process_set=global_process_set, **kwargs):
        super().__init__(**kwargs)
        self._process_set = process_set

    def call(self, inputs, training=None, mask=None):
        if self._process_set.size() == 1 or training is None:
            return super().call(inputs, training=training, mask=mask)
        # ``training`` may be a symbolic tensor under tf.function
        # tracing; ``not training`` would then branch on the Python
        # truthiness of the tensor object (always True) instead of its
        # value.  Resolve a static value when possible, else tf.cond.
        if isinstance(training, (bool, int, np.bool_)):
            static_training = bool(training)
        else:
            import tensorflow as tf
            static_training = tf.get_static_value(training)
            if static_training is None:
                return tf.cond(
                    tf.cast(training, tf.bool),
                    lambda: self._sync_call(inputs, mask),
                    lambda: super(SyncBatchNormalization, self).call(
                        inputs, training=False, mask=mask))
            static_training = bool(static_training)
        if not static_training:
            return super().call(inputs, training=False, mask=mask)
        return self._sync_call(inputs, mask)

    def _sync_call(self, inputs, mask=None):
        if keras.backend.backend() != "tensorflow":
            raise RuntimeError(
                "horovod_tpu_torch.tensorflow.SyncBatchNormalization "
                "requires the TensorFlow Keras backend; under torch use "
                "horovod_tpu_torch.torch.SyncBatchNorm.")
        from . import allreduce as tf_allreduce

        x = K.convert_to_tensor(inputs)
        ndim = len(x.shape)
        axis = self.axis if self.axis >= 0 else ndim + self.axis
        reduce_axes = [i for i in range(ndim) if i != axis]

        local_mean = K.mean(x, axis=reduce_axes)
        local_sq_mean = K.mean(K.square(x), axis=reduce_axes)
        # One fused allreduce of the stacked moments (reference
        # stacks mean and mean-of-squares into a single tensor);
        # tf_allreduce handles both eager and tf.function tracing.
        stacked = K.stack([local_mean, local_sq_mean])
        reduced = tf_allreduce(stacked, op=Average,
                               name=f"sync_bn/{self.name}",
                               process_set=self._process_set)
        mean = reduced[0]
        var = reduced[1] - K.square(mean)

        # Update moving statistics exactly like the base layer.
        momentum = K.cast(self.momentum, mean.dtype)
        self.moving_mean.assign(self.moving_mean * momentum +
                                mean * (1.0 - momentum))
        self.moving_variance.assign(self.moving_variance * momentum +
                                    var * (1.0 - momentum))

        shape = [1] * ndim
        shape[axis] = x.shape[axis]
        mean = K.reshape(mean, shape)
        var = K.reshape(var, shape)
        out = (x - mean) / K.sqrt(var + self.epsilon)
        if self.scale:
            out = out * K.reshape(self.gamma, shape)
        if self.center:
            out = out + K.reshape(self.beta, shape)
        return out
