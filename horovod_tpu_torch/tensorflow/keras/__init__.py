"""``horovod_tpu_torch.tensorflow.keras`` — alias of the Keras binding
bound to ``tf.keras`` (reference: horovod/tensorflow/keras/__init__.py).
With TF ≥ 2.16 ``tf.keras`` *is* Keras 3, so the shared implementation
is identical.  Counterpart of :mod:`horovod_tpu.tensorflow.keras`.
"""

from ...keras import *            # noqa: F401,F403
from ...keras import (DistributedOptimizer, broadcast_variables,
                      broadcast_model, allreduce, allgather, broadcast,
                      load_model, callbacks, elastic)  # noqa: F401
