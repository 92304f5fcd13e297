"""Elastic training for PyTorch (reference: torch/elastic/ —
``TorchState`` with model/optimizer handlers and ``ElasticSampler``).

Counterpart of :mod:`horovod_tpu.torch.elastic`.  A script launched by
``python -m horovod_tpu_torch.runner.launch --host-discovery-script ...``
wraps its loop in ``@run`` and commits a ``TorchState`` after each step;
``durable_checkpointer(state)`` makes those commits durable on disk
(``HOROVOD_CHECKPOINT_DIR``).
"""

from .sampler import ElasticSampler
from .state import TorchState, durable_checkpointer, run

__all__ = ["TorchState", "ElasticSampler", "run", "durable_checkpointer"]
