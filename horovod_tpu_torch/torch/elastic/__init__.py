"""Elastic training for PyTorch (reference: torch/elastic/ —
``TorchState`` with model/optimizer handlers and ``ElasticSampler``).

Counterpart of :mod:`horovod_tpu.torch.elastic`.  A script launched by
``python -m horovod_tpu_torch.runner.launch --host-discovery-script ...``
wraps its loop in ``@run`` and commits a ``TorchState`` after each step.
"""

from .sampler import ElasticSampler
from .state import TorchState, run

__all__ = ["TorchState", "ElasticSampler", "run"]
