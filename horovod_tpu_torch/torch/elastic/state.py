"""TorchState: elastic state handlers for PyTorch objects (reference:
torch/elastic/state.py:27-150 — per-type handlers deep-copy model /
optimizer state dicts and broadcast them on sync).

Counterpart of :mod:`horovod_tpu.torch.elastic.state`, over the port's
own ``broadcast_parameters``, ``broadcast_optimizer_state`` and
``broadcast_object``.  Saved copies stay on the device of what they copy
(a CUDA model's snapshot is a second copy on its card).  ``run``'s reset
also re-arms every live ``DistributedOptimizer``: a step that failed
after some gradient hooks fired leaves handles of the dead world behind.
"""

import copy
from typing import Any, Dict

import torch

from ...common import basics
from ...common.elastic import ObjectState, run_fn


def _reset():
    from ..optimizer import reset_optimizers
    basics.shutdown()
    reset_optimizers()
    basics.init()


def run(func):
    """Elastic retry-loop decorator (reference: torch/elastic/ run)."""
    return run_fn(func, _reset)


def _bcast_object(obj, name="torch_elastic"):
    from .. import broadcast_object
    return broadcast_object(obj, 0, name=name)


class _ModelHandler:
    def __init__(self, model: torch.nn.Module):
        self.value = model
        self._saved = copy.deepcopy(model.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(copy.deepcopy(self._saved))

    def sync(self):
        from .. import broadcast_parameters
        broadcast_parameters(self.value.state_dict(), root_rank=0)
        self._saved = copy.deepcopy(self.value.state_dict())


class _OptimizerHandler:
    def __init__(self, optimizer: torch.optim.Optimizer):
        self.value = optimizer
        self._saved = copy.deepcopy(optimizer.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(copy.deepcopy(self._saved))

    def sync(self):
        from .. import broadcast_optimizer_state
        broadcast_optimizer_state(self.value, root_rank=0)
        self._saved = copy.deepcopy(self.value.state_dict())


class _SamplerHandler:
    def __init__(self, sampler):
        self.value = sampler
        self._saved = sampler.state_dict()

    def save(self):
        self._saved = self.value.state_dict()

    def restore(self):
        self.value.load_state_dict(self._saved)

    def sync(self):
        state = _bcast_object(self.value.state_dict(),
                              name="torch_elastic_sampler")
        self.value.load_state_dict(state)
        self._saved = state


def _get_handler(v):
    from .sampler import ElasticSampler
    if isinstance(v, torch.nn.Module):
        return _ModelHandler(v)
    if isinstance(v, torch.optim.Optimizer):
        return _OptimizerHandler(v)
    if isinstance(v, ElasticSampler):
        return _SamplerHandler(v)
    return None


class TorchState(ObjectState):
    """State for torch training: positional models/optimizers/samplers
    get type-specific handlers; other kwargs ride the object path.

    ``TorchState(model, optimizer, epoch=0, batch=0)`` or
    ``TorchState(model=model, optimizer=opt, sampler=s, epoch=0)``.
    """

    def __init__(self, *args, **kwargs):
        self._handlers: Dict[str, Any] = {}
        rest = {}
        for i, arg in enumerate(args):
            h = _get_handler(arg)
            if h is None:
                raise ValueError(
                    f"positional argument {i} has no elastic handler; "
                    "pass it as a keyword instead")
            self._handlers[f"arg.{i}"] = h
        for k, v in kwargs.items():
            h = _get_handler(v)
            if h is not None:
                self._handlers[k] = h
                setattr(self, k, v)
            else:
                rest[k] = v
        super().__init__(bcast_object=_bcast_object,
                         get_rank=basics.rank, **rest)

    def save(self):
        for h in self._handlers.values():
            h.save()
        super().save()

    def restore(self):
        for h in self._handlers.values():
            h.restore()
        super().restore()

    def sync(self):
        for h in self._handlers.values():
            h.sync()
        super().sync()
