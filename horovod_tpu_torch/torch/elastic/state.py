"""TorchState: elastic state handlers for PyTorch objects (reference:
torch/elastic/state.py:27-150 — per-type handlers deep-copy model /
optimizer state dicts and broadcast them on sync).

Counterpart of :mod:`horovod_tpu.torch.elastic.state`, over the port's
own ``broadcast_parameters``, ``broadcast_optimizer_state`` and
``broadcast_object``.  Saved copies stay on the device of what they copy
(a CUDA model's snapshot is a second copy on its card).  ``run``'s reset
also re-arms every live ``DistributedOptimizer``: a step that failed
after some gradient hooks fired leaves handles of the dead world behind.

Durable checkpoints (:mod:`horovod_tpu_torch.checkpoint`): the
reference's ``TorchState`` has none; the port's implements the protocol
that ``JaxState`` implements in the JAX package
(``horovod_tpu/jax/elastic.py:90-112``).  ``durable_state_dict`` copies
the committed snapshot to host numpy, one item per tensor (so the
round-robin shard partition spreads a model over the ranks), and
``load_durable_state_dict`` loads the items back into the live objects,
on their devices.  numpy has no bfloat16 (nor float8): such a tensor is
refused with a ``TypeError`` rather than stored under another dtype.
``durable_checkpointer`` wires a ``DurableCheckpointer`` from the
launcher's env, as ``horovod_tpu.jax.elastic.durable_checkpointer``
does.
"""

import copy
from typing import Any, Dict

import numpy as np
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


def _to_host(value, name: str, copying: set):
    """``value`` with every tensor in it as a host numpy array.  A CPU
    tensor's array shares the snapshot's memory, which ``save`` rebinds
    and never mutates.  A CUDA tensor is copied into pinned host memory
    without a wait, and its device joins ``copying``: synchronize those
    devices before the arrays are read."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.is_cuda:
            copying.add(value.device)
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            value = host.copy_(value, non_blocking=True)
        try:
            return value.numpy()
        except TypeError as e:
            raise TypeError(
                f"durable checkpoint item {name!r} is a {value.dtype} "
                "tensor, which numpy cannot hold; keep durable state in "
                "a numpy dtype (for example float32)") from e
    if isinstance(value, dict):
        return {k: _to_host(v, name, copying) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v, name, copying) for v in value)
    return value


def _to_torch(value):
    """Inverse of :func:`_to_host`: numpy arrays become CPU tensors."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value if value.flags.writeable
                                else value.copy())
    if isinstance(value, dict):
        return {k: _to_torch(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_torch(v) for v in value)
    return value


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

    def durable_items(self, prefix: str, copying: set) -> Dict[str, Any]:
        return {prefix + k: _to_host(v, prefix + k, copying)
                for k, v in self._saved.items()}

    def load_durable_items(self, items: Dict[str, Any]):
        self.value.load_state_dict(_to_torch(items))
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

    def durable_items(self, prefix: str, copying: set) -> Dict[str, Any]:
        # One item per state tensor: "<prefix>state/<param index>/<key>".
        out = {prefix + "param_groups": _to_host(
            self._saved["param_groups"], prefix + "param_groups", copying)}
        for i, st in self._saved["state"].items():
            for k, v in st.items():
                name = f"{prefix}state/{i}/{k}"
                out[name] = _to_host(v, name, copying)
        return out

    def load_durable_items(self, items: Dict[str, Any]):
        state: Dict[int, Dict[str, Any]] = {}
        for name, v in items.items():
            if name.startswith("state/"):
                i, k = name[len("state/"):].split("/", 1)
                state.setdefault(int(i), {})[k] = _to_torch(v)
        # load_state_dict moves each state tensor to its parameter's
        # device (the step counters stay where torch keeps them).
        self.value.load_state_dict({
            "state": state,
            "param_groups": _to_torch(items["param_groups"])})
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

    def durable_items(self, prefix: str, copying: set) -> Dict[str, Any]:
        return {prefix + "state": self._saved}

    def load_durable_items(self, items: Dict[str, Any]):
        self._saved = items["state"]
        self.value.load_state_dict(self._saved)


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

    def durable_state_dict(self) -> Dict[str, Any]:
        """ObjectState capture plus each handler's committed snapshot,
        as host numpy under ``torch/<handler>/...``."""
        d = super().durable_state_dict()
        copying = set()
        for key, h in self._handlers.items():
            d.update(h.durable_items(f"torch/{key}/", copying))
        for device in copying:
            torch.cuda.synchronize(device)
        return d

    def load_durable_state_dict(self, items: Dict[str, Any]):
        super().load_durable_state_dict(items)
        for key, h in self._handlers.items():
            prefix = f"torch/{key}/"
            mine = {n[len(prefix):]: v for n, v in items.items()
                    if n.startswith(prefix)}
            if mine:
                h.load_durable_items(mine)


def durable_checkpointer(state, directory: str = None, **kwargs):
    """Wire a :class:`horovod_tpu_torch.checkpoint.DurableCheckpointer`
    for ``state`` from the launcher env contract (as
    ``horovod_tpu.jax.elastic.durable_checkpointer``): rank and world
    track the elastic world, and in launcher-managed jobs the two-phase
    commit marks ride the rendezvous KV.  Returns None when no directory
    is given and ``HOROVOD_CHECKPOINT_DIR`` is unset::

        state = TorchState(model, optimizer, epoch=0)
        ckpt = durable_checkpointer(state)      # env-driven
        ckpt and ckpt.maybe_restore()
    """
    from ...checkpoint.elastic import from_env
    from ...common import env as env_mod

    factory = None
    if env_mod.env_str_opt(env_mod.HOROVOD_RENDEZVOUS_ADDR):
        from ...runner.elastic.worker import kv_commit_coordinator
        factory = kv_commit_coordinator

    def _rank():
        return basics.rank() if basics.is_initialized() else 0

    def _size():
        return basics.size() if basics.is_initialized() else 1

    return from_env(state, rank=_rank, world_size=_size,
                    coordinator_factory=factory, directory=directory,
                    **kwargs)
