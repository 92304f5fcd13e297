"""Disk checkpoints of a training-state tree of tensors.

Counterpart of :mod:`horovod_tpu.jax.checkpoint`, with its API and its
semantics: ``save`` (collective when the world has more than one rank,
``keep=3`` retention by default, ``keep=None`` keeps every step,
``block=False`` writes in the background until :func:`wait`),
``latest_step``, ``restore`` into a template, ``close``.  There is no
orbax here: the files are those of the port's own
:class:`~horovod_tpu_torch.checkpoint.CheckpointManager` (per-rank
shards, ``MANIFEST.json``), not orbax's, and neither package reads the
other's files through this API.

Usage::

    import horovod_tpu_torch.torch.checkpoint as ckpt

    ckpt.save(dir, {"model": model.state_dict(), "step": epoch},
              step=epoch)
    step = ckpt.latest_step(dir)           # None -> cold start
    state = ckpt.restore(dir, template=state, step=step)

The state is a tree of dicts, lists and tuples whose leaves are
tensors, numpy arrays or picklable Python values.  Each leaf is one item
of the checkpoint, named by its path; tensors are copied to host numpy
(a bfloat16 tensor is refused, as numpy has no such dtype).  At world
size N each rank writes the items the round-robin partition gives it,
and rank 0 commits the step once every rank's shard landed, through the
launcher's rendezvous KV.  The leaves are replicated values: ``save``
compares a digest of them across ranks and raises ``ValueError`` when
they differ, where keeping one rank's copy would corrupt the resumed
run.  ``restore`` returns each leaf as the template's leaf is: a tensor
of its dtype on its device, a numpy array, or the stored value.
"""

import hashlib
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..common import basics
from .elastic.state import _to_host

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

_managers: Dict[str, CheckpointManager] = {}


def _world():
    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


def _manager(directory) -> CheckpointManager:
    """One manager per directory and world.  ``keep`` is a plain
    attribute of the manager, set by every ``save``: a ``latest_step``
    probe before the first ``save(keep=N)`` cannot pin another bound."""
    key = str(directory)
    rank, size = _world()
    mgr = _managers.get(key)
    if mgr is not None and (mgr.rank, mgr.world_size) == (rank, size):
        return mgr
    if mgr is not None:
        mgr.close()
    coordinator = None
    if size > 1:
        from ..common import env as env_mod
        if not env_mod.env_str_opt(env_mod.HOROVOD_RENDEZVOUS_ADDR):
            raise RuntimeError(
                "a checkpoint of a world of %d ranks commits through the "
                "launcher's rendezvous KV; start the job with "
                "python -m horovod_tpu_torch.runner.launch" % size)
        from ..runner.elastic.worker import kv_commit_coordinator
        coordinator = kv_commit_coordinator()
    mgr = CheckpointManager(key, rank=rank, world_size=size,
                            coordinator=coordinator, keep=None)
    _managers[key] = mgr
    return mgr


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _name(path) -> str:
    return "tree/" + "/".join(path)


def _items(state: Any) -> Dict[str, Any]:
    copying = set()
    items = {_name(p): _to_host(v, _name(p), copying)
             for p, v in _leaves(state)}
    for device in copying:
        torch.cuda.synchronize(device)
    return items


def _check_replicated(items: Dict[str, Any]):
    """Raise when the items differ across ranks (see the module
    docstring); a no-op in a world of one."""
    rank, size = _world()
    if size == 1:
        return
    digest = hashlib.sha256()
    for name, v in sorted(items.items()):
        digest.update(name.encode())
        digest.update(np.ascontiguousarray(v).tobytes()
                      if isinstance(v, np.ndarray) else repr(v).encode())
    from . import allgather_object
    digests = allgather_object(digest.hexdigest(),
                               name="checkpoint.replicated")
    if len(set(digests)) > 1:
        raise ValueError(
            "checkpoint leaves differ across processes (%s); a "
            "replicated save would keep only one rank's value.  Exclude "
            "rank-divergent state from the checkpoint." % sorted(items))


def save(directory: str, state: Any, step: int, *,
         keep: Optional[int] = 3, block: bool = True) -> None:
    """Write ``state`` as checkpoint ``step``.  Collective across ranks:
    a blocking save returns on every rank once the step is committed.
    With ``block=False`` the write completes in the background (call
    :func:`wait` before shutdown).

    PRUNES by default: only the newest ``keep=3`` steps are retained;
    pass ``keep=None`` to keep every step."""
    items = _items(state)
    _check_replicated(items)
    mgr = _manager(directory)
    mgr.keep = keep
    if not block:
        mgr.save_async(int(step), items)
        return
    mgr.save(int(step), items, timeout=mgr.commit_timeout_s)
    if mgr.world_size > 1:
        # Rank 0 returns once it committed, the others once they
        # prepared: the barrier makes the step visible on every rank.
        from . import barrier
        barrier()


def wait(directory: str) -> None:
    """Block until async saves for ``directory`` land."""
    _manager(directory).wait()


def latest_step(directory: str) -> Optional[int]:
    """Newest committed checkpoint step, or None."""
    return _manager(directory).latest_step()


def _like(value, template):
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(value)).to(
            device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(value, dtype=template.dtype)
    return value


def _rebuild(template, items, path=()):
    if isinstance(template, dict):
        return type(template)(
            (k, _rebuild(v, items, path + (str(k),)))
            for k, v in template.items())
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, items, path + (str(i),))
                              for i, v in enumerate(template))
    return _like(items[_name(path)], template)


def restore(directory: str, template: Any,
            step: Optional[int] = None) -> Any:
    """Restore a checkpoint into the structure of ``template`` (see the
    module docstring for the leaves); ``step=None`` restores the newest
    one."""
    mgr = _manager(directory)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {directory}")
    return _rebuild(template, mgr.restore(int(step)))


def close() -> None:
    """Release cached managers (tests / repeated runs in one
    process)."""
    for mgr in _managers.values():
        try:
            mgr.close()
        except Exception:
            pass
    _managers.clear()
