"""Bridge between elastic ``State`` objects and the durable
checkpoint pipeline.

Elastic states already maintain host-side committed snapshots
(``State.save()``); this module makes those snapshots durable without
changing the training loop's shape::

    from horovod_tpu_torch.checkpoint import DurableCheckpointer

    state = JaxState(params=params, opt_state=opt_state, epoch=0)
    ckpt = DurableCheckpointer(state, "/ckpt/run1",
                               rank=hvd.rank, world_size=hvd.size,
                               coordinator=coord, every_n_commits=5)
    ckpt.maybe_restore()          # cold start -> last committed step

    @run
    def train(state):
        while ...:
            ...
            state.commit()        # in-memory elastic commit
            ckpt.commit()         # durable (async) every N commits
    train(state)
    ckpt.finalize()               # drain + final synchronous save

States expose their durable content through
``durable_state_dict()`` / ``load_durable_state_dict()`` (implemented
by ``ObjectState`` and specialized by the jax/keras bindings); items
are flat ``{name: host_value}`` dicts, which is what makes resize
restore trivial — the dict has no world-size shape.

Counterpart of :mod:`horovod_tpu.checkpoint.elastic`, copied; the
port's ``TorchState`` implements the durable protocol
(``torch/elastic/state.py``).
"""

import logging
import os
import threading
import time
from typing import Callable, Optional, Union

from ..common import env as env_mod
from .coordinator import CommitCoordinator
from .manager import CheckpointManager, CheckpointNotFoundError

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

ENV_DIR = "HOROVOD_CHECKPOINT_DIR"
ENV_KEEP = "HOROVOD_CHECKPOINT_KEEP"
ENV_EVERY = "HOROVOD_CHECKPOINT_EVERY"


def _as_fn(v: Union[int, Callable[[], int]]) -> Callable[[], int]:
    return v if callable(v) else (lambda: v)


class DurableCheckpointer:
    """Owns a :class:`CheckpointManager` on behalf of one elastic
    ``State``; survives elastic resizes by rebuilding the manager with
    the new rank/world on the next commit after a world change."""

    def __init__(self, state, directory: str,
                 rank: Union[int, Callable[[], int]] = 0,
                 world_size: Union[int, Callable[[], int]] = 1,
                 coordinator: Optional[CommitCoordinator] = None,
                 coordinator_factory: Optional[
                     Callable[[], Optional[CommitCoordinator]]] = None,
                 keep: Optional[int] = 3,
                 every_n_commits: int = 1,
                 commit_timeout_s: float = 60.0):
        if not hasattr(state, "durable_state_dict"):
            raise TypeError(
                "%s does not implement durable_state_dict(); durable "
                "checkpointing needs an ObjectState-derived elastic "
                "state" % type(state).__name__)
        self.state = state
        self.directory = str(directory)
        self._rank = _as_fn(rank)
        self._world = _as_fn(world_size)
        self._coordinator = coordinator
        self._coordinator_factory = coordinator_factory
        self.keep = keep
        self.every_n_commits = max(int(every_n_commits), 1)
        self.commit_timeout_s = commit_timeout_s
        self._lock = threading.Lock()
        self._manager: Optional[CheckpointManager] = None
        self._manager_shape = None   # (rank, world) it was built for
        self._commit_count = 0
        self._step = 0               # monotonically increasing save id
        self._finalized = False

    # ------------------------------------------------------------------
    def _get_manager(self) -> CheckpointManager:
        shape = (self._rank(), self._world())
        with self._lock:
            if self._manager is not None and \
                    self._manager_shape == shape:
                return self._manager
            if self._manager is not None:
                # Resize: drain the old incarnation's pipeline before
                # re-sharding under the new layout.
                self._manager.close(timeout=self.commit_timeout_s)
            coord = self._coordinator
            if coord is None and self._coordinator_factory is not None:
                coord = self._coordinator_factory()
            self._manager = CheckpointManager(
                self.directory, rank=shape[0], world_size=shape[1],
                coordinator=coord, keep=self.keep,
                commit_timeout_s=self.commit_timeout_s)
            self._manager_shape = shape
            return self._manager

    # ------------------------------------------------------------------
    @staticmethod
    def _advertised_step() -> Optional[int]:
        """The restart point the elastic driver advertised
        (``HOROVOD_CKPT_LATEST``, exported by the worker rendezvous
        from the driver's startup disk scan), or None outside a
        launcher-managed restart."""
        return env_mod.env_int_opt("HOROVOD_CKPT_LATEST")

    def maybe_restore(self) -> Optional[int]:
        """Load the newest valid committed checkpoint into the state
        (its committed in-memory snapshot AND live attributes), or
        None on a cold start.  Call before the training loop — on a
        restart-from-preemption every rank restores the same step, so
        the post-restore ``state.sync()`` broadcast is a no-op in
        content.  When the elastic driver advertised a restart point
        (``HOROVOD_CKPT_LATEST``), the restored step is checked
        against it — a shortfall means this host's view of the
        checkpoint storage is stale (unsynced shared mount, partial
        replication) and is loudly surfaced rather than silently
        resuming too far back."""
        advertised = self._advertised_step()
        mgr = self._get_manager()
        try:
            step, items = mgr.restore_latest()
        except CheckpointNotFoundError:
            if advertised is not None:
                logger.error(
                    "ckpt: driver advertised committed step %d but no "
                    "valid checkpoint is visible under %s — is the "
                    "checkpoint directory on shared storage?",
                    advertised, self.directory)
            else:
                logger.info("ckpt: cold start (no checkpoint under "
                            "%s)", self.directory)
            return None
        self.state.load_durable_state_dict(items)
        self._step = step + 1
        if advertised is not None and step < advertised:
            logger.error(
                "ckpt: restored step %d but the driver advertised %d "
                "— this host's checkpoint storage view is stale; "
                "training resumes further back than the job's newest "
                "commit", step, advertised)
        logger.info("ckpt: restored step %d from %s", step,
                    self.directory)
        return step

    # ------------------------------------------------------------------
    def commit(self, step: Optional[int] = None) -> Optional[int]:
        """Durably (async) snapshot the state's committed content.
        Honors ``every_n_commits`` (calls in between are free); returns
        the checkpoint step id when a save was enqueued."""
        self._commit_count += 1
        if (self._commit_count - 1) % self.every_n_commits:
            return None
        if step is None:
            step = self._step
        self._step = max(self._step, step) + 1
        mgr = self._get_manager()
        mgr.save_async(step, self.state.durable_state_dict())
        return step

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            mgr = self._manager
        return True if mgr is None else mgr.wait(timeout)

    def latest_step(self) -> Optional[int]:
        return self._get_manager().latest_step()

    # ------------------------------------------------------------------
    def finalize(self, timeout: Optional[float] = None,
                 reason: str = "shutdown") -> Optional[int]:
        """Drain the pipeline and write one final synchronous
        checkpoint of the current committed state — the preemption
        path (SIGTERM grace window).  Returns the final step id, or
        None when the final save could not be made durable in time
        (the previous committed step remains the restore point)."""
        if self._finalized:
            return None
        self._finalized = True
        timeout = self.commit_timeout_s if timeout is None else timeout
        deadline = time.monotonic() + timeout
        mgr = self._get_manager()
        mgr.wait(timeout)
        step = self._step
        self._step += 1
        try:
            outcome = mgr.save(
                step, self.state.durable_state_dict(),
                timeout=max(0.5, deadline - time.monotonic()))
        except Exception as e:
            logger.warning("ckpt: final %s save failed: %s", reason, e)
            return None
        logger.info("ckpt: final %s save at step %d (%s)", reason,
                    step, outcome)
        return step

    def close(self):
        with self._lock:
            mgr, self._manager = self._manager, None
        if mgr is not None:
            mgr.close()


def from_env(state, rank=0, world_size=1, coordinator=None,
             coordinator_factory=None,
             directory: Optional[str] = None,
             **overrides) -> Optional[DurableCheckpointer]:
    """Build a checkpointer from the launcher env contract
    (``HOROVOD_CHECKPOINT_DIR`` + optional ``_KEEP`` / ``_EVERY``), or
    None when durable checkpointing is not configured.  ``directory``
    (and any explicit ``overrides``) beat the env values — the single
    parser every binding-level convenience delegates to."""
    directory = directory or env_mod.env_str_opt(ENV_DIR)
    if not directory:
        return None
    # env_int already defaults on unset/empty/garbage; no `or` fallback
    # — an EXPLICIT HOROVOD_CHECKPOINT_KEEP=0 means keep nothing.
    overrides.setdefault("keep", env_mod.env_int(ENV_KEEP, 3))
    overrides.setdefault(
        "every_n_commits", env_mod.env_int(ENV_EVERY, 1))
    return DurableCheckpointer(
        state, directory, rank=rank, world_size=world_size,
        coordinator=coordinator,
        coordinator_factory=coordinator_factory, **overrides)
