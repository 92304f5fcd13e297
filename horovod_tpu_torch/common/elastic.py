"""Elastic training: the worker-side state machine and retry loop.

The analog of the reference's ``horovod/common/elastic.py`` (reference:
common/elastic.py:26-168 — ``State``/``ObjectState``/``run_fn``): user
training state registers commit/restore/sync hooks; the ``run_fn``
wrapper retries the training function across membership changes,
restoring the last committed state after an internal error and
re-initializing the runtime after every world change.

Counterpart of :mod:`horovod_tpu.common.elastic`, copied.

Delta from the reference: host-update notification is a *pull* at
``state.commit()``/``check_host_updates()`` time — workers poll the
driver's rendezvous KV version key — instead of the reference's
per-worker push RPC service (runner/elastic/worker.py).  Commit already
quiesces training, so the poll adds one small HTTP GET over DCN at
commit cadence and removes a listening socket from every worker.
"""

import io
import logging
import queue
import time
from typing import Callable, Dict, List, Optional

from . import metrics
from .exceptions import HorovodInternalError, HostsUpdatedInterrupt

logger = logging.getLogger("horovod_tpu_torch.elastic")

# Recovery-pipeline phase timings (docs/failure_recovery.md): the
# retry loop below observes restore/reset, the chaos MTTR drill and
# the elastic driver path observe detect/resume — one histogram tells
# the whole detect → restore → resume story.
RECOVERY_SECONDS = metrics.histogram(
    "hvd_recovery_seconds",
    "Failure-recovery pipeline wall time, by phase (detect = fault to "
    "survivor unwind; restore = state restore; reset = runtime "
    "re-init; resume = restore to first post-restore step)")


class HostUpdateSource:
    """Where a worker learns that cluster membership changed.

    The default implementation polls the elastic rendezvous version key
    (filled in by ``horovod_tpu_torch.runner.elastic.worker``); tests inject a
    fake with a local queue.
    """

    def has_update(self) -> bool:
        raise NotImplementedError


class QueueHostUpdateSource(HostUpdateSource):
    """Test/fake source: push updates into a queue."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()

    def put(self):
        self._q.put(1)

    def has_update(self) -> bool:
        got = False
        try:
            while True:
                self._q.get_nowait()
                got = True
        except queue.Empty:
            pass
        return got


_host_update_source: Optional[HostUpdateSource] = None


def set_host_update_source(source: Optional[HostUpdateSource]):
    global _host_update_source
    _host_update_source = source


def get_host_update_source() -> Optional[HostUpdateSource]:
    return _host_update_source


class State:
    """State representing a snapshot of the program for elastic restore.

    Subclasses implement ``save``/``restore``/``sync`` for their
    framework's objects (reference: common/elastic.py:26-109).
    """

    def __init__(self, **kwargs):
        self._host_messages: "queue.Queue" = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks: List[Callable] = []

    def register_reset_callbacks(self, callbacks: List[Callable]):
        """Callbacks invoked after a reset (e.g. rescale the learning
        rate to the new world size)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_messages = queue.Queue()
        self.reset()
        for callback in self._reset_callbacks:
            callback()

    def on_hosts_updated(self):
        self._host_messages.put(1)

    def commit(self):
        """Commit the current state and check for membership changes.

        Raises ``HostsUpdatedInterrupt`` when hosts were added/removed
        so the caller's train loop unwinds to ``run_fn``'s retry loop.
        """
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        updated = False
        # External (driver) notification channel.
        src = get_host_update_source()
        if src is not None and src.has_update():
            updated = True
        # In-process notifications (tests, embedded drivers).
        try:
            while True:
                self._host_messages.get_nowait()
                updated = True
        except queue.Empty:
            pass
        if updated:
            raise HostsUpdatedInterrupt()

    def save(self):
        """Snapshot the state in memory (cheap, local)."""
        raise NotImplementedError()

    def restore(self):
        """Restore the last committed snapshot."""
        raise NotImplementedError()

    def sync(self):
        """Synchronize state across workers (broadcast from rank 0)."""
        raise NotImplementedError()

    def reset(self):
        """Rebuild any world-size-dependent objects after re-init."""
        pass

    # -- durable checkpoint protocol (horovod_tpu.checkpoint) ---------
    def durable_state_dict(self) -> Dict[str, object]:
        """Flat ``{item_name: host_value}`` view of the committed
        snapshot, for the durable checkpoint subsystem.  Names are
        namespaced (``obj/...``, ``tree/...``) so subclasses can
        compose; values must pickle bit-exactly (numpy, python
        scalars).  The dict's values must be REBOUND (not mutated) by
        later ``save()`` calls — the async writer serializes the
        captured references while training runs ahead."""
        raise NotImplementedError()

    def load_durable_state_dict(self, items: Dict[str, object]):
        """Inverse of :meth:`durable_state_dict`: install the restored
        items as BOTH the committed snapshot and the live attributes
        (a restore is a commit you didn't have to compute)."""
        raise NotImplementedError()


class ObjectState(State):
    """State for a dict of picklable python objects, synchronized via
    ``broadcast_object`` (reference: common/elastic.py:112-146)."""

    def __init__(self, bcast_object: Callable, get_rank: Callable,
                 **kwargs):
        self._bcast_object = bcast_object
        self._rank = get_rank
        self._saved_state: Dict = kwargs
        self._set_attrs()
        super().__init__()

    def save(self):
        new_state = {}
        for attr in self._saved_state.keys():
            new_state[attr] = getattr(self, attr)
        self._saved_state = new_state

    def restore(self):
        self._set_attrs()

    def sync(self):
        if self._saved_state:
            self._saved_state = self._bcast_object(self._saved_state)
            self._set_attrs()

    def _set_attrs(self):
        for attr, value in self._saved_state.items():
            setattr(self, attr, value)

    def durable_state_dict(self) -> Dict[str, object]:
        return {"obj/" + k: v for k, v in self._saved_state.items()}

    def load_durable_state_dict(self, items: Dict[str, object]):
        restored = {k[len("obj/"):]: v for k, v in items.items()
                    if k.startswith("obj/")}
        # Items registered at construction but absent from the
        # checkpoint (a new attribute added since it was written) keep
        # their constructor values instead of vanishing.
        merged = dict(self._saved_state)
        merged.update(restored)
        self._saved_state = merged
        self._set_attrs()


def run_fn(func: Callable, reset: Callable):
    """Wrap ``func(state, ...)`` in the elastic retry loop (reference:
    common/elastic.py:147-168).

    * ``HorovodInternalError`` → restore last committed state, reset,
      retry;
    * ``HostsUpdatedInterrupt`` → keep current (committed) state, reset,
      retry;
    * normal return → done.
    """

    def wrapper(state, *args, **kwargs):
        notification_manager.init()
        notification_manager.register_listener(state)
        skip_sync = False
        try:
            while True:
                try:
                    # sync() stays inside the try: a rank dying during
                    # the post-reset broadcast must retry, not kill the
                    # worker (reference keeps sync in the retried body).
                    if not skip_sync:
                        state.sync()
                    return func(state, *args, **kwargs)
                except HorovodInternalError:
                    logger.info("elastic: internal error; restoring last "
                                "committed state")
                    t0 = time.perf_counter()
                    state.restore()
                    RECOVERY_SECONDS.observe(time.perf_counter() - t0,
                                             phase="restore")
                    skip_sync = False
                except HostsUpdatedInterrupt as e:
                    logger.info("elastic: hosts updated; re-initializing")
                    skip_sync = e.skip_sync
                t0 = time.perf_counter()
                reset()
                state.on_reset()
                RECOVERY_SECONDS.observe(time.perf_counter() - t0,
                                         phase="reset")
        finally:
            notification_manager.remove_listener(state)

    return wrapper


class WorkerNotificationManager:
    """Tracks State listeners so external drivers can signal host
    updates into every active State (reference:
    runner/elastic/worker.py WorkerNotificationManager)."""

    def __init__(self):
        self._listeners: List[State] = []
        self._initialized = False

    def init(self):
        self._initialized = True

    def register_listener(self, state: State):
        self._listeners.append(state)

    def remove_listener(self, state: State):
        if state in self._listeners:
            self._listeners.remove(state)

    def handle_hosts_updated(self):
        for listener in self._listeners:
            listener.on_hosts_updated()


notification_manager = WorkerNotificationManager()
