"""Commit coordination: the two-phase mark that makes a checkpoint
step all-or-nothing across ranks.

Phase 1 (*prepare*): after a rank's shard file has landed (written,
fsynced, renamed), the rank publishes a prepare mark carrying the
shard's checksum and item list.

Phase 2 (*commit*): the arbiter (rank 0's writer thread) gathers every
rank's mark for the step; only with all of them in hand does it write
the manifest (the durable commit bit) and publish the committed-step
mark.  A rank that died mid-write never marks, the gather times out,
and the step is abandoned — shards without a manifest are invisible
to restore and reaped by GC.

Two transports:

* :class:`LocalCommitCoordinator` — in-process, for single-process
  jobs, unit tests, and the thread-per-rank chaos harness.
* :class:`KVCommitCoordinator` — marks ride the elastic rendezvous KV
  store (``runner/http_server.py``), the same control lane rank
  assignment uses, so real multi-process jobs need no new service.

Counterpart of :mod:`horovod_tpu.checkpoint.coordinator`, copied: the
elastic driver and worker use ``SCOPE``, ``KEY_LATEST`` and
``KVCommitCoordinator``.
"""

import json
import logging
import threading
import time
from typing import Dict, List, Optional

from ..common import failpoints as _fp
from ..common import flight_recorder as _fr
from ..common import metrics

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

SCOPE = "ckpt"
KEY_LATEST = "latest"

_KV_ERRORS = metrics.counter(
    "hvd_ckpt_kv_errors_total",
    "Rendezvous-KV request failures in checkpoint commit coordination "
    "(a climbing counter means the rendezvous is down and two-phase "
    "commit is degrading, not just slow)")

# A gather tolerates this many CONSECUTIVE failed polls (with backoff)
# before abandoning the step early: a dead rendezvous must surface as
# an abandoned commit + warning, never as a silent stall to the
# deadline.
_KV_ERROR_CAP = 20


class CommitCoordinator:
    """Interface; see module docstring for the protocol."""

    def prepare(self, step: int, rank: int, entry: dict):
        """Publish rank's phase-1 mark for ``step`` (shard landed)."""
        raise NotImplementedError

    def gather(self, step: int, world_size: int, timeout: float
               ) -> Optional[List[dict]]:
        """Arbiter: block (bounded) until every rank's mark for
        ``step`` is present; returns them ordered by rank, or None on
        timeout (the step must then be abandoned, never committed)."""
        raise NotImplementedError

    def mark_committed(self, step: int):
        """Arbiter: record ``step`` as the newest committed one (the
        manifest is already on disk — this is the fast-path signal for
        peers and the elastic driver, not the durable truth)."""
        raise NotImplementedError

    def committed_step(self) -> Optional[int]:
        """Newest step the arbiter marked committed, or None."""
        raise NotImplementedError


class LocalCommitCoordinator(CommitCoordinator):
    """In-process coordination (threads standing in for ranks)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._marks: Dict[int, Dict[int, dict]] = {}
        self._committed: Optional[int] = None

    def prepare(self, step: int, rank: int, entry: dict):
        with self._cond:
            self._marks.setdefault(step, {})[rank] = dict(entry)
            self._cond.notify_all()

    def gather(self, step: int, world_size: int, timeout: float
               ) -> Optional[List[dict]]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                marks = self._marks.get(step, {})
                if len(marks) >= world_size:
                    return [marks[r] for r in sorted(marks)][:world_size]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    logger.warning(
                        "ckpt commit gather timed out at step %d: "
                        "have ranks %s of %d", step,
                        sorted(marks), world_size)
                    return None
                self._cond.wait(remaining)

    def mark_committed(self, step: int):
        with self._cond:
            if self._committed is None or step > self._committed:
                self._committed = step
            self._marks.pop(step, None)
            self._cond.notify_all()

    def committed_step(self) -> Optional[int]:
        with self._cond:
            return self._committed


class KVCommitCoordinator(CommitCoordinator):
    """Marks in the rendezvous KV store under the ``ckpt`` scope::

        PUT ckpt/prepare-<step>-<rank>   (phase 1, per rank)
        PUT ckpt/latest                  (phase 2, arbiter)

    ``client`` is a :class:`runner.http_server.RendezvousClient` (or
    anything with its put/get signature).  Transient HTTP failures ride
    the poll loop; the failpoint site ``ckpt.prepare`` injects them
    deliberately (drop = lost mark → commit times out)."""

    def __init__(self, client, poll_interval_s: float = 0.1):
        self._client = client
        self._poll = poll_interval_s

    @staticmethod
    def _prep_key(step: int, rank: int) -> str:
        return "prepare-%d-%d" % (step, rank)

    def prepare(self, step: int, rank: int, entry: dict):
        if _fp.ENABLED and _fp.maybe_fail("ckpt.prepare",
                                          rank=rank) == "drop":
            # A lost prepare mark: the shard landed but the arbiter
            # never learns — the step must time out uncommitted.
            logger.warning("failpoint ckpt.prepare: dropping prepare "
                           "mark step=%d rank=%d", step, rank)
            return
        self._client.put(SCOPE, self._prep_key(step, rank),
                         json.dumps(entry).encode())

    def gather(self, step: int, world_size: int, timeout: float
               ) -> Optional[List[dict]]:
        deadline = time.monotonic() + timeout
        marks: Dict[int, dict] = {}
        consecutive_errors = 0
        warned = False
        prefix = "prepare-%d-" % step
        while True:
            poll_errored = False
            # One scope listing bounds each poll at O(1) requests:
            # only marks that actually LANDED are fetched (at most
            # world_size fetches over the whole gather), instead of
            # world_size GETs per tick — the arbiter's poll no longer
            # scales with the world (the same O(world)-per-interval
            # fix as the coordinator's deadline-heap liveness sweep).
            lister = getattr(self._client, "keys", None)
            if lister is not None:
                try:
                    present = [k for k in lister(SCOPE)
                               if k.startswith(prefix)]
                except OSError:
                    present = None
            else:
                present = None
            if present is not None:
                pending = []
                for k in present:
                    try:
                        r = int(k[len(prefix):])
                    except ValueError:
                        continue
                    if 0 <= r < world_size and r not in marks:
                        pending.append(r)
            else:
                pending = [r for r in range(world_size)
                           if r not in marks]
                if lister is not None:
                    poll_errored = True
            for rank in pending:
                try:
                    raw = self._client.get(SCOPE,
                                           self._prep_key(step, rank))
                except OSError:
                    # Transient reads ride the poll loop, but NOT
                    # unboundedly: count them, warn once, back off,
                    # and abandon the step early when the rendezvous
                    # looks dead (pre-fix this was a silent
                    # `raw = None` that stalled two-phase commit
                    # invisibly until the deadline).
                    _KV_ERRORS.inc(1, op="gather")
                    poll_errored = True
                    if not warned:
                        warned = True
                        logger.warning(
                            "ckpt: rendezvous KV read failed during "
                            "commit gather at step %d (will retry "
                            "with backoff, cap %d consecutive "
                            "errors)", step, _KV_ERROR_CAP,
                            exc_info=True)
                    raw = None
                if raw is not None:
                    try:
                        marks[rank] = json.loads(raw.decode())
                    except ValueError:
                        logger.warning("ckpt: malformed prepare mark "
                                       "for step %d rank %d", step,
                                       rank)
            if len(marks) >= world_size:
                return [marks[r] for r in sorted(marks)]
            if poll_errored:
                consecutive_errors += 1
                if consecutive_errors >= _KV_ERROR_CAP:
                    logger.error(
                        "ckpt: rendezvous KV unreachable for %d "
                        "consecutive polls; abandoning commit gather "
                        "at step %d (have ranks %s of %d)",
                        consecutive_errors, step, sorted(marks),
                        world_size)
                    return None
            else:
                consecutive_errors = 0
            if time.monotonic() >= deadline:
                logger.warning(
                    "ckpt commit gather timed out at step %d: have "
                    "ranks %s of %d", step, sorted(marks), world_size)
                return None
            # Exponential backoff while the KV is erroring, capped so
            # recovery after a blip is still prompt.
            time.sleep(min(self._poll * (2 ** consecutive_errors),
                           2.0) if consecutive_errors else self._poll)

    def mark_committed(self, step: int):
        if _fr.ENABLED:
            # rank 0 explicitly: mark_committed is the commit
            # arbiter's action by protocol (manager._write_one calls
            # it on rank 0 only), and the process-global default tag
            # is whatever rank last init'd in the in-process harness.
            _fr.record(_fr.CKPT, rank=0, phase="manifest_publish",
                       step=step)
        try:
            self._client.put(SCOPE, KEY_LATEST, str(step).encode())
        except OSError:
            # Non-fatal: the manifest on disk is the durable truth;
            # the KV mark only accelerates peers/driver discovery.
            _KV_ERRORS.inc(1, op="mark_committed")
            logger.warning("ckpt: failed to publish committed step %d "
                           "to the rendezvous KV", step)

    def committed_step(self) -> Optional[int]:
        try:
            raw = self._client.get(SCOPE, KEY_LATEST)
        except OSError:
            _KV_ERRORS.inc(1, op="committed_step")
            return None
        if raw is None:
            return None
        try:
            return int(raw.decode())
        except ValueError:
            return None
