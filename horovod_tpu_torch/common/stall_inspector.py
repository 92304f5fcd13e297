"""Stall inspector: detect ranks that fail to submit matching tensors.

Mirrors the reference stall inspector (reference: stall_inspector.{h,cc}:
rank-0 warns when some ranks submitted a tensor and others have not for
>60 s (:74-80), optionally shuts down after
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, and invalidates stalled cached
tensors so they renegotiate).
"""

import logging
import threading
import time
from typing import Dict, List, Set, Tuple

from . import flight_recorder as _fr
from . import metrics
from . import profiler as _prof

logger = logging.getLogger("horovod_tpu_torch.stall")

_STALL_WARNINGS = metrics.counter(
    "hvd_stall_warnings_total",
    "Tensors that crossed the stall warning threshold")


class StallInspector:
    def __init__(self, warning_time_s: float = 60.0,
                 shutdown_time_s: float = 0.0, world_size: int = 1):
        self.warning_time_s = warning_time_s
        self.shutdown_time_s = shutdown_time_s
        self.world_size = world_size
        # tensor name -> (first seen ts, set of ranks that reported).
        # The submitting thread and the dispatching one record and
        # remove while the background cycle checks: all under _lock.
        self._uncompleted: Dict[str, Tuple[float, Set[int]]] = {}
        self._warned: Set[str] = set()
        self._lock = threading.Lock()
        # Optional live-straggler hook (common/straggler.py): when the
        # coordinator's scorer is armed on this rank, warnings name
        # the current top straggler so "everyone blocked on a slow
        # rank" is distinguishable from "a rank died / coordinator
        # wedged" without a postmortem.
        self._straggler_provider = None
        # Optional why-is-it-slow hook (common/profiler.py): when the
        # coordinator also holds per-rank profile digests, the warning
        # names the implicated rank's dominant frame — root cause, not
        # just attribution.
        self._root_cause_provider = None

    def set_straggler_provider(self, fn):
        """``fn() -> Optional[(rank, score)]`` — wired by the runtime
        on the rank hosting the Python coordinator."""
        self._straggler_provider = fn

    def set_root_cause_provider(self, fn):
        """``fn(rank) -> Optional[str]`` — a one-clause root cause for
        the given rank ("failpoints:maybe_fail (submit lane, 72% of
        samples)"), from the coordinator's profile digests."""
        self._root_cause_provider = fn

    def _root_cause_note(self, rank: int) -> str:
        if self._root_cause_provider is None:
            return ""
        try:
            cause = self._root_cause_provider(rank)
        except Exception:
            return ""
        return (", dominant frame: %s" % cause) if cause else ""

    def _straggler_note(self) -> str:
        if self._straggler_provider is None:
            return ""
        try:
            top = self._straggler_provider()
        except Exception:
            return ""
        if top is None:
            return ""
        return (". Current top straggler: rank %d (score %.1f%s) — if "
                "it is among the waiting ranks, they are slow, not "
                "dead" % (top[0], top[1],
                          self._root_cause_note(top[0])))

    def record_uncached_tensor(self, name: str, rank: int):
        now = time.monotonic()
        with self._lock:
            ts, ranks = self._uncompleted.get(name, (now, set()))
            ranks.add(rank)
            self._uncompleted[name] = (ts, ranks)

    def record_cached_tensor(self, name: str):
        # Cached tensors bypass negotiation; still track timestamps so a
        # rank that stops submitting a cached tensor is caught.
        self.record_uncached_tensor(name, -1)

    def remove(self, name: str):
        with self._lock:
            self._uncompleted.pop(name, None)
            self._warned.discard(name)

    def check(self) -> List[str]:
        """Returns tensor names to invalidate from the response cache;
        logs warnings; raises on shutdown threshold."""
        now = time.monotonic()
        invalidate = []
        stalled_msgs = []
        with self._lock:
            pending = [(name, ts, sorted(r for r in ranks if r >= 0))
                       for name, (ts, ranks) in self._uncompleted.items()]
            warned = set(self._warned)
        for name, ts, ready in pending:
            age = now - ts
            if age > self.warning_time_s and name not in warned:
                missing = sorted(set(range(self.world_size)) - set(ready))
                stalled_msgs.append(
                    f"{name} [ready: {ready}, waiting: {missing}]")
                invalidate.append(name)
                _STALL_WARNINGS.inc()
            if self.shutdown_time_s > 0 and age > self.shutdown_time_s:
                raise RuntimeError(
                    f"Stalled tensor {name!r} exceeded shutdown threshold "
                    f"({self.shutdown_time_s}s); aborting (set "
                    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=0 to disable).")
        if invalidate:
            with self._lock:
                self._warned.update(n for n in invalidate
                                    if n in self._uncompleted)
        if stalled_msgs:
            # Flight-recorder attribution: what the implicated tensors
            # last DID (submit/frame/replay events from the black-box
            # ring), not just which ranks are waiting.
            recent = _fr.recent_for_tensors(invalidate) \
                if _fr.ENABLED and invalidate else []
            if _prof.ENABLED:
                # Why-is-it-slow: freeze the profiler's last window at
                # the moment the stall surfaced (triggered capture —
                # throttled, cold warning path).
                _prof.trigger_capture(
                    "stall", stalled_msgs[0][:120])
            logger.warning(
                "One or more tensors were submitted to be reduced/gathered "
                "but some ranks have not yet submitted them. Stalled ops: %s%s%s",
                "; ".join(stalled_msgs),
                self._straggler_note(),
                (". Last recorder events: %s" % recent) if recent
                else "")
        return invalidate
