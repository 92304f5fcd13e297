"""Live straggler observatory: per-cycle critical-path attribution.

The observability stack answers "what happened" after the fact (metrics
registry, flight recorder, blackbox postmortems); this module answers
"which rank is slow *right now*" — the live signal ROADMAP item 5
needs to distinguish dead from merely-slow ranks and pre-emptively
migrate stragglers before the stall clock fires.  Dapper's contract
(PAPERS.md) is the shape: always-on attribution riding identifiers the
control plane already carries, analysis out-of-band.

Two attribution sources, because steady-state replay goes wire-silent
(the Li et al. VLDB '20 static-graph lesson — the one place the
coordinator could see per-rank readiness goes dark exactly when
production jobs spend their time):

* **Negotiation source** (coordinator side): every CH/RQ contribution
  already arrives in order at rank 0 — today that order is discarded.
  The scorer records per tensor which rank's readiness arrived last
  (``hvd_critical_path_total{rank}``), the ready-spread
  (``hvd_ready_spread_seconds``), and folds each rank's arrival lag
  (t_rank − t_first) into a per-rank EWMA.

* **Replay source** (worker side): each rank summarizes its own phase
  timings (submit→executed e2e, the fused→executed execute slice) into
  rank-labeled gauges (``hvd_worker_phase_seconds{rank,phase}``) that
  ride the EXISTING periodic MR metrics frames — zero new wire kinds,
  zero extra frames, and relay MR→MA pre-aggregation preserves them
  intact because per-rank labels survive ``metrics.merge_snapshots``
  (each rank only ever writes its own label).  The scorer inverts the
  classic straggler signature: a rank whose end-to-end collective
  latency sits far BELOW the cross-rank median is the rank everyone
  else spent that gap waiting on.

Scores are normalized lag ratios: ``lag / max(median_lag, floor)`` for
the negotiation source, ``(median_e2e − e2e) / max(e2e, floor)`` for
the wait-inversion source (floor = ``HOROVOD_STRAGGLER_MIN_LAG``, so
microsecond jitter in a tight world reads all-zero), combined by
elementwise max into ``hvd_straggler_score{rank}``.  Crossing
``HOROVOD_STRAGGLER_THRESHOLD`` emits one flight-recorder event and
publishes ``elastic/slow/<rank>`` to the rendezvous KV — the
consumable hook for verdict-driven pre-emptive migration (wired, not
yet acted on).  Hysteresis (re-arm below threshold/2) keeps a rank
oscillating around the line from storming the KV.

Design constraints (call sites live ON the submit/frame hot paths):

  * one module-attribute check when disabled — every site is written

        if straggler.ENABLED:
            straggler.note_latency(...)

    exactly the failpoints/flight-recorder precedent, asserted by
    tests/test_straggler.py and policed by the hvdlint hot-path gate;
  * lock-free note paths — worker EWMAs are plain float updates
    (atomic enough under the GIL; a lost sample is noise, not a bug);
  * bounded — pending arrival maps are per-in-flight-tensor and
    drained on completion/stall/elastic break; EWMAs are O(world).
"""

import logging
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import env as _env
from . import flight_recorder as _fr
from . import metrics
from . import profiler as _prof

logger = logging.getLogger("horovod_tpu_torch.straggler")

# THE disabled-path gate: every hot-path site checks this one module
# attribute before anything else.  configure()/reset() are the only
# writers (the failpoints/flight_recorder precedent).
ENABLED = False

_EWMA_ALPHA = 0.2
# Heartbeat period for the slow-rank hook while a rank STAYS flagged
# (crossing fires immediately; see refresh()).  Consumers treat a
# notice older than a few periods as "recovered".
_SLOW_REPUBLISH_S = 2.0

_SCORE = metrics.gauge(
    "hvd_straggler_score",
    "Normalized per-rank straggler score (lag relative to the "
    "cross-rank median; >= HOROVOD_STRAGGLER_THRESHOLD flags the rank "
    "slow)")
_CRITICAL_PATH = metrics.counter(
    "hvd_critical_path_total",
    "Negotiated tensors whose readiness this rank completed LAST "
    "(the per-cycle critical path, by rank)")
_READY_SPREAD = metrics.histogram(
    "hvd_ready_spread_seconds",
    "Per-tensor readiness spread at the coordinator "
    "(last arrival - first arrival)")
_FLAGS = metrics.counter(
    "hvd_straggler_flags_total",
    "Threshold crossings: a rank newly flagged slow, by rank")
_PHASES = metrics.gauge(
    "hvd_worker_phase_seconds",
    "Per-rank phase-time EWMAs published into MR metrics frames "
    "(phase: e2e = submit->executed, execute = fused->executed, "
    "negotiate = the difference)")
_OP_RATE = metrics.gauge(
    "hvd_worker_op_rate",
    "Per-rank completed collective ops per second (negotiated + "
    "replayed, counted at the completion callback; published at "
    "MR-poll cadence)")

def configure(enabled: bool = True):
    """(Re)arm the observatory.  Thresholds/floors are read freshly
    from the env by each scorer (the drills sweep them per phase)."""
    global ENABLED
    ENABLED = bool(enabled)
    if enabled:
        logger.debug("straggler observatory armed (threshold=%.2f, "
                     "min_lag=%.3fs)", _env.straggler_threshold(),
                     _env.straggler_min_lag())


def reset():
    """Disable the observatory (tests/drills)."""
    global ENABLED
    ENABLED = False


class PhaseCollector:
    """Per-runtime phase-time EWMAs (one per BackgroundRuntime, NOT
    module state — the in-process chaos harness runs every thread-rank
    in one interpreter, and a shared collector would blend the very
    per-rank signal attribution needs).

    note_* runs on the submit/dispatch hot paths — plain float
    updates, no lock (a lost sample under a race is noise); publish()
    runs on the cold MR-reply path."""

    __slots__ = ("e2e_ewma", "exec_ewma", "ops", "_rate_prev_ops",
                 "_rate_prev_t")

    def __init__(self):
        self.e2e_ewma: Optional[float] = None
        self.exec_ewma: Optional[float] = None
        # Completed ops THIS collector saw (negotiated + replayed —
        # the latency wrapper fires for both).  Counted here, not read
        # from the process registry: in the in-process harness every
        # thread-rank shares one registry, and a global count would
        # publish the same whole-world rate under every rank's label.
        self.ops = 0
        self._rate_prev_ops = 0
        self._rate_prev_t: Optional[float] = None

    def note_latency(self, seconds: float):
        """One submit→executed end-to-end sample (from the completion
        callback wrapper; gate on ENABLED at the call site)."""
        self.ops += 1
        prev = self.e2e_ewma
        self.e2e_ewma = seconds if prev is None else \
            prev + _EWMA_ALPHA * (seconds - prev)

    def note_exec(self, seconds: float):
        """One fused→executed (backend execution) sample."""
        prev = self.exec_ewma
        self.exec_ewma = seconds if prev is None else \
            prev + _EWMA_ALPHA * (seconds - prev)

    def publish(self, rank: int):
        """Fold the phase EWMAs + op rate into rank-labeled gauges so
        the NEXT MR reply carries them (cold, seconds cadence).  Each
        rank only ever writes its OWN label, which is what lets relay
        MA pre-aggregation (a snapshot sum) carry every rank's summary
        through intact."""
        e2e, exc = self.e2e_ewma, self.exec_ewma
        if e2e is not None:
            _PHASES.set(round(e2e, 6), rank=rank, phase="e2e")
            if exc is not None:
                _PHASES.set(round(max(0.0, e2e - exc), 6), rank=rank,
                            phase="negotiate")
        if exc is not None:
            _PHASES.set(round(exc, 6), rank=rank, phase="execute")
        now = time.monotonic()
        ops = self.ops
        if self._rate_prev_t is not None and now > self._rate_prev_t:
            rate = max(0, ops - self._rate_prev_ops) / \
                (now - self._rate_prev_t)
            _OP_RATE.set(round(rate, 3), rank=rank)
        self._rate_prev_ops, self._rate_prev_t = ops, now

    def local_phases(self) -> Dict[str, float]:
        """Current phase EWMAs (the hvd.status() local view); empty
        before any sample."""
        out: Dict[str, float] = {}
        if self.e2e_ewma is not None:
            out["e2e"] = round(self.e2e_ewma, 6)
        if self.exec_ewma is not None:
            out["execute"] = round(self.exec_ewma, 6)
            if self.e2e_ewma is not None:
                out["negotiate"] = round(
                    max(0.0, self.e2e_ewma - self.exec_ewma), 6)
        return out


def phases_from_snapshot(snap: dict) -> Dict[int, Dict[str, float]]:
    """Extract ``{rank: {phase: seconds}}`` from a metrics snapshot
    (an MR reply, a relay MA aggregate, or the merged cluster view) —
    the inverse of publish()'s rank-labeled gauges."""
    out: Dict[int, Dict[str, float]] = {}
    gauges = snap.get("gauges", {}) if isinstance(snap, dict) else {}
    children = gauges.get("hvd_worker_phase_seconds")
    if not isinstance(children, dict):
        return out
    for key, value in children.items():
        labels = dict(item.split("=", 1)
                      for item in key.split(",") if "=" in item)
        try:
            rank = int(labels["rank"])
            phase = labels["phase"]
            out.setdefault(rank, {})[phase] = float(value)
        except (KeyError, ValueError, TypeError):
            continue
    return out


# --- coordinator-side scorer ----------------------------------------------

class StragglerScorer:
    """Rank-0 scorer: folds negotiation arrival order and MR-carried
    worker phase summaries into normalized per-rank scores.

    note_arrival/note_complete are called under the coordinator's
    server lock (frame dispatch); refresh() runs on the coordinator's
    straggler loop.  Lock order is always server lock → scorer lock
    (never the reverse), so the lock witness sees no cycle."""

    def __init__(self, size: int,
                 on_slow: Optional[Callable[[int, float], None]] = None,
                 threshold: Optional[float] = None,
                 min_lag_s: Optional[float] = None,
                 alpha: float = _EWMA_ALPHA):
        self.size = size
        self.threshold = float(threshold) if threshold is not None \
            else _env.straggler_threshold()
        self.min_lag_s = float(min_lag_s) if min_lag_s is not None \
            else _env.straggler_min_lag()
        self._alpha = alpha
        self._on_slow = on_slow
        self._lock = threading.Lock()
        # (psid, name) -> (t_first, {rank: t_arrival}) for tensors
        # whose negotiation is in flight; drained on completion.
        self._pending: Dict[tuple, Tuple[float, Dict[int, float]]] = {}
        self._lag: Dict[int, float] = {}      # negotiation lag EWMAs
        self._wait: Dict[int, float] = {}     # MR-carried e2e EWMAs
        self._scores: Dict[int, float] = {}
        self._flagged: set = set()
        self._neg_samples = 0
        self._last_neg_t: Optional[float] = None
        self._last_refresh_t: Optional[float] = None
        self._last_slow_pub: Dict[int, float] = {}  # rank -> last hook t

    # -- feeding (coordinator frame dispatch, under the server lock) --
    def note_arrival(self, key: tuple, rank: int, t: float):
        with self._lock:
            ent = self._pending.get(key)
            if ent is None:
                self._pending[key] = (t, {rank: t})
            else:
                ent[1].setdefault(rank, t)

    def note_complete(self, key: tuple):
        """The tensor under ``key`` completed: attribute its critical
        path and fold per-rank lags into the EWMAs."""
        with self._lock:
            ent = self._pending.pop(key, None)
            if ent is None or len(ent[1]) < 2:
                return
            t_first, arrivals = ent
            last_rank = max(arrivals, key=arrivals.get)
            spread = arrivals[last_rank] - t_first
            for rank, t in arrivals.items():
                lag = t - t_first
                prev = self._lag.get(rank)
                self._lag[rank] = lag if prev is None else \
                    prev + self._alpha * (lag - prev)
            self._neg_samples += 1
            self._last_neg_t = time.monotonic()
        _READY_SPREAD.observe(spread)
        _CRITICAL_PATH.inc(1, rank=last_rank)

    def note_abandon(self, key: tuple):
        """Drop a pending tensor without attributing it (join-forced
        completion, stall shutdown — the arrival order is not a fair
        lag sample there)."""
        with self._lock:
            self._pending.pop(key, None)

    def reset_pending(self):
        """Elastic break: every in-flight negotiation just failed."""
        with self._lock:
            self._pending.clear()

    def drop_rank(self, rank: int):
        """A rank was promoted to lost: its frozen lag/wait EWMAs,
        score, and slow flag must stop contributing — a dead rank
        advertised as 'top straggler' forever would invert the very
        slow-vs-dead signal this scorer exists to provide (the
        _rank_metrics eviction mirror).  The next refresh() republishes
        its gauge as 0."""
        with self._lock:
            self._lag.pop(rank, None)
            self._wait.pop(rank, None)
            self._scores.pop(rank, None)
            self._flagged.discard(rank)

    def note_worker_phases(self,
                           per_rank: Dict[int, Dict[str, float]]):
        """Adopt MR/MA-carried per-rank phase summaries (the replay-
        mode attribution source)."""
        with self._lock:
            for rank, phases in per_rank.items():
                if "e2e" in phases:
                    self._wait[rank] = float(phases["e2e"])

    # -- scoring -------------------------------------------------------
    @staticmethod
    def _median(values: List[float]) -> float:
        return statistics.median(values) if values else 0.0

    def refresh(self) -> Dict[int, float]:
        """Recompute normalized scores from both sources, publish the
        hvd_straggler_score gauges, and fire the slow hooks on fresh
        threshold crossings.  Cold path (coordinator loop cadence)."""
        with self._lock:
            lags = dict(self._lag)
            waits = dict(self._wait)
            floor = self.min_lag_s
        scores: Dict[int, float] = {}
        if lags:
            base = max(self._median(list(lags.values())), floor)
            for rank, lag in lags.items():
                scores[rank] = 0.0 if lag < floor else lag / base
        if len(waits) >= 2:
            med = self._median(list(waits.values()))
            for rank, e2e in waits.items():
                gap = med - e2e
                s = 0.0 if gap < floor else gap / max(e2e, floor)
                if s > scores.get(rank, 0.0):
                    scores[rank] = s
        newly_slow: List[Tuple[int, float]] = []
        with self._lock:
            self._scores = scores
            self._last_refresh_t = time.monotonic()
            for rank, score in scores.items():
                if score >= self.threshold:
                    if rank not in self._flagged:
                        self._flagged.add(rank)
                        newly_slow.append((rank, score))
                elif score < self.threshold / 2.0:
                    self._flagged.discard(rank)
        for rank in range(self.size):
            _SCORE.set(round(scores.get(rank, 0.0), 3), rank=rank)
        for rank, score in newly_slow:
            _FLAGS.inc(1, rank=rank)
            logger.warning(
                "straggler: rank %d crossed the slow threshold "
                "(score %.2f >= %.2f)", rank, score, self.threshold)
            if _fr.ENABLED:
                _fr.record(_fr.STRAGGLER, rank=0, role="coord",
                           peer=rank, score=round(score, 3),
                           threshold=self.threshold)
            if _prof.ENABLED:
                # Why-is-it-slow: snapshot the profiler's last window
                # at the moment of the crossing (common/profiler.py
                # triggered capture — throttled, cold path).
                _prof.trigger_capture(
                    "straggler",
                    "rank %d score %.2f" % (rank, score))
            self._fire_slow_hook(rank, score)
        # Re-fire the hook (throttled) for ranks STILL flagged: the
        # slow-rank KV notice is a heartbeat, not an edge — consumers
        # (the elastic driver's migration policy) read "flagged right
        # now" as "notice fresher than the staleness bound", so a rank
        # that recovers simply stops being republished.  Logging and
        # the flag counter above stay crossing-only.
        with self._lock:
            still = [(r, scores.get(r, 0.0)) for r in self._flagged]
        now = time.monotonic()
        for rank, score in still:
            if now - self._last_slow_pub.get(rank, 0.0) >= \
                    _SLOW_REPUBLISH_S:
                self._fire_slow_hook(rank, score)
        return scores

    def _fire_slow_hook(self, rank: int, score: float):
        self._last_slow_pub[rank] = time.monotonic()
        if self._on_slow is not None:
            try:
                self._on_slow(rank, score)
            except Exception:
                logger.warning("slow-rank hook failed",
                               exc_info=True)

    # -- reading -------------------------------------------------------
    def top(self) -> Optional[Tuple[int, float]]:
        """(rank, score) of the current worst straggler, or None when
        nothing scores above zero."""
        with self._lock:
            if not self._scores:
                return None
            rank = max(self._scores, key=self._scores.get)
            score = self._scores[rank]
        return (rank, score) if score > 0.0 else None

    def scores(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._scores)

    def flagged(self) -> List[int]:
        with self._lock:
            return sorted(self._flagged)

    def snapshot(self) -> dict:
        """JSON-ready scorer state for /status."""
        with self._lock:
            return {
                "threshold": self.threshold,
                "min_lag_s": self.min_lag_s,
                "scores": {str(r): round(s, 3)
                           for r, s in sorted(self._scores.items())},
                "flagged": sorted(self._flagged),
                "lag_ewma_s": {str(r): round(v, 6)
                               for r, v in sorted(self._lag.items())},
                "wait_ewma_s": {str(r): round(v, 6)
                                for r, v in sorted(self._wait.items())},
                "negotiation_samples": self._neg_samples,
            }


# Arm from the environment at import: the knob rides the launcher env
# contract to every worker (the HOROVOD_FAILPOINTS precedent).
if _env.env_bool(_env.HOROVOD_STRAGGLER):
    configure(enabled=True)
