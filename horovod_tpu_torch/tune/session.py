"""TuningSession: the coordinator-side warmup→search→freeze machine.

Runs ONLY on the rank-0 coordinator (fusion planning and round scoring
live there), created by ``controller_net.NetworkController`` when
``HOROVOD_TUNE=1`` and handed to the CoordinatorServer, which calls
``observe_round`` at the end of every broadcast round — under the
server lock, so the session never needs to defend against concurrent
rounds.

Cycle classes.  Every round is classified by its traffic: a round
carrying any ALLTOALL response is **sparse** (the DLRM embedding
exchange — per-step-varying splits, never cacheable), everything else
is **dense** (allreduce/adasum/broadcast, the cache/replay traffic).
Each class accumulates its own sampling windows and drives its own
search strategy, because their fusion optima differ.  The dense class
additionally owns the process-wide worker knobs (cycle time, request
coalescing, replay warmup): those cannot be per-class — a worker does
not know the class of its next cycle — so they are scored on the
dominant steady-state traffic.

Objective.  A window of ``cycles_per_sample`` rounds scores
bytes-of-fused-payload per wall second (the reference parameter
manager's objective); a window that moved zero bytes (barrier/latency
traffic) falls back to rounds per second, so latency-floor workloads
still rank knobs by round rate.  The first ``warmup_windows`` windows
per class are discarded (compilation, cold caches — the reference
warmup discard).

Synchronization.  Worker-knob proposals and the freeze/abort
transitions are queued as PA-frame payloads the server broadcasts
under its lock — every rank applies them at the same position in its
response stream.  Per-class fusion thresholds are coordinator-local
and need no frames.

Failure.  ``abort(reason)`` — wired to the coordinator's rank-lost
path and to the ``tune.propose`` failpoint — reverts every announced
knob to its default in ONE final PA payload, so a mid-search death can
never leave half the world on proposal N and half on N-1.

Counterpart of :mod:`horovod_tpu.tune.session`, copied.
"""

import logging
import threading
import time
from typing import Dict, Optional

from ..common import failpoints as _fp
from ..common import flight_recorder as _fr
from ..common import metrics
from .profile import TunedProfile, new_profile, save_profile
from .search import KnobSpec, make_strategy

logger = logging.getLogger("horovod_tpu_torch.tune")

MB = 1024 * 1024

CLASS_DENSE = "dense"
CLASS_SPARSE = "sparse"

# The worker-side members of the dense knob vector (everything else is
# coordinator-local fusion planning).
WORKER_KNOBS = ("cycle_time_ms", "coalesce", "replay_warmup")
WORKER_KNOB_DEFAULTS = {"cycle_time_ms": 1.0, "coalesce": True,
                        "replay_warmup": 3}

_ROUNDS = metrics.counter(
    "hvd_tune_rounds_total",
    "Negotiation rounds observed by the tuning session, by cycle class")
_SAMPLES = metrics.counter(
    "hvd_tune_samples_total",
    "Scored sampling windows fed to the search, by cycle class")
_FREEZES = metrics.counter(
    "hvd_tune_freezes_total",
    "Tuning sessions frozen into a tuned profile")
_ABORTS = metrics.counter(
    "hvd_tune_aborts_total",
    "Tuning sessions aborted back to default knobs, by reason")
_PHASE = metrics.gauge(
    "hvd_tune_phase",
    "Tuning lifecycle phase (0 idle, 1 search, 2 frozen, -1 aborted)")

_PHASE_CODE = {"search": 1, "frozen": 2, "aborted": -1}


def _class_space(knobs, sparse: bool) -> Dict[str, KnobSpec]:
    """The knob space for one cycle class, anchored at the CURRENT
    knob values (explicit env settings are the search's starting point
    and its tie-break winner, the reference SetAutoTuning semantics)."""
    fusion_default = round(knobs.fusion_threshold_bytes / MB, 4)
    space = {
        "fusion_mb": KnobSpec(
            default=fusion_default,
            candidates=(2.0, 8.0, 32.0, 64.0, 128.0),
            bounds=(1.0, 128.0), gp_samples=6),
    }
    if not sparse:
        space["cycle_time_ms"] = KnobSpec(
            default=float(knobs.cycle_time_ms),
            candidates=(0.5, 1.0, 2.0))
        space["coalesce"] = KnobSpec(
            default=bool(knobs.request_coalescing),
            candidates=(True, False))
        space["replay_warmup"] = KnobSpec(
            default=int(knobs.replay_warmup_cycles),
            candidates=(2, 3, 5))
    return space


class _ClassState:
    __slots__ = ("strategy", "rounds", "samples", "win_rounds",
                 "win_bytes", "win_t0", "last_seen")

    def __init__(self, strategy):
        self.strategy = strategy
        self.rounds = 0
        self.samples = 0
        self.win_rounds = 0
        self.win_bytes = 0
        self.win_t0 = 0.0
        # Global round index of this class's most recent round: the
        # staleness clock that keeps a class whose traffic STOPPED
        # (e.g. a startup-only embedding shuffle) from blocking the
        # freeze forever.
        self.last_seen = 0


class TuningSession:
    def __init__(self, knobs, world_size: int,
                 profile_path: Optional[str] = None,
                 strategy: Optional[str] = None,
                 cycles_per_sample: Optional[int] = None,
                 warmup_windows: Optional[int] = None,
                 max_samples: Optional[int] = None,
                 seed: int = 0):
        self._lock = threading.RLock()
        self.world_size = world_size
        self.profile_path = profile_path
        self.strategy_name = strategy or knobs.tune_strategy
        self.cycles_per_sample = max(1, int(
            knobs.tune_cycles_per_sample if cycles_per_sample is None
            else cycles_per_sample))
        self.warmup_windows = max(0, int(
            knobs.tune_warmup_windows if warmup_windows is None
            else warmup_windows))
        self.max_samples = max(1, int(
            knobs.tune_max_samples if max_samples is None
            else max_samples))
        self.phase = "search"
        self._defaults = {
            "fusion_mb": round(knobs.fusion_threshold_bytes / MB, 4),
            "cycle_time_ms": float(knobs.cycle_time_ms),
            "coalesce": bool(knobs.request_coalescing),
            "replay_warmup": int(knobs.replay_warmup_cycles),
        }
        self._classes: Dict[str, _ClassState] = {
            CLASS_DENSE: _ClassState(make_strategy(
                self.strategy_name, _class_space(knobs, sparse=False),
                seed=seed,
                gp_noise=knobs.autotune_gaussian_process_noise)),
            CLASS_SPARSE: _ClassState(make_strategy(
                self.strategy_name, _class_space(knobs, sparse=True),
                seed=seed + 1000,
                gp_noise=knobs.autotune_gaussian_process_noise)),
        }
        self._warmup_left = {c: self.warmup_windows
                             for c in self._classes}
        self._total_rounds = 0
        self._pending: Optional[dict] = None
        self._last_worker: Dict[str, object] = dict(
            self._worker_knobs_locked())
        self.profile: Optional[TunedProfile] = None
        self.abort_reason: Optional[str] = None
        _PHASE.set(_PHASE_CODE["search"])
        if _fr.ENABLED:
            _fr.record(_fr.TUNE, phase="search",
                       strategy=self.strategy_name,
                       world=world_size)
        # Announce the search phase itself: workers hold replay until
        # the freeze/abort payload flips tuning_active back off.
        self._queue_announcement_locked()

    @classmethod
    def from_profile(cls, knobs, world_size, profile,
                     profile_path: Optional[str] = None
                     ) -> "TuningSession":
        """A session pre-frozen from a reloaded profile: no search
        runs, per-class thresholds come from the artifact, and the
        startup announcement already says ``tuning_active: false`` —
        restarts and elastic resizes skip straight to replay."""
        sess = cls(knobs, world_size, profile_path=profile_path)
        with sess._lock:
            for name, st in sess._classes.items():
                sec = profile.classes.get(name)
                if sec:
                    st.strategy.adopt(sec.get("knobs") or {},
                                      sec.get("score_bytes_per_s"))
                else:
                    st.strategy.adopt({})
            sess.phase = "frozen"
            sess.profile = profile
            _PHASE.set(_PHASE_CODE["frozen"])
            sess._last_worker = {
                k: profile.worker.get(k, sess._defaults[k])
                for k in WORKER_KNOBS}
            if _fr.ENABLED:
                _fr.record(_fr.TUNE, phase="frozen", reloaded=True,
                           classes=sorted(profile.classes))
            sess._queue_announcement_locked()
        return sess

    # ------------------------------------------------------------------
    # coordinator hooks (caller holds the server lock)
    # ------------------------------------------------------------------
    @property
    def active(self) -> bool:
        """True while the search runs (replay stays held)."""
        return self.phase == "search"

    @property
    def finished(self) -> bool:
        return self.phase in ("frozen", "aborted")

    def fusion_threshold_for(self, sparse: bool) -> int:
        """The fusion threshold (bytes) to plan THIS round with —
        per-class: the active proposal while searching, the frozen
        winner afterwards, the default after an abort."""
        with self._lock:
            if self.phase == "aborted":
                return int(self._defaults["fusion_mb"] * MB)
            cls = self._classes[CLASS_SPARSE if sparse
                                else CLASS_DENSE]
            vec = cls.strategy.best if self.finished \
                else cls.strategy.current
            return int(float(vec["fusion_mb"]) * MB)

    def observe_round(self, nbytes: int, sparse: bool):
        """Score one completed broadcast round into its class window;
        closing a window advances that class's search."""
        with self._lock:
            if self.finished:
                return
            name = CLASS_SPARSE if sparse else CLASS_DENSE
            cls = self._classes[name]
            if cls.win_rounds == 0:
                cls.win_t0 = time.monotonic()
            self._total_rounds += 1
            cls.rounds += 1
            cls.win_rounds += 1
            cls.win_bytes += int(nbytes)
            cls.last_seen = self._total_rounds
            _ROUNDS.inc(1, cls=name)
            if cls.win_rounds < self.cycles_per_sample:
                return
            elapsed = max(time.monotonic() - cls.win_t0, 1e-6)
            score = (cls.win_bytes / elapsed) if cls.win_bytes \
                else (cls.win_rounds / elapsed)
            cls.win_rounds = 0
            cls.win_bytes = 0
            if self._warmup_left[name] > 0:
                # Warmup windows pollute the score (compilation, cold
                # caches) — discard them, defaults stay applied.
                self._warmup_left[name] -= 1
                return
            self._advance_locked(name, cls, score)

    def _advance_locked(self, name: str, cls: _ClassState,
                        score: float):
        if _fp.ENABLED:
            # Failpoint site: one knob proposal about to be generated
            # (the new tuning seam).  drop() skips this window's
            # proposal — the search simply re-scores the same vector;
            # error() aborts the whole session to default knobs, the
            # fail-safe a production tuner must have.
            try:
                if _fp.maybe_fail("tune.propose") == "drop":
                    return
            except _fp.FailpointError as e:
                logger.warning("tune.propose failpoint: %s — aborting "
                               "tuning to default knobs", e)
                self.abort("failpoint")
                return
        cls.samples += 1
        _SAMPLES.inc(1, cls=name)
        cls.strategy.advance(score)
        if cls.samples >= self.max_samples:
            cls.strategy.finish()
        if _fr.ENABLED:
            _fr.record(_fr.TUNE, phase="propose", cls=name,
                       sample=cls.samples,
                       score=round(float(score), 1),
                       knobs=dict(cls.strategy.current))
        if name == CLASS_DENSE:
            wk = self._worker_knobs_locked()
            if wk != self._last_worker:
                self._last_worker = dict(wk)
                self._queue_announcement_locked()
        self._maybe_freeze_locked()

    def _maybe_freeze_locked(self):
        # Freeze when every class that has produced traffic has
        # converged (a class that never trafficked keeps defaults —
        # it simply has nothing to score).  A class whose traffic
        # STOPPED mid-search (rounds > 0 but no round for several
        # window-lengths of other-class traffic — e.g. a startup-only
        # embedding shuffle) must not block the freeze forever: it is
        # force-converged on its best-so-far (defaults when nothing
        # was ever scored) and the search moves on.
        stale_after = 4 * self.cycles_per_sample
        blocking = False
        for name, cls in self._classes.items():
            if cls.rounds == 0 or cls.strategy.converged:
                continue
            if self._total_rounds - cls.last_seen > stale_after:
                cls.strategy.finish()
                if _fr.ENABLED:
                    _fr.record(_fr.TUNE, phase="propose", cls=name,
                               stale=True,
                               knobs=dict(cls.strategy.best))
                logger.info(
                    "tune: cycle-class %s went quiet mid-search "
                    "(no round for %d rounds); adopting its "
                    "best-so-far", name, stale_after)
            else:
                blocking = True
        if blocking:
            return
        if self._classes[CLASS_DENSE].rounds == 0 and \
                self._classes[CLASS_SPARSE].rounds == 0:
            return
        self._freeze_locked()

    def _freeze_locked(self):
        profile = new_profile(self.world_size, self.strategy_name)
        for name, cls in self._classes.items():
            if cls.rounds == 0:
                continue
            profile.classes[name] = {
                "knobs": dict(cls.strategy.best),
                "score_bytes_per_s": cls.strategy.best_score,
                "samples": cls.samples,
                "rounds": cls.rounds,
            }
        profile.worker = self._worker_knobs_locked()
        self.profile = profile
        self.phase = "frozen"
        _FREEZES.inc()
        _PHASE.set(_PHASE_CODE["frozen"])
        if self.profile_path:
            try:
                save_profile(profile, self.profile_path)
                logger.info("tuned profile frozen to %s",
                            self.profile_path)
            except OSError:
                logger.warning("could not persist the tuned profile "
                               "to %s", self.profile_path,
                               exc_info=True)
        if _fr.ENABLED:
            _fr.record(_fr.TUNE, phase="frozen",
                       classes=sorted(profile.classes),
                       worker=dict(profile.worker))
        logger.info(
            "autotune converged and froze: %s",
            {c: s["knobs"] for c, s in profile.classes.items()})
        self._last_worker = dict(profile.worker)
        self._queue_announcement_locked()

    def abort(self, reason: str):
        """Revert to default knobs in one atomic announcement (no
        half-applied proposal may survive across ranks)."""
        with self._lock:
            if self.finished:
                return
            self.phase = "aborted"
            self.abort_reason = reason
            _ABORTS.inc(1, reason=reason)
            _PHASE.set(_PHASE_CODE["aborted"])
            if _fr.ENABLED:
                _fr.record(_fr.TUNE, phase="aborted", reason=reason)
            logger.warning("tuning aborted (%s): reverting to default "
                           "knobs", reason)
            self._last_worker = {
                k: self._defaults[k] for k in WORKER_KNOBS}
            self._queue_announcement_locked()

    # ------------------------------------------------------------------
    # announcements (PA payloads the server broadcasts)
    # ------------------------------------------------------------------
    def _worker_knobs_locked(self) -> Dict[str, object]:
        dense = self._classes[CLASS_DENSE].strategy
        vec = dense.best if self.finished else dense.current
        return {k: vec.get(k, self._defaults[k]) for k in WORKER_KNOBS}

    def _queue_announcement_locked(self):
        wk = dict(self._last_worker)
        self._pending = {
            "tuning_active": self.active,
            "tune_phase": self.phase,
            "cycle_time_ms": float(wk["cycle_time_ms"]),
            "coalesce": bool(wk["coalesce"]),
            "replay_warmup": int(wk["replay_warmup"]),
            # Back-compat info field (the legacy PA schema carries the
            # coordinator's live threshold for observability).
            "fusion": self.fusion_threshold_for(False),
        }

    def take_announcement(self) -> Optional[dict]:
        """The queued PA payload, or None; clears the queue (the
        server broadcasts each announcement exactly once, and keeps
        the last one for late-joiner registration replay)."""
        with self._lock:
            p, self._pending = self._pending, None
            return p

    # ------------------------------------------------------------------
    # introspection (tests / bench / hvd.tune_status)
    # ------------------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "phase": self.phase,
                "strategy": self.strategy_name,
                "abort_reason": self.abort_reason,
                "profile_path": self.profile_path,
                "worker": dict(self._last_worker),
                "classes": {
                    name: {
                        "rounds": cls.rounds,
                        "samples": cls.samples,
                        "converged": cls.strategy.converged,
                        "knobs": dict(
                            cls.strategy.best
                            if cls.strategy.converged
                            else cls.strategy.current),
                        "score": cls.strategy.best_score,
                    } for name, cls in self._classes.items()},
            }
