"""Elastic resize policy: signals in, at most one decision out.

PRs 6-13 made failures *measured* (cycle attribution, straggler
scores, blackbox verdicts) but elasticity stayed react-only: the
driver resized the world only when a rank died.  This module is the
control loop that makes those signals actuate — the ``ElasticDriver``
feeds it one ``Signals`` snapshot per discovery tick and it answers
with at most one ``Decision``:

* ``scale_up`` — discovered-but-unadmitted hosts have been pending for
  a full hysteresis window, the world is below ``max_np``, and the
  observed cycle times are stable (never resize INTO an unstable
  world — a resize during a recovery storm compounds the outage);
* ``migrate`` — a rank has been continuously flagged slow (the
  straggler plane's ``elastic/slow/<rank>`` publications, or the straggler
  scorer directly) for ``HOROVOD_STRAGGLER_MIGRATE_AFTER`` seconds:
  the host is evicted checkpoint-first, *before* the stall clock
  would kill the whole cycle.

Anti-flap invariants (docs/failure_recovery.md "Autoscaling"):

* **hysteresis** — a condition must hold for
  ``HOROVOD_ELASTIC_POLICY_WINDOW`` consecutive ticks before it can
  decide; one noisy tick resets the count;
* **cooldown** — after ANY decision the policy is refractory for
  ``HOROVOD_ELASTIC_POLICY_COOLDOWN`` seconds; the up/down pair of a
  flapping signal therefore costs at least one full cooldown, not one
  tick.

The policy is deterministic and clock-injected (``now=``) so unit
tests and the autoscale drill drive it without sleeping.  It never
touches the KV store, sockets, or threads — the driver owns actuation;
this module owns *when*.

Counterpart of :mod:`horovod_tpu.runner.elastic.policy`, copied.
"""

import logging
import time
from typing import Dict, List, Optional

from ...common import env as env_mod
from ...common import metrics

logger = logging.getLogger("horovod_tpu_torch.elastic")

# Decision / resize trigger labels — shared with the flight-recorder
# verdict path (tools/blackbox_merge.compute_verdict names the resize
# trigger from these exact strings).
TRIGGER_SCALE_UP = "scale_up_discovery"
TRIGGER_MIGRATION = "straggler_migration"
TRIGGER_DEATH = "death"

KIND_SCALE_UP = "scale_up"
KIND_MIGRATE = "migrate"

# Single-sourced metric registrations for the whole elasticity loop:
# the driver AND the autoscale drill label resizes through these
# helpers, so the registry-drift gate sees one literal registration.
_RESIZES = metrics.counter(
    "hvd_elastic_resizes_total",
    "Completed elastic resizes by direction (up/down) and trigger "
    "(scale_up_discovery / straggler_migration / death)")
_DECISIONS = metrics.counter(
    "hvd_elastic_policy_decisions_total",
    "Elastic policy decisions by kind (scale_up / migrate), counted "
    "when decided — before actuation completes")
_AUTOSCALE_S = metrics.histogram(
    "hvd_autoscale_seconds",
    "Autoscale latency by phase: decision (signal->decision), "
    "admission (decision->hosts admitted / host evicted), "
    "first_step (decision->first post-resize step)")


def note_resize(direction: str, trigger: str):
    """Count a completed resize (direction: 'up'|'down')."""
    _RESIZES.inc(direction=direction, trigger=trigger)


def note_decision(kind: str):
    _DECISIONS.inc(kind=kind)


def observe_autoscale(phase: str, seconds: float):
    """Record one autoscale-lane phase latency."""
    _AUTOSCALE_S.observe(max(0.0, seconds), phase=phase)


class Signals:
    """One per-tick snapshot of everything the policy may consult.

    All fields are optional except ``world_size`` — absent signals
    (None / empty) simply don't constrain the decision.  Straggler
    scores are the *flagged-only* view (the scorer's slow-vs-dead
    verdict, not raw per-rank scores)."""

    __slots__ = ("world_size", "pending_hosts", "straggler_scores",
                 "cycle_time_s", "queue_depth", "steps_per_s")

    def __init__(self, world_size: int,
                 pending_hosts: int = 0,
                 straggler_scores: Optional[Dict[int, float]] = None,
                 cycle_time_s: Optional[float] = None,
                 queue_depth: Optional[float] = None,
                 steps_per_s: Optional[float] = None):
        self.world_size = world_size
        self.pending_hosts = pending_hosts
        self.straggler_scores = straggler_scores or {}
        self.cycle_time_s = cycle_time_s
        self.queue_depth = queue_depth
        self.steps_per_s = steps_per_s


class Decision:
    __slots__ = ("kind", "trigger", "rank", "reason", "signals")

    def __init__(self, kind: str, trigger: str,
                 rank: Optional[int] = None, reason: str = "",
                 signals: Optional[dict] = None):
        self.kind = kind          # KIND_SCALE_UP | KIND_MIGRATE
        self.trigger = trigger    # verdict-facing trigger label
        self.rank = rank          # flagged rank for migrate
        self.reason = reason
        self.signals = signals or {}

    def __repr__(self):
        return "Decision(%s, trigger=%s, rank=%s, %s)" % (
            self.kind, self.trigger, self.rank, self.reason)


# Cycle-time stability guard: the newest cycle may be at most this
# multiple of the windowed median before scale-up is deferred.
_CYCLE_REGRESSION_X = 2.0


class ElasticPolicy:
    """Hysteresis + cooldown resize policy (pure, clock-injected)."""

    def __init__(self, min_np: int, max_np: Optional[int] = None,
                 window: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 migrate_after_s: Optional[float] = None,
                 now=time.monotonic):
        self._min_np = max(1, min_np)
        self._max_np = max_np                 # None = unbounded
        self._window = window                 # None = read the knob
        self._cooldown_s = cooldown_s
        self._migrate_after_s = migrate_after_s
        self._now = now
        self._scale_up_streak = 0             # hysteresis counter
        self._cycle_hist: List[float] = []    # rolling cycle times
        self._slow_since: Dict[int, float] = {}  # rank -> first flag
        self._last_decision_at: Optional[float] = None

    # Knob indirection: constructor args pin values for tests/drills;
    # otherwise every tick re-reads the env (fresh-parse contract).
    def _win(self) -> int:
        return self._window if self._window is not None \
            else env_mod.policy_window()

    def _cool(self) -> float:
        return self._cooldown_s if self._cooldown_s is not None \
            else env_mod.policy_cooldown()

    def _migrate_after(self) -> float:
        return self._migrate_after_s if self._migrate_after_s \
            is not None else env_mod.straggler_migrate_after()

    def in_cooldown(self) -> bool:
        return (self._last_decision_at is not None and
                self._now() - self._last_decision_at < self._cool())

    def _cycle_stable(self) -> bool:
        """False when the newest cycle regressed hard against the
        windowed median — the world is mid-recovery or mid-storm and a
        resize now would compound it."""
        if len(self._cycle_hist) < 3:
            return True
        hist = sorted(self._cycle_hist[:-1])
        median = hist[len(hist) // 2]
        if median <= 0:
            return True
        return self._cycle_hist[-1] <= median * _CYCLE_REGRESSION_X

    def observe(self, signals: Signals) -> Optional[Decision]:
        """Feed one tick of signals; returns at most one Decision.

        Migration outranks scale-up on the same tick: evicting a
        straggler changes the world the scale-up would target, so the
        (hysteresis-satisfied) migrate decision goes first and the
        cooldown defers the growth."""
        now = self._now()
        if signals.cycle_time_s is not None:
            self._cycle_hist.append(signals.cycle_time_s)
            del self._cycle_hist[:-16]

        # -- persistence tracking (runs even during cooldown, so a
        # straggler flagged mid-refractory is ripe the moment the
        # cooldown lifts) -------------------------------------------
        flagged = set(signals.straggler_scores)
        for rank in list(self._slow_since):
            if rank not in flagged:
                del self._slow_since[rank]   # recovered: reset clock
        for rank in flagged:
            self._slow_since.setdefault(rank, now)

        if signals.pending_hosts > 0 and self._cycle_stable():
            self._scale_up_streak += 1
        else:
            self._scale_up_streak = 0

        if self.in_cooldown():
            return None

        summary = {
            "world_size": signals.world_size,
            "pending_hosts": signals.pending_hosts,
            "cycle_time_s": signals.cycle_time_s,
            "queue_depth": signals.queue_depth,
            "steps_per_s": signals.steps_per_s,
        }

        # -- migrate: persistently flagged straggler ----------------
        if env_mod.straggler_migrate_enabled() and \
                signals.world_size > self._min_np:
            after = self._migrate_after()
            ripe = [(self._slow_since[r], r) for r in sorted(flagged)
                    if now - self._slow_since[r] >= after]
            if ripe:
                since, rank = min(ripe)  # longest-flagged first
                self._decided(now)
                note_decision(KIND_MIGRATE)
                return Decision(
                    KIND_MIGRATE, TRIGGER_MIGRATION, rank=rank,
                    reason="rank %d flagged slow for %.1fs (>= %.1fs)"
                    % (rank, now - since, after),
                    signals=summary)

        # -- scale up: pending capacity held for a full window ------
        if signals.pending_hosts > 0 and \
                self._scale_up_streak >= self._win() and \
                (self._max_np is None or
                 signals.world_size < self._max_np):
            streak = self._scale_up_streak
            self._decided(now)
            note_decision(KIND_SCALE_UP)
            return Decision(
                KIND_SCALE_UP, TRIGGER_SCALE_UP,
                reason="%d pending host(s) stable for %d tick(s)"
                % (signals.pending_hosts, streak),
                signals=summary)
        return None

    def _decided(self, now: float):
        self._last_decision_at = now
        self._scale_up_streak = 0
        self._slow_since.clear()

    def note_external_resize(self):
        """The driver resized for a reason the policy didn't decide
        (a death).  Start the same refractory period — post-recovery
        cycles are noisy and must not trip an immediate migrate."""
        self._decided(self._now())
