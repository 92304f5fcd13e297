"""SLO plane: is the job meeting its throughput target, and how fast
is it burning budget when it is not.

The straggler observatory ranks peers *relative to each other*; this
module holds the runtime to an *absolute* service level.  Two SLIs,
both fed from sites the hot path already instruments:

* **steps/s** — completed collective operations per second (the
  ``hvd_worker_op_rate`` vocabulary), target
  ``HOROVOD_SLO_STEPS_PER_S``;
* **cycle time** — controller cycle seconds (the
  ``hvd_controller_cycle_seconds`` population), target
  ``HOROVOD_SLO_CYCLE_SECONDS``.

Each SLI is evaluated over a SHORT and a LONG sliding window
(``HOROVOD_SLO_WINDOW_SHORT`` / ``_LONG``) and converted to a burn
rate: ``shortfall / budget``, where shortfall is the normalized miss
against the target and budget (``HOROVOD_SLO_BUDGET``) is the
tolerated fractional miss.  A burn of 1.0 means "missing by exactly
the tolerated amount"; 2.0 means burning budget twice as fast as
sustainable.  The classic SRE multi-window rule kills both failure
modes of single-window alerting: an alert fires only when BOTH
windows burn above ``HOROVOD_SLO_BURN_THRESHOLD`` — the short window
makes it fast, the long window makes it real.

On a burn crossing the plane (a) increments
``hvd_slo_burn_alerts_total``, (b) records a flight-recorder SLO_BURN
event, (c) asks the sampling profiler for a triggered capture (so the
postmortem carries *why* throughput fell, not just that it did), and
(d) calls an optional hook — rank 0 wires it to a rendezvous KV
notice that ``runner/elastic/driver.py`` folds into
``ElasticPolicy.Signals`` (cycle_time_s / steps_per_s — consumed
read-only this PR; the SLO-driven controller is ROADMAP item 4).

Cost contract: the two feeder sites (cycle end, op completion) are
written ``if _slo.ENABLED and tracker is not None: tracker.note_*``
— one module-attribute check when disabled, the straggler/flight
recorder precedent, pinned by tests/test_slo.py.  ``note_*`` itself
is an O(1) deque append under a plain leaf lock shared with the ~1 Hz
evaluator — the lock exists because CPython raises "deque mutated
during iteration" when an append lands mid-scan, and an uncontended
acquire is nanoseconds; nothing else is ever taken while holding it.
"""

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from . import env as _env
from . import flight_recorder as _fr
from . import metrics
from . import profiler as _prof

logger = logging.getLogger("horovod_tpu_torch.slo")

# THE disabled-path gate: feeder sites check this one module attribute
# first.  configure()/reset() are the only writers.
ENABLED = False

_EVAL_INTERVAL_S = 1.0
_ALERT_REFIRE_S = 30.0   # a still-burning alert re-notifies at most
                         # this often (the hook/KV path, not the gauge)
_MAX_OPS = 262144        # op timestamps retained (≈ minutes at 1k/s)
_MAX_CYCLES = 32768      # (t, dt) cycle samples retained

_STEPS = metrics.gauge(
    "hvd_slo_steps_per_s",
    "Achieved throughput SLI (completed collective ops/s) over the "
    "short and long SLO windows, by rank")
_CYCLE = metrics.gauge(
    "hvd_slo_cycle_seconds",
    "Achieved cycle-time SLI (mean controller cycle seconds) over the "
    "short and long SLO windows, by rank")
_BURN = metrics.gauge(
    "hvd_slo_burn_rate",
    "Error-budget burn rate (normalized shortfall / budget) per SLI "
    "and window, by rank; >= the threshold in BOTH windows -> alert")
_ALERTS = metrics.counter(
    "hvd_slo_burn_alerts_total",
    "Multi-window SLO burn-rate alert crossings, by rank and sli")


class SloTracker:
    """Per-runtime SLI accumulator: hot-path feeders append, the cold
    evaluator scans.  ``clock`` is injectable for deterministic burn
    tests."""

    __slots__ = ("_ops", "_cycles", "_t0", "_clock", "_lock",
                 "_ops_seen")

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        # Leaf lock shared by the feeders and window_stats: appending
        # while the evaluator iterates raises RuntimeError ("deque
        # mutated during iteration") — under sustained op traffic
        # that would fail nearly every evaluator tick, silencing burn
        # alerts exactly when the job is loaded.  Nothing is acquired
        # while holding it, so it can never participate in a cycle.
        self._lock = threading.Lock()
        self._ops = deque(maxlen=_MAX_OPS)
        self._cycles = deque(maxlen=_MAX_CYCLES)
        self._ops_seen = False
        self._t0 = clock()

    # -- hot feeders (O(1) append under the leaf lock) -----------------
    def note_op(self, n: int = 1):
        """``n`` collective ops completed (one fused response may
        complete many; gate on ENABLED at the site)."""
        with self._lock:
            self._ops.append((self._clock(), n))
            self._ops_seen = True

    def note_cycle(self, dt: float):
        """One controller cycle finished in ``dt`` seconds."""
        with self._lock:
            self._cycles.append((self._clock(), dt))

    # -- cold reads ----------------------------------------------------
    def ops_seen(self) -> bool:
        """True once ANY op completion has ever been observed — the
        steps/s SLI's has-data gate.  Sticky on purpose: a window
        with zero ops after the first op is a genuine full stall and
        must be judged, but a job still in JIT compile / warmup that
        has never completed an op has produced no data to judge."""
        return self._ops_seen

    def uptime(self) -> float:
        return max(1e-6, self._clock() - self._t0)

    def window_stats(self, window_s: float) -> Dict[str, float]:
        """Achieved SLI values over the trailing ``window_s`` seconds.
        The window is clamped to uptime so a fresh tracker is judged
        only on the time it has actually lived (no startup burn)."""
        now = self._clock()
        span = min(window_s, self.uptime())
        cutoff = now - span
        # Half-open trailing window (cutoff, now]: a sample sitting
        # exactly on the boundary belongs to the previous window.
        # The scan holds the feeder lock — iteration breaks at the
        # window edge, so the hold is proportional to the window's
        # sample count, not the retention caps.
        ops = 0
        cyc_n = 0
        cyc_sum = 0.0
        with self._lock:
            for t, n in reversed(self._ops):
                if t <= cutoff:
                    break
                ops += n
            for t, dt in reversed(self._cycles):
                if t <= cutoff:
                    break
                cyc_n += 1
                cyc_sum += dt
        return {
            "span_s": span,
            "ops": float(ops),
            "steps_per_s": ops / span,
            "cycle_seconds": (cyc_sum / cyc_n) if cyc_n else 0.0,
            "cycles": float(cyc_n),
        }


def _shortfall(sli: str, achieved: float, target: float) -> float:
    """Normalized miss in [0, 1]: 0 = meeting target, 1 = total miss.
    steps/s is higher-is-better; cycle time is lower-is-better."""
    if target <= 0.0:
        return 0.0
    if sli == "steps_per_s":
        return min(1.0, max(0.0, 1.0 - achieved / target))
    # cycle_seconds: a cycle twice the target is a 100% miss.
    return min(1.0, max(0.0, achieved / target - 1.0))


class SloPlane:
    """The evaluator: owns the alert state machine and the ~1 Hz
    daemon thread; reads whichever tracker is registered."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tracker: Optional[SloTracker] = None
        self.rank: Optional[int] = None
        self._hook: Optional[Callable[[dict], None]] = None
        self._alerting: Dict[str, bool] = {}
        self._last_fire: Dict[str, float] = {}
        self._alert_counts: Dict[str, int] = {}
        self._last_eval: Optional[dict] = None

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._eval_loop, name="hvd-slo", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _eval_loop(self):
        while not self._stop.wait(_EVAL_INTERVAL_S):
            try:
                self.evaluate()
            except Exception:
                logger.warning("slo evaluation failed", exc_info=True)

    # -- evaluation ----------------------------------------------------
    def evaluate(self) -> dict:
        """One evaluation tick: compute both windows for both SLIs,
        update alert state, fire side effects on crossings.  Safe to
        call directly (tests, slo_status on demand)."""
        cfg = _env.slo_targets()
        tracker = self.tracker
        out = {
            "enabled": True,
            "rank": self.rank,
            "targets": {"steps_per_s": cfg["steps_per_s"],
                        "cycle_seconds": cfg["cycle_seconds"]},
            "windows": {"short_s": cfg["window_short"],
                        "long_s": cfg["window_long"]},
            "budget": cfg["budget"],
            "burn_threshold": cfg["burn_threshold"],
            "slis": {},
            "alerts_total": dict(self._alert_counts),
        }
        if tracker is None:
            self._last_eval = out
            return out
        short = tracker.window_stats(cfg["window_short"])
        long_ = tracker.window_stats(cfg["window_long"])
        for sli, key in (("steps_per_s", "steps_per_s"),
                         ("cycle_seconds", "cycle_seconds")):
            target = cfg[key]
            # No-data gates: a cycle SLI with no cycles yet has
            # nothing to judge, and the steps SLI must not judge a
            # job that has never completed an op — JIT compile /
            # warmup can take minutes, and the uptime clamp only
            # fixes the rate denominator, not the no-data case.
            # ops_seen is sticky, so a zero-op window AFTER the
            # first op is a genuine full stall and IS judged.
            if sli == "steps_per_s":
                has_data = tracker.ops_seen()
            else:
                has_data = short["cycles"] > 0
            entry = {
                "target": target,
                "short": round(short[key], 6),
                "long": round(long_[key], 6),
                "has_data": has_data,
            }
            if target > 0.0:
                b_short = _shortfall(sli, short[key], target) \
                    / cfg["budget"] if has_data else 0.0
                b_long = _shortfall(sli, long_[key], target) \
                    / cfg["budget"] if has_data else 0.0
                entry["burn_short"] = round(b_short, 4)
                entry["burn_long"] = round(b_long, 4)
                alerting = (b_short >= cfg["burn_threshold"] and
                            b_long >= cfg["burn_threshold"])
                entry["alerting"] = alerting
                self._on_alert_state(sli, alerting, entry)
            out["slis"][sli] = entry
        out["alerts_total"] = dict(self._alert_counts)
        with self._lock:
            self._last_eval = out
        return out

    def _on_alert_state(self, sli: str, alerting: bool, entry: dict):
        now = time.monotonic()
        with self._lock:
            was = self._alerting.get(sli, False)
            self._alerting[sli] = alerting
            refire = alerting and \
                now - self._last_fire.get(sli, 0.0) >= _ALERT_REFIRE_S
            crossing = alerting and not was
            if crossing or refire:
                self._last_fire[sli] = now
        if not (crossing or refire):
            return
        if crossing:
            with self._lock:
                self._alert_counts[sli] = \
                    self._alert_counts.get(sli, 0) + 1
            _ALERTS.inc(1, rank=self.rank if self.rank is not None
                        else "unset", sli=sli)
            logger.warning(
                "SLO burn alert: %s achieving %s (target %s), burn "
                "short=%.2f long=%.2f", sli, entry["short"],
                entry["target"], entry["burn_short"],
                entry["burn_long"])
        if _fr.ENABLED:
            _fr.record(_fr.SLO_BURN, sli=sli, short=entry["short"],
                       long=entry["long"], target=entry["target"],
                       burn=entry["burn_short"])
        if _prof.ENABLED:
            _prof.trigger_capture(
                "slo_burn", "%s=%s target=%s burn=%.2f" % (
                    sli, entry["short"], entry["target"],
                    entry["burn_short"]))
        hook = self._hook
        if hook is not None:
            try:
                hook({"sli": sli, **entry})
            except Exception:
                logger.warning("slo burn hook failed", exc_info=True)

    # -- reads / publication ------------------------------------------
    def status(self) -> dict:
        with self._lock:
            last = self._last_eval
        if last is None:
            return self.evaluate()
        return last

    def signals_reading(self) -> Dict[str, Optional[float]]:
        """The tuple ElasticPolicy.Signals consumes: short-window
        achieved values.  None means the SLI has no samples yet;
        an achieved 0.0 steps/s with samples is a real full-stall
        reading — the most actionable one — and is reported as 0.0,
        never collapsed into no-data by truthiness."""
        st = self.status()
        slis = st.get("slis", {})
        steps_e = slis.get("steps_per_s", {})
        cyc_e = slis.get("cycle_seconds", {})
        return {
            "steps_per_s": steps_e.get("short")
            if steps_e.get("has_data") else None,
            "cycle_time_s": cyc_e.get("short")
            if cyc_e.get("has_data") else None,
        }

    def publish(self, rank: int):
        """Fold the last evaluation into rank-labeled gauges so the
        next MR reply carries them (each rank writes only its OWN
        label — the relay MA pre-aggregation survival contract)."""
        self.rank = rank
        st = self.status()
        for sli, gauge in (("steps_per_s", _STEPS),
                           ("cycle_seconds", _CYCLE)):
            entry = st.get("slis", {}).get(sli)
            if not entry:
                continue
            gauge.set(entry["short"], rank=rank, window="short")
            gauge.set(entry["long"], rank=rank, window="long")
            for window in ("short", "long"):
                burn = entry.get("burn_%s" % window)
                if burn is not None:
                    _BURN.set(burn, rank=rank, sli=sli, window=window)


# ---------------------------------------------------------------------------
# module-level lifecycle
# ---------------------------------------------------------------------------

_PLANE: Optional[SloPlane] = None


def configure(enabled: bool = True,
              clock: Callable[[], float] = time.monotonic):
    """(Re)arm the SLO plane: creates a fresh tracker + evaluator
    thread.  ``clock`` is injectable for deterministic tests."""
    global ENABLED, _PLANE
    if not enabled:
        reset()
        return
    if _PLANE is not None:
        _PLANE.stop()
    _PLANE = SloPlane()
    _PLANE.tracker = SloTracker(clock=clock)
    _PLANE.start()
    ENABLED = True
    logger.debug("slo plane armed")


def reset():
    """Disable the plane and stop its evaluator thread."""
    global ENABLED, _PLANE
    ENABLED = False
    if _PLANE is not None:
        _PLANE.stop()
        _PLANE = None


def plane() -> Optional[SloPlane]:
    return _PLANE


def tracker() -> Optional[SloTracker]:
    """The hot-path feeder handle: cache it once per runtime and gate
    every use on ``slo.ENABLED and tr is not None``."""
    p = _PLANE
    return p.tracker if p is not None else None


def set_rank(rank: int):
    p = _PLANE
    if p is not None:
        p.rank = rank


def set_burn_hook(fn: Optional[Callable[[dict], None]]):
    """Install the alert side-channel (rank 0 wires a rendezvous KV
    publisher; drills wire an event recorder)."""
    p = _PLANE
    if p is not None:
        p._hook = fn


def publish(rank: int):
    """Feeder site for the MR-reply path; gate on ENABLED there."""
    p = _PLANE
    if p is not None:
        p.publish(rank)


def slo_status() -> dict:
    """The ``hvd.slo_status()`` payload; self-describing when off."""
    p = _PLANE
    if p is None:
        return {"enabled": False}
    return p.status()


def signals_reading() -> Dict[str, Optional[float]]:
    p = _PLANE
    if p is None:
        return {"steps_per_s": None, "cycle_time_s": None}
    return p.signals_reading()


def slo_from_snapshot(snap: dict) -> Dict[int, dict]:
    """Extract ``{rank: {sli: {window: value}, burn: {...}}}`` from a
    metrics snapshot (MR reply / relay MA aggregate / merged cluster
    view) — the digest_from_snapshot shape for the SLO gauges."""
    out: Dict[int, dict] = {}
    gauges = snap.get("gauges", {}) if isinstance(snap, dict) else {}
    for metric, field in (("hvd_slo_steps_per_s", "steps_per_s"),
                          ("hvd_slo_cycle_seconds", "cycle_seconds")):
        children = gauges.get(metric)
        if not isinstance(children, dict):
            continue
        for key, value in children.items():
            labels = dict(item.split("=", 1)
                          for item in key.split(",") if "=" in item)
            try:
                rank = int(labels["rank"])
                window = labels["window"]
            except (KeyError, ValueError):
                continue
            out.setdefault(rank, {}).setdefault(
                field, {})[window] = float(value)
    children = gauges.get("hvd_slo_burn_rate")
    if isinstance(children, dict):
        for key, value in children.items():
            labels = dict(item.split("=", 1)
                          for item in key.split(",") if "=" in item)
            try:
                rank = int(labels["rank"])
            except (KeyError, ValueError):
                continue
            out.setdefault(rank, {}).setdefault("burn", {})[
                "%s.%s" % (labels.get("sli", "?"),
                           labels.get("window", "?"))] = float(value)
    return out


# Arm from the environment at import (the HOROVOD_FAILPOINTS
# precedent: the knob rides the launcher env contract to every rank).
if _env.env_bool(_env.HOROVOD_SLO):
    configure(enabled=True)
