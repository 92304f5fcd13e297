"""Continuous low-Hz sampling profiler: *why* is this rank slow.

The observatory (common/straggler.py) names WHICH rank is slow and the
flight recorder (common/flight_recorder.py) reconstructs WHAT happened
after a failure; this module answers the remaining live question — what
the slow rank's threads are actually DOING — without a restart, a
debugger, or per-call instrumentation.  Same lineage as the rest of the
plane (Dapper / the NCCL flight recorder, PAPERS.md): always-on cheap
attribution, analysis out-of-band.

Mechanism: a daemon thread walks ``sys._current_frames()`` at
``HOROVOD_PROFILE_HZ`` (default 10 Hz — a wall-clock sampling profiler,
py-spy-shaped, not a tracing one; overhead is O(threads × depth) dict
walks per tick, independent of op rate).  Each sample is collapsed into
a ``thread;module:func;...;module:func`` stack string and attributed to
a *subsystem lane* by the modules on the stack:

* ``submit``      — user/framework submission path (runtime.submit,
  tensor queue, ops dispatch, failpoint delays injected there);
* ``controller``  — negotiation / frame plane (controller_net, relay);
* ``ring``        — data-plane backends (horovod_tpu/ops);
* ``replay``      — steady-state replay matching;
* ``checkpoint``  — shard write / restore paths;
* ``other``       — anything else (user code, jax internals).

Two derived shares ride along, both *estimates* (a pure-Python sampler
cannot see C frames): ``blocking_share`` — samples whose leaf is a
known blocking/wait call (recv/select/wait/sleep/fsync...), and
``gil_wait_share`` — the mean of (runnable−1)/runnable over samples,
i.e. the fraction of runnable-thread time that must be spent waiting
for the GIL given how many threads were simultaneously runnable.

Transport: each rank folds its top-K hot frames (framework waits
excluded — a recv loop parked on a socket is where threads *park*, not
where time is *lost*) into rank-labeled gauge children
(``hvd_prof_hot_share{rank,k,lane,frame}``) on the cold MR-reply path,
so the digest rides the EXISTING metrics frames and survives relay
MR→MA pre-aggregation exactly like the straggler phase summaries (each
rank only ever writes its own label).  Rank 0 can therefore always say
"rank 3 is slow in shard_io:fsync" from digests alone.  The full
collapsed-stack profile is served per rank at job-secret
``GET /profile`` (tools/flame.py merges and renders them).

Triggered capture: a straggler flag, a stall warning, or an SLO burn
crossing calls :func:`trigger_capture` — the last window's dominant
frames are attached to one flight-recorder PROFILE event and kept as
``last_capture`` in the /profile payload, so the postmortem carries the
live profile at the moment the symptom fired (throttled; captures are
cheap but a flapping trigger must not spam the ring).

Design constraints (the trigger sites live on warning/refresh paths;
the sampler itself owns its cost):

  * one module-attribute check when disabled — every feeder site is
    written ``if profiler.ENABLED: profiler.trigger_capture(...)``,
    the failpoints/flight-recorder/straggler precedent, pinned by
    tests/test_profiler.py and policed by the hvdlint hot-path gate;
  * bounded memory — collapsed-stack aggregation is capped
    (_MAX_STACKS; overflow folds into a ``(truncated)`` bucket) and
    the trigger window is a fixed-size deque;
  * the sampler never takes project locks — ``sys._current_frames``
    is a snapshot, frame walks touch only interpreter state.
"""

import logging
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import env as _env
from . import flight_recorder as _fr
from . import metrics

logger = logging.getLogger("horovod_tpu_torch.profiler")

# THE disabled-path gate: every feeder site checks this one module
# attribute before anything else.  configure()/reset() are the only
# writers (the failpoints/flight_recorder/straggler precedent).
ENABLED = False

_MAX_DEPTH = 48          # frames kept per stack (leaf-most win)
_MAX_STACKS = 512        # distinct collapsed stacks retained per lane
_CAPTURE_THROTTLE_S = 1.0
_WINDOW_SAMPLES = 4096   # trigger-capture window (ring of samples)

_HOT = metrics.gauge(
    "hvd_prof_hot_share",
    "Per-rank top-K hot frames from the sampling profiler: share of "
    "active samples attributed to {frame} in {lane}, published into "
    "MR metrics frames (k orders the digest)")
_GIL_WAIT = metrics.gauge(
    "hvd_prof_gil_wait_share",
    "Estimated share of runnable-thread time spent waiting on the GIL "
    "(mean of (runnable-1)/runnable per sample), by rank")
_BLOCKING = metrics.gauge(
    "hvd_prof_blocking_share",
    "Share of samples whose leaf frame is a known blocking/wait call "
    "(recv/select/wait/sleep/fsync/...), by rank")
_SAMPLES = metrics.counter(
    "hvd_prof_samples_total",
    "Stack samples taken by the profiler thread, by rank")
_CAPTURES = metrics.counter(
    "hvd_prof_captures_total",
    "Triggered profile captures, by trigger reason "
    "(straggler / stall / slo_burn / manual)")

# Leaf function names that indicate a blocking syscall / wait under
# the leaf Python frame (the C callee is invisible to the sampler).
_BLOCKING_LEAF = frozenset((
    "wait", "acquire", "sleep", "select", "poll", "recv", "recv_into",
    "recvfrom", "accept", "read", "readinto", "write", "flush",
    "fsync", "join", "get", "send", "sendall", "connect",
))
# stdlib wait machinery: a leaf here means the thread is parked in
# framework plumbing (Event.wait, queue.get, selector loops) — counted
# into blocking_share but excluded from the hot-frame digest.
_IDLE_MODULES = frozenset((
    "threading", "selectors", "queue", "socketserver", "ssl",
))
# Project-side park points: receive/poll loops that are *supposed* to
# sit in a blocking call all day.  Keeping them out of the digest is
# what lets the digest answer "where is time LOST" instead of "where
# do threads WAIT" — a curated list, not a heuristic, because the
# profiler ships with the runtime it profiles.
_PARK_FUNCS = frozenset((
    "_recv_exact", "recv_exact", "_recv_exact_bounded", "recv_frame",
    "_recv_frame_bounded", "_recv_loop", "_parent_recv_loop",
    "_uplink_loop", "_accept_loop", "_mux_loop", "serve_forever",
    "_metrics_loop", "_straggler_loop", "_stall_loop", "_hb_loop",
    "_liveness_loop", "_sampler_loop", "_eval_loop", "_loop",
    "handle_request", "poll_once",
))

# Lane attribution by module basename (leaf-most project frame wins).
_LANE_BY_MODULE = {
    "runtime": "submit",
    "tensor_queue": "submit",
    "failpoints": "submit",
    "controller": "controller",
    "controller_net": "controller",
    "relay": "controller",
    "message": "controller",
    "replay": "replay",
}
_LANES = ("submit", "controller", "ring", "replay", "checkpoint",
          "other")


def _classify(filenames: List[str], funcs: List[str]) -> str:
    """Lane of a stack (leaf-most attributable frame wins)."""
    for fname, func in zip(filenames, funcs):
        if "horovod_tpu" not in fname:
            continue
        if "/checkpoint/" in fname:
            return "checkpoint"
        if "/ops/" in fname:
            return "ring"
        mod = fname.rsplit("/", 1)[-1][:-3]
        lane = _LANE_BY_MODULE.get(mod)
        if lane is not None:
            return lane
    return "other"


def _frame_name(filename: str, func: str) -> str:
    """``module:func`` — short, stable, label-safe (no ',', '=', '"'
    — the metrics label sanitizer would mangle them)."""
    base = filename.rsplit("/", 1)[-1]
    if base.endswith(".py"):
        base = base[:-3]
    return "%s:%s" % (base, func)


class SamplingProfiler:
    """The per-process sampler (one per interpreter — threads are a
    process-wide resource, unlike the per-runtime PhaseCollector)."""

    def __init__(self, hz: Optional[float] = None,
                 topk: Optional[int] = None):
        self.hz = float(hz) if hz is not None else _env.profile_hz()
        self.topk = int(topk) if topk is not None \
            else _env.profile_topk()
        self.rank: Optional[int] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_start = time.monotonic()
        # (lane, collapsed_stack) -> sample count, active only.
        self._counts: Dict[tuple, int] = {}
        self._lane_totals: Dict[str, int] = {}
        self._samples = 0          # sampling ticks
        self._thread_samples = 0   # per-thread stack samples
        self._blocking = 0
        self._gil_accum = 0.0
        # Recent active samples for triggered capture: (t, lane, stack).
        self._window = deque(maxlen=_WINDOW_SAMPLES)
        self._last_capture: Optional[dict] = None
        self._last_capture_t = 0.0

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._sampler_loop, name="hvd-profiler",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- sampling ------------------------------------------------------
    def _sampler_loop(self):
        interval = 1.0 / max(0.1, self.hz)
        me = threading.get_ident()
        while not self._stop.wait(interval):
            try:
                self._sample_once(me)
            except Exception:
                # A sampler crash must never take down training; the
                # profile just stops advancing.
                logger.warning("profiler sample failed", exc_info=True)

    def _sample_once(self, self_ident: int):
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        now = time.monotonic()
        runnable = 0
        batch = []  # (lane, stack, active, blocking)
        for ident, frame in frames.items():
            if ident == self_ident:
                continue
            files: List[str] = []
            funcs: List[str] = []
            f = frame
            depth = 0
            while f is not None and depth < _MAX_DEPTH:
                files.append(f.f_code.co_filename.replace("\\", "/"))
                funcs.append(f.f_code.co_name)
                f = f.f_back
                depth += 1
            if not funcs:
                continue
            leaf_file, leaf_func = files[0], funcs[0]
            leaf_mod = leaf_file.rsplit("/", 1)[-1][:-3] \
                if leaf_file.endswith(".py") \
                else leaf_file.rsplit("/", 1)[-1]
            blocking = (leaf_func in _BLOCKING_LEAF or
                        leaf_mod in _IDLE_MODULES)
            parked = (leaf_mod in _IDLE_MODULES or
                      any(fn in _PARK_FUNCS for fn in funcs[:3]))
            active = not parked
            if active and not blocking:
                runnable += 1
            lane = _classify(files, funcs)
            tname = names.get(ident, "t%d" % ident)
            # Root→leaf collapsed stack, thread name as the root frame
            # (flamegraph convention; also the only per-"rank" signal
            # the in-process chaos harness has).
            stack = ";".join(
                [_frame_name(tname, "thread")] +
                [_frame_name(fl, fn)
                 for fl, fn in zip(reversed(files), reversed(funcs))])
            batch.append((lane, stack, active, blocking))
        with self._lock:
            self._samples += 1
            for lane, stack, active, blocking in batch:
                self._thread_samples += 1
                if blocking:
                    self._blocking += 1
                if not active:
                    continue
                self._lane_totals[lane] = \
                    self._lane_totals.get(lane, 0) + 1
                key = (lane, stack)
                if key in self._counts or \
                        len(self._counts) < _MAX_STACKS:
                    self._counts[key] = self._counts.get(key, 0) + 1
                else:
                    over = (lane, "(truncated)")
                    self._counts[over] = self._counts.get(over, 0) + 1
                self._window.append((now, lane, stack))
            if runnable > 1:
                self._gil_accum += (runnable - 1) / float(runnable)
        if self.rank is not None:
            _SAMPLES.inc(1, rank=self.rank)
        else:
            _SAMPLES.inc(1, rank="unset")

    # -- reading -------------------------------------------------------
    @staticmethod
    def _leaf(stack: str) -> str:
        return stack.rsplit(";", 1)[-1]

    def top_frames(self, k: Optional[int] = None) -> List[dict]:
        """Top-k hot frames by active-sample share: the leaf frame of
        the hottest collapsed stacks, folded per (lane, leaf)."""
        k = k if k is not None else self.topk
        with self._lock:
            counts = dict(self._counts)
            total = sum(self._lane_totals.values())
        if not total:
            return []
        by_leaf: Dict[tuple, int] = {}
        for (lane, stack), n in counts.items():
            key = (lane, self._leaf(stack))
            by_leaf[key] = by_leaf.get(key, 0) + n
        ranked = sorted(by_leaf.items(), key=lambda kv: -kv[1])[:k]
        return [{"lane": lane, "frame": frame,
                 "share": round(n / total, 4)}
                for (lane, frame), n in ranked]

    def collapsed(self) -> Dict[str, int]:
        """``stack -> count`` (flame-ready: one ``stack count`` line
        each; the stack already carries the lane as metadata via its
        thread-name root)."""
        with self._lock:
            return {stack: n
                    for (_lane, stack), n in self._counts.items()}

    def profile_dict(self) -> dict:
        """The GET /profile payload (JSON-ready)."""
        with self._lock:
            samples = self._samples
            tsamples = self._thread_samples
            blocking = self._blocking
            gil = self._gil_accum
            lanes = dict(self._lane_totals)
            last = self._last_capture
        return {
            "enabled": True,
            "rank": self.rank,
            "hz": self.hz,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "samples": samples,
            "thread_samples": tsamples,
            "blocking_share": round(blocking / tsamples, 4)
            if tsamples else 0.0,
            "gil_wait_share": round(gil / samples, 4)
            if samples else 0.0,
            "lanes": lanes,
            "top": self.top_frames(),
            "collapsed": self.collapsed(),
            "last_capture": last,
        }

    # -- triggered capture --------------------------------------------
    def capture(self, reason: str, detail: str = "") -> Optional[dict]:
        """Snapshot the dominant frames of the last window; throttled.
        Returns the capture dict (None when throttled or empty)."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_capture_t < _CAPTURE_THROTTLE_S:
                return None
            self._last_capture_t = now
            window = list(self._window)
        counts: Dict[tuple, int] = {}
        for _t, lane, stack in window:
            key = (lane, self._leaf(stack))
            counts[key] = counts.get(key, 0) + 1
        total = len(window)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:self.topk]
        cap = {
            "reason": reason,
            "detail": detail,
            "wall": time.time(),
            "window_samples": total,
            "top": [{"lane": lane, "frame": frame,
                     "share": round(n / total, 4) if total else 0.0}
                    for (lane, frame), n in top],
        }
        with self._lock:
            self._last_capture = cap
        _CAPTURES.inc(1, reason=reason)
        if _fr.ENABLED:
            _fr.record(_fr.PROFILE, rank=self.rank, reason=reason,
                       detail=detail[:120],
                       frames=" ".join(
                           "%s@%s" % (e["frame"], e["share"])
                           for e in cap["top"][:3]))
        return cap

    # -- MR digest -----------------------------------------------------
    def publish_digest(self, rank: int):
        """Fold the top-K digest + derived shares into rank-labeled
        gauges so the NEXT MR reply carries them (cold, MR cadence).
        Each rank only ever writes its OWN label — the relay MA
        pre-aggregation survival contract (common/straggler.py)."""
        self.rank = rank
        # Retire this rank's previous digest first: the hot set drifts
        # between publishes, and a stale (k, frame) child would
        # otherwise shadow the fresh one in every later extraction.
        _HOT.drop(rank=rank)
        for k, entry in enumerate(self.top_frames()):
            _HOT.set(entry["share"], rank=rank, k=k,
                     lane=entry["lane"], frame=entry["frame"])
        with self._lock:
            samples = self._samples
            tsamples = self._thread_samples
            blocking = self._blocking
            gil = self._gil_accum
        if tsamples:
            _BLOCKING.set(round(blocking / tsamples, 4), rank=rank)
        if samples:
            _GIL_WAIT.set(round(gil / samples, 4), rank=rank)


# ---------------------------------------------------------------------------
# module-level lifecycle + the digest extraction inverse
# ---------------------------------------------------------------------------

_PROFILER: Optional[SamplingProfiler] = None


def configure(enabled: bool = True, hz: Optional[float] = None,
              topk: Optional[int] = None):
    """(Re)arm the profiler: starts (or stops) the sampling thread.
    Hz/top-K are read freshly from the env unless pinned (drills sweep
    them per phase)."""
    global ENABLED, _PROFILER
    if not enabled:
        reset()
        return
    if _PROFILER is not None:
        _PROFILER.stop()
    _PROFILER = SamplingProfiler(hz=hz, topk=topk)
    _PROFILER.start()
    ENABLED = True
    logger.debug("profiler armed (%.1f Hz, top-%d)",
                 _PROFILER.hz, _PROFILER.topk)


def reset():
    """Disable the profiler and stop its thread (tests/drills)."""
    global ENABLED, _PROFILER
    ENABLED = False
    if _PROFILER is not None:
        _PROFILER.stop()
        _PROFILER = None


def instance() -> Optional[SamplingProfiler]:
    return _PROFILER


def set_rank(rank: int):
    """Stamp the owning rank (mirrors flight_recorder.set_rank)."""
    p = _PROFILER
    if p is not None:
        p.rank = rank


def publish_digest(rank: int):
    """Feeder site for the MR-reply path; gate on ENABLED there."""
    p = _PROFILER
    if p is not None:
        p.publish_digest(rank)


def trigger_capture(reason: str, detail: str = ""):
    """Feeder site for straggler/stall/SLO triggers; gate on ENABLED
    at the call site (one attribute check when disabled)."""
    p = _PROFILER
    if p is not None:
        p.capture(reason, detail)


def profile_dict() -> dict:
    """GET /profile payload; self-describing when disarmed."""
    p = _PROFILER
    if p is None:
        return {"enabled": False}
    return p.profile_dict()


def collapsed_text(profile: dict) -> str:
    """Render a /profile payload's collapsed stacks as flamegraph
    input lines (``stack count``, brendangregg collapsed format)."""
    lines = ["%s %d" % (stack, n)
             for stack, n in sorted(
                 (profile.get("collapsed") or {}).items())]
    return "\n".join(lines) + ("\n" if lines else "")


def digest_from_snapshot(snap: dict) -> Dict[int, List[dict]]:
    """Extract ``{rank: [{k, lane, frame, share}, ...]}`` (k-ordered)
    from a metrics snapshot (an MR reply, a relay MA aggregate, or the
    merged cluster view) — the inverse of publish_digest()'s
    rank-labeled gauges, the phases_from_snapshot shape."""
    out: Dict[int, List[dict]] = {}
    gauges = snap.get("gauges", {}) if isinstance(snap, dict) else {}
    children = gauges.get("hvd_prof_hot_share")
    if not isinstance(children, dict):
        return out
    for key, value in children.items():
        labels = dict(item.split("=", 1)
                      for item in key.split(",") if "=" in item)
        try:
            rank = int(labels["rank"])
            entry = {"k": int(labels["k"]), "lane": labels["lane"],
                     "frame": labels["frame"],
                     "share": float(value)}
        except (KeyError, ValueError, TypeError):
            continue
        out.setdefault(rank, []).append(entry)
    for rank in out:
        out[rank].sort(key=lambda e: e["k"])
    return out


def describe_digest(entries: Optional[List[dict]]) -> str:
    """One human root-cause clause from a rank's digest: the dominant
    frame + its lane/share — the text stall warnings and drill
    verdicts attach."""
    if not entries:
        return ""
    top = entries[0]
    return "%s (%s lane, %d%% of samples)" % (
        top.get("frame", "?"), top.get("lane", "?"),
        round(float(top.get("share", 0.0)) * 100))


# Arm from the environment at import: the knob rides the launcher env
# contract to every worker (the HOROVOD_FAILPOINTS precedent).
if _env.env_bool(_env.HOROVOD_PROFILE):
    configure(enabled=True)
