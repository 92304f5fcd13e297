"""Black-box flight recorder: bounded ring of typed control-plane events.

The forensic layer the live metrics registry (counters: *how many*) and
the per-rank Timeline (local spans: *how long*) cannot provide: when a
rank is promoted to lost, a relay dies mid-negotiation, or a stall
shutdown fires, the question is *which hop dropped frame N, what did
the leaf see, and where did the recovery time actually go* — evidence
that is gone by the time anyone looks unless it was being recorded all
along.  Following the PyTorch NCCL flight recorder and the Dapper
lineage (PAPERS.md), every process keeps a fixed-size in-memory ring
of typed events recorded from the hot paths:

  * frame send/recv on the coordinator, worker and relay links (kind,
    session, implicit stream ordinal, byte size, peer);
  * liveness traffic: HB heartbeats, suppression, silent-peer
    promotions;
  * the reconnecting channel: limbo entry, resume handshakes (WE),
    refusals, grace expiry;
  * relay attach / re-home hops / epoch bumps / subtree loss;
  * steady-state replay enter/exit with the exit reason;
  * checkpoint prepare/commit/restore phases;
  * elastic transitions (epoch plans, lost-rank evictions);
  * failpoint triggers (the chaos schedule, in causal position);
  * eager submissions (tensor name + type — the per-collective record
    the NCCL flight recorder keeps, feeding stall attribution).

Design constraints (this sits ON the frame and submit hot paths):

  * one attribute check when disabled — every site is written as

        if flight_recorder.ENABLED:
            flight_recorder.record(...)

    exactly the failpoints/liveness precedent, asserted by
    tests/test_flight_recorder.py;
  * bounded — a ``collections.deque(maxlen=N)`` ring: a week-long run
    holds the same memory as a one-minute run, eviction is O(1);
  * lock-light — an append is a tuple build + deque.append (atomic
    under the GIL); no lock is taken on the record path;
  * dependency-free — stdlib only, importable before anything else in
    the package.

Events carry BOTH clocks (``time.monotonic`` for intra-process
ordering, ``time.time`` for cross-rank merging) plus the identifiers
the control plane already has — session id, implicit frame ordinal,
connection generation/epoch — so the cross-rank merge needs NO wire
format change: ``tools/blackbox_merge.py`` aligns per-rank clocks from
HB round-trips and matches frames by (session, ordinal).

Dump triggers (per-rank JSON under ``HOROVOD_BLACKBOX_DIR``):
lost-rank promotion, stall shutdown, fatal unwind, SIGUSR2, chaos
drill end — plus an HMAC-guarded ``/blackbox`` handler next to the
Prometheus endpoint (common/metrics.py) for live extraction.

Enabling: set ``HOROVOD_BLACKBOX=1`` (ring only; dump via SIGUSR2 or
/blackbox) or ``HOROVOD_BLACKBOX_DIR=/path`` (ring + automatic dumps
on the triggers above).  The chaos/MTTR drills arm it themselves.
"""

import collections
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from . import env as _env

logger = logging.getLogger("horovod_tpu_torch.blackbox")

ENV_ENABLE = "HOROVOD_BLACKBOX"
ENV_DIR = "HOROVOD_BLACKBOX_DIR"
ENV_CAPACITY = "HOROVOD_BLACKBOX_EVENTS"
DEFAULT_CAPACITY = 8192

# --- typed event kinds ----------------------------------------------------
# Wire plane
FRAME_TX = "frame_tx"        # kind, nbytes, seq?, peer?, sess?
FRAME_RX = "frame_rx"        # kind, nbytes, seq?, peer?, sess?
HB_TX = "hb_tx"              # role; a liveness heartbeat left this node
HB_RX = "hb_rx"              # peer; a heartbeat arrived
# Liveness / reconnect
PROMOTE = "promote"          # peer, clean, reason — rank promoted lost
LIMBO = "limbo"              # peer — link parked awaiting resume
RESUME = "resume"            # peer?, outcome, replayed?, sess?
REGISTER = "register"        # peer, sess, cycle — fresh link
WEDGE = "wedge"              # liveness-silent peer observed
# Relay tree
RELAY_ATTACH = "relay_attach"    # relay, depth, gen
RELAY_DOWN = "relay_down"        # relay, reason, subtree
RELAY_LOST = "relay_lost"        # relay, kind, ranks — RL notice
REHOME = "rehome"                # hop, outcome — leaf climbed its chain
# Replay
REPLAY = "replay"            # phase=enter/exit, reason?, batches?
# Autotune-then-freeze (horovod_tpu/tune): lifecycle transitions +
# knob proposals, so a postmortem shows WHICH phase the search was in
# (and which knobs were live) when a drill killed a rank mid-search.
TUNE = "tune"                # phase=search/propose/frozen/aborted
# Checkpoint
CKPT = "ckpt"                # phase, step, outcome?
# Online serving plane (horovod_tpu/serve): snapshot flips — every
# atomic swap of the served snapshot records WHICH committed step went
# live and how (bootstrap / incremental delta apply / full rebase), so
# a postmortem can line the read path's freshness up against the
# trainer's commit timeline.
SERVE = "serve"              # phase=flip, step, mode, tables?
# Elastic
ELASTIC = "elastic"          # event, epoch?, rank?
# Closed-loop elasticity (runner/elastic/policy.py): typed resize
# events, so a postmortem verdict can NAME the resize trigger
# (scale-up discovery / straggler migration / death) from the events
# alone — tools/blackbox_merge.py maps these to verdict triggers.
ELASTIC_SCALE_UP = "elastic_scale_up"  # hosts, slots, epoch, trigger
ELASTIC_MIGRATE = "elastic_migrate"    # rank, host?, score, phase
# Fault plane
FAILPOINT = "failpoint"      # site, action
FATAL = "fatal"              # error — this rank's world broke
STALL = "stall"              # tensor, missing — stall machinery fired
STRAGGLER = "straggler"      # peer, score — rank crossed the slow
                             # threshold (common/straggler.py)
SUBMIT = "submit"            # name, type — one eager collective
# Why-is-it-slow plane (common/profiler.py, common/slo.py): triggered
# profile captures carry the dominant frames at the moment a symptom
# (straggler flag / stall / SLO burn) fired; SLO_BURN marks the
# multi-window burn-rate crossing itself.
PROFILE = "profile"          # rank?, reason, detail?, frames
SLO_BURN = "slo_burn"        # sli, short, long, target — burn alert
NOTE = "note"                # harness / drill markers (drill.fault ...)

_VERSION = 1

# THE disabled-path gate: every site checks this one module attribute
# before anything else.  configure()/reset() are the only writers.
ENABLED = False

_lock = threading.Lock()          # guards configuration + dumps only
_ring: "collections.deque" = collections.deque(maxlen=DEFAULT_CAPACITY)
_capacity = DEFAULT_CAPACITY
_dir: Optional[str] = None
_rank: Optional[object] = None    # default tag for untagged events
_dump_counter = 0
_last_dump: Dict[str, float] = {}  # reason -> monotonic of last dump
_DUMP_THROTTLE_S = 2.0
_sigusr2_installed = False


def configure(directory: Optional[str] = None,
              capacity: Optional[int] = None,
              enabled: bool = True):
    """(Re)arm the recorder.  ``directory`` enables automatic dumps on
    the failure triggers; without it the ring still records and can be
    extracted via SIGUSR2 (cwd), /blackbox, or an explicit dump()."""
    global ENABLED, _ring, _capacity, _dir
    with _lock:
        if capacity is not None and capacity != _capacity:
            _capacity = max(16, int(capacity))
            _ring = collections.deque(_ring, maxlen=_capacity)
        if directory is not None:
            _dir = directory or None
        ENABLED = bool(enabled)
    if enabled:
        logger.debug("flight recorder armed (capacity=%d, dir=%s)",
                     _capacity, _dir)


def reset():
    """Disable and drop all events (tests/drill teardown)."""
    global ENABLED, _ring, _dir, _rank
    with _lock:
        ENABLED = False
        _ring = collections.deque(maxlen=_capacity)
        _dir = None
        _rank = None
        _last_dump.clear()


def set_rank(rank):
    """Default rank tag for events recorded without an explicit one
    (wired from hvd.init, the failpoints.set_rank precedent)."""
    global _rank
    _rank = rank


def record(kind: str, rank=None, **fields):
    """Append one typed event.  Callers gate on ``ENABLED`` first so
    the disabled cost is one attribute check; the enabled cost is a
    tuple build + deque.append (no lock, bounded ring)."""
    _ring.append((time.monotonic(), time.time(),
                  kind, _rank if rank is None else rank, fields))


def note(kind: str, mono: Optional[float] = None,
         wall: Optional[float] = None, **fields):
    """Harness-level marker (drill fault fired, first post-restore
    step...).  ``mono``/``wall`` override the stamp so a harness can
    record an instant it measured earlier at its true position.
    Gated like record(): a disarmed recorder takes no markers — a
    stale ``drill.fault`` surviving into a later armed session would
    anchor an unrelated postmortem's span breakdown."""
    if not ENABLED:
        return
    now_m, now_w = time.monotonic(), time.time()
    m = now_m if mono is None else mono
    # Keep the two clocks consistent when only mono is overridden.
    w = wall if wall is not None else now_w - (now_m - m)
    _ring.append((m, w, NOTE, "harness", dict(fields, note=kind)))


def events(rank=None) -> List[tuple]:
    """Snapshot of the ring (oldest first), optionally filtered by
    rank tag."""
    snap = list(_ring)
    if rank is None:
        return snap
    return [e for e in snap if e[3] == rank]


def recent_for_tensors(names, n: int = 8) -> List[dict]:
    """The last ``n`` events mentioning any of ``names`` (stall
    attribution: a warning names WHAT the implicated tensors last did,
    not just which ranks are missing)."""
    wanted = set(names)
    out = []
    for ev in reversed(list(_ring)):
        f = ev[4]
        if f.get("name") in wanted or f.get("tensor") in wanted:
            out.append(_event_dict(ev))
            if len(out) >= n:
                break
    out.reverse()
    return out


def _event_dict(ev: tuple) -> dict:
    mono, wall, kind, rank, fields = ev
    # Reserved keys win: a payload field named "kind"/"rank" (e.g. a
    # wire-frame kind — call sites use "frame" for that) must never
    # clobber the event's own type or origin in the dump.
    d = dict(fields)
    d.update({"mono": mono, "wall": wall, "kind": kind, "rank": rank})
    return d


def _rank_tags(snap) -> List[object]:
    tags = []
    for ev in snap:
        if ev[3] not in tags:
            tags.append(ev[3])
    return tags


def dump_dict(rank=None, reason: str = "manual",
              snap: Optional[List[tuple]] = None) -> dict:
    """One rank's dump as a JSON-ready dict — THE dump schema, shared
    by the per-file writer below and the /blackbox HTTP payload so the
    two can never drift.  ``snap`` lets dump() reuse one ring snapshot
    across every rank tag's file."""
    if snap is None:
        snap = events(rank)
    return {
        "version": _VERSION,
        "reason": reason,
        "rank": rank if rank is not None else _rank,
        "pid": os.getpid(),
        "mono_at_dump": time.monotonic(),
        "wall_at_dump": time.time(),
        "events": [_event_dict(e) for e in snap],
    }


def dump(reason: str, directory: Optional[str] = None,
         throttle: bool = False) -> List[str]:
    """Write per-rank JSON dumps and return the paths.  One file per
    distinct rank tag in the ring: a real multi-process job holds only
    its own rank's events; the in-process chaos harness holds every
    thread-rank's, and each gets its own file so the merge sees the
    same shape either way.  ``throttle`` limits repeat dumps for one
    reason (promotion storms) to one per few seconds."""
    global _dump_counter
    with _lock:
        target = directory or _dir
        if not target:
            return []
        now = time.monotonic()
        if throttle and now - _last_dump.get(reason, -1e9) < \
                _DUMP_THROTTLE_S:
            return []
        _last_dump[reason] = now
        _dump_counter += 1
        serial = _dump_counter
        snap = list(_ring)
    paths = []
    try:
        os.makedirs(target, exist_ok=True)
        for tag in _rank_tags(snap):
            body = dump_dict(rank=tag, reason=reason,
                             snap=[e for e in snap if e[3] == tag])
            path = os.path.join(
                target, "blackbox-rank%s-%s-%d.json"
                % (tag, reason.replace("/", "_"), serial))
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f)
            os.replace(tmp, path)
            paths.append(path)
    except OSError:
        logger.warning("flight-recorder dump to %s failed", target,
                       exc_info=True)
    if paths:
        logger.info("flight recorder dumped %d file(s) to %s (%s)",
                    len(paths), target, reason)
    return paths


def trigger_dump(reason: str):
    """Failure-path hook (promotion, stall shutdown, fatal unwind):
    dump if a directory is configured, never raise, throttle storms."""
    try:
        dump(reason, throttle=True)
    except Exception:
        logger.warning("flight-recorder trigger %s failed", reason,
                       exc_info=True)


def install_signal_handler():
    """SIGUSR2 → dump (the classic black-box extraction signal).  Only
    possible from the main thread; callers on other threads get a
    debug log, not an error."""
    global _sigusr2_installed
    if _sigusr2_installed:
        return True
    try:
        import signal

        def _handler(signum, frame):
            # NEVER dump inline: the handler runs on the main thread
            # between bytecodes, and dump() takes the non-reentrant
            # module lock — a signal landing while the main thread
            # itself holds it (fatal-path trigger_dump, back-to-back
            # SIGUSR2) would deadlock the process.  A short-lived
            # thread acquires the lock like any other caller.
            threading.Thread(target=trigger_dump, args=("sigusr2",),
                             name="hvd-blackbox-sigusr2",
                             daemon=True).start()

        signal.signal(signal.SIGUSR2, _handler)
        _sigusr2_installed = True
        return True
    except (ValueError, OSError, AttributeError):
        # Non-main thread, or a platform without SIGUSR2.
        logger.debug("SIGUSR2 dump handler not installed",
                     exc_info=True)
        return False


# Arm from the environment at import: the knobs ride the launcher env
# contract to every worker, so one setting on the driver arms the job
# (the HOROVOD_FAILPOINTS precedent).
_env_dir = _env.env_str_opt(ENV_DIR)
_env_on = _env.env_bool(ENV_ENABLE)
if _env_dir or _env_on:
    _cap = _env.env_int(ENV_CAPACITY, DEFAULT_CAPACITY)
    configure(directory=_env_dir, capacity=_cap, enabled=True)
