"""Runtime lock-order witness: deadlock hazards caught without the
deadlock.

The runtime half of the hvdlint suite (docs/static_analysis.md): the
static analyzers can prove a wait is bounded, but lock *ordering* is a
dynamic property — an ABBA inversion only exists on the interleaving
the scheduler happened to produce.  The witness makes every
interleaving count: while enabled, ``threading.Lock``/``RLock``
objects created by ``horovod_tpu`` code are wrapped, every
cross-lock acquisition edge (thread holds A, acquires B) is recorded
into a process-wide directed graph, and a cycle — the classic
watchdog/witness criterion from FreeBSD's ``witness(4)`` and the
TSAN lock-order-inversion detector the reference core relies on —
is reported *the first time both orders have ever been observed*,
whether or not the schedule actually deadlocked.

What a finding names (the postmortem contract of PR 9): both lock
creation sites (file:line), the acquisition stacks that witnessed
each edge of the cycle, and the threads involved.

Design constraints (the repo's standing instrumentation contract):

  * **one attribute check when disabled** — a wrapped lock's acquire
    is ``inner.acquire(...)`` plus ``if ENABLED:``; the perf pin in
    tests/test_lockwitness.py asserts it, exactly like failpoints and
    the flight recorder.  With the witness never enabled, *nothing*
    is wrapped and the cost is zero.
  * **opt-in** — ``HOROVOD_LOCKWITNESS=1`` arms it at ``hvd.init``;
    the ``lock_witness`` pytest fixture (tests/conftest.py) arms it
    around the chaos smoke and replay e2e suites and fails the test
    on any cycle.
  * **no wire or disk footprint** — pure in-memory graph, bounded by
    the number of locks created while armed (each wrapper is pinned
    so id()-keyed graph nodes can never alias a recycled address)
    plus the distinct lock pairs; ``reset()`` drops it all.

Scope and honesty notes:

  * Only locks *created while enabled* by code whose immediate caller
    lives under the configured package filter are wrapped (module-
    level locks created at import ride outside the window; the
    control-plane objects tests construct inside the window are the
    point).
  * ``threading.Condition()``'s internal ``RLock()`` is created from
    ``threading.py`` and is deliberately NOT wrapped (Conditions use
    private lock internals a wrapper must not break).
  * A cycle is reported when its edges were witnessed from at least
    ``MIN_THREADS`` (2) distinct threads — a single thread taking
    A→B then B→A after releasing cannot deadlock itself, but the
    same two orders split across threads can.
"""

import os
import sys
import threading
import traceback
from typing import Dict, List, Optional, Tuple

ENV_ENABLE = "HOROVOD_LOCKWITNESS"

# Frames belonging to the witness itself and to threading internals,
# skipped when attributing lock creations/acquisitions to caller
# code.  Exact paths, not suffixes — a user file named
# test_lockwitness.py must NOT be skipped.
_SELF_FILE = os.path.abspath(__file__).rstrip("co")  # .pyc -> .py
_THREADING_FILE = os.path.abspath(
    threading.__file__).rstrip("co")


def _is_internal_frame(filename: str) -> bool:
    f = os.path.abspath(filename).rstrip("co")
    return f == _SELF_FILE or f == _THREADING_FILE

# THE disabled-path gate: every wrapped acquire/release checks this
# one module attribute before any graph work.  enable()/disable() are
# the only writers.
ENABLED = False

# Cycle policy: edges of a reported cycle must come from at least
# this many distinct threads (see module docstring).
MIN_THREADS = 2

_STACK_LIMIT = 12          # frames kept per witnessing stack

_state_lock = threading.Lock()
# The REAL factories, captured at import and never cleared: a factory
# reference captured while patched must keep working after disable().
_orig_lock = threading.Lock
_orig_rlock = threading.RLock
_patched = False           # are threading.Lock/RLock our factories?
_package_filter = "horovod_tpu"

# lock ident (int) -> creation site "file:line"
_sites: Dict[int, str] = {}
# ident -> the wrapper itself (strong refs: id() keys must never be
# reused by the allocator while the graph holds edges naming them)
_live: Dict[int, object] = {}
# (a_ident, b_ident) -> mutable edge record {a_site, b_site,
# threads: set of witnessing thread names, stack: first witness}
_edges: Dict[Tuple[int, int], dict] = {}
# adjacency for cycle search: a_ident -> [b_ident, ...]
_succ: Dict[int, List[int]] = {}
# recorded findings: list of dicts (see _report_cycle)
_violations: List[dict] = []

# Armed-window generation: bumped by every enable().  Thread-local
# held/depth state is stamped with the generation it was written in
# and discarded when a new window starts — a thread that released a
# witnessed lock while DISABLED (release bookkeeping is skipped to
# keep the one-attribute-check contract) would otherwise carry stale
# held entries into the next armed window and fabricate edges there.
_gen = 0

_tls = threading.local()   # .held, .depth, .gen


def _held() -> List[int]:
    if getattr(_tls, "gen", None) != _gen:
        _tls.held, _tls.depth, _tls.gen = [], {}, _gen
    return _tls.held


def _depths() -> Dict[int, int]:
    if getattr(_tls, "gen", None) != _gen:
        _tls.held, _tls.depth, _tls.gen = [], {}, _gen
    return _tls.depth


# The stack walks below start at their own frame and skip this module's
# frames: ``traceback.walk_stack(None)`` starts several frames above its
# caller on Python 3.12, which named the wrong creation site and let the
# filter judge the wrong frame.
def _creation_site() -> str:
    """file:line of the nearest stack frame outside this module and
    outside threading.py — the code that asked for the lock."""
    for frame, lineno in traceback.walk_stack(sys._getframe()):
        fn = frame.f_code.co_filename
        if _is_internal_frame(fn):
            continue
        return "%s:%d" % (fn, lineno)
    return "<unknown>"


def _witness_stack() -> str:
    out = []
    for frame, lineno in traceback.walk_stack(sys._getframe()):
        fn = frame.f_code.co_filename
        if _is_internal_frame(fn):
            continue
        out.append("%s:%d %s" % (fn, lineno, frame.f_code.co_name))
        if len(out) >= _STACK_LIMIT:
            break
    return " <- ".join(out)


def _find_path(start: int, goal: int) -> Optional[List[int]]:
    """DFS in the edge graph (caller holds _state_lock)."""
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == goal:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in _succ.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _report_cycle(path: List[int], closing_edge_stack: str) -> None:
    """``path`` is B..A for a new edge A->B that closed a cycle
    (caller holds _state_lock)."""
    edge_reports = []
    threads = set()
    nodes = path + [path[0]]
    for a, b in zip(nodes, nodes[1:]):
        ent = _edges[(a, b)]
        threads.update(ent["threads"])
        edge_reports.append({
            "from_site": ent["a_site"], "to_site": ent["b_site"],
            "thread": "/".join(sorted(ent["threads"])),
            "stack": ent["stack"],
        })
    if len(threads) < MIN_THREADS:
        return
    key = tuple(sorted(_sites.get(n, "?") for n in path))
    for v in _violations:
        if v["key"] == key:
            return   # already reported this site cycle
    _violations.append({
        "key": key,
        "sites": [_sites.get(n, "?") for n in path],
        "edges": edge_reports,
        "closing_stack": closing_edge_stack,
    })


def _note_acquired(ident: int) -> None:
    depths = _depths()
    if depths.get(ident, 0) > 0:
        depths[ident] += 1      # reentrant re-acquire: no new edge
        return
    depths[ident] = 1
    held = _held()
    if held:
        holder = held[-1]
        if holder != ident:
            edge = (holder, ident)
            tname = threading.current_thread().name
            # Warm-path fast exit: a repeat acquisition in the same
            # order BY A THREAD ALREADY ON THE EDGE pays two dict
            # probes, not a 12-frame stack walk.  A new thread on a
            # known edge re-runs the cycle check — a cycle first
            # suppressed by MIN_THREADS (single-thread inversion)
            # must surface the moment a second thread proves it
            # cross-thread (benign race: one redundant capture).
            ent = _edges.get(edge)
            if ent is None:
                stack = _witness_stack()
                with _state_lock:
                    ent = _edges.get(edge)
                    if ent is None:
                        _edges[edge] = {
                            "a_site": _sites.get(holder, "?"),
                            "b_site": _sites.get(ident, "?"),
                            "threads": {tname}, "stack": stack,
                        }
                        _succ.setdefault(holder, []).append(ident)
                        # Did ident -> ... -> holder already exist?
                        # Then this new edge closes a cycle.
                        path = _find_path(ident, holder)
                        if path is not None:
                            _report_cycle(path, stack)
                    else:
                        ent["threads"].add(tname)
            elif tname not in ent["threads"]:
                stack = _witness_stack()
                with _state_lock:
                    ent["threads"].add(tname)
                    path = _find_path(ident, holder)
                    if path is not None:
                        _report_cycle(path, stack)
    held.append(ident)


def _note_released(ident: int, all_depths: bool = False) -> None:
    depths = _depths()
    n = depths.get(ident, 0)
    if n > 1 and not all_depths:
        depths[ident] = n - 1
        return
    depths.pop(ident, None)
    held = _held()
    # Out-of-order release is legal (lock A released while B is
    # held): remove by value, not by stack pop.
    for i in range(len(held) - 1, -1, -1):
        if held[i] == ident:
            del held[i]
            break


class _WitnessLock:
    """Wrapper around a real lock: acquire/release bracketed by graph
    bookkeeping behind the ENABLED gate."""

    __slots__ = ("_inner", "_ident", "site")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._ident = id(self)
        self.site = site
        with _state_lock:
            # The registry entry doubles as a STRONG reference: graph
            # nodes are keyed by id(), so a GC'd wrapper whose address
            # CPython reuses for a new lock would alias stale edges
            # and fabricate phantom cycles.  reset() drops them.
            _sites[self._ident] = site
            _live[self._ident] = self

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok and ENABLED:
            _note_acquired(self._ident)
        return ok

    def release(self):
        if ENABLED:
            _note_released(self._ident)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "<WitnessLock %s of %r>" % (self.site, self._inner)


class _WitnessRLock(_WitnessLock):
    """RLock variant: per-thread depth counting in _note_acquired
    keeps reentrant re-acquires from self-edging the graph.

    It also forwards the private protocol ``threading.Condition``
    drives (``_is_owned`` / ``_release_save`` / ``_acquire_restore``)
    — without these, a witnessed RLock handed to ``Condition(...)``
    (e.g. ``ElasticDriver``'s assignment condition) would fall back
    to Condition's non-reentrant shims: ``acquire(False)`` succeeds
    reentrantly so the fallback ``_is_owned`` mis-reports not-owned
    and ``wait()`` raises on a correctly-held lock."""

    def locked(self):  # RLocks have no .locked() before 3.12
        fn = getattr(self._inner, "locked", None)
        return fn() if fn is not None else None

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        # Condition.wait: ALL recursion levels release at once.  The
        # witness depth rides along in the opaque state so a
        # reentrantly-held lock (depth >= 2) is restored at its TRUE
        # depth — otherwise the inner `with` block's release() after
        # wait() would drop the lock from the held list one release
        # early and hazard edges in that window would be lost.
        wdepth = 0
        if ENABLED:
            wdepth = _depths().get(self._ident, 0)
            _note_released(self._ident, all_depths=True)
        return (self._inner._release_save(), wdepth)

    def _acquire_restore(self, state):
        inner_state, wdepth = state
        self._inner._acquire_restore(inner_state)
        if ENABLED:
            _note_acquired(self._ident)
            if wdepth > 1:
                _depths()[self._ident] = wdepth


def _caller_wants_witness() -> bool:
    """True when the frame that called threading.Lock()/RLock() lives
    under the package filter (skipping threading.py itself, so
    Condition/Event internals stay unwrapped)."""
    for frame, _ in traceback.walk_stack(sys._getframe()):
        fn = os.path.abspath(frame.f_code.co_filename).rstrip("co")
        if fn == _SELF_FILE:
            continue
        if fn == _THREADING_FILE:
            # Immediate creator is threading internals (Condition /
            # Event building their own RLock): never wrap those.
            return False
        return _package_filter in frame.f_code.co_filename
    return False


def _lock_factory():
    if ENABLED and _caller_wants_witness():
        return _WitnessLock(_orig_lock(), _creation_site())
    return _orig_lock()


def _rlock_factory():
    if ENABLED and _caller_wants_witness():
        return _WitnessRLock(_orig_rlock(), _creation_site())
    return _orig_rlock()


def enable(package_filter: str = "horovod_tpu") -> None:
    """Patch threading.Lock/RLock so locks created by ``horovod_tpu``
    code (while enabled) are witnessed.  Idempotent."""
    global ENABLED, _patched, _package_filter, _gen
    with _state_lock:
        _package_filter = package_filter
        # New armed window: invalidate every thread's held/depth TLS
        # (see _gen above — releases skipped while disabled must not
        # leak held state into this window).
        _gen += 1
        if not _patched:
            threading.Lock = _lock_factory
            threading.RLock = _rlock_factory
            _patched = True
    ENABLED = True


def disable() -> None:
    """Restore threading.Lock/RLock and stop recording.  Existing
    wrapped locks keep working (their acquire degrades to the one
    attribute check), and a factory reference captured while armed
    (``from threading import Lock`` in a lazily-imported module)
    keeps producing raw locks — the originals stay bound forever."""
    global ENABLED, _patched
    ENABLED = False
    with _state_lock:
        if _patched:
            threading.Lock = _orig_lock
            threading.RLock = _orig_rlock
            _patched = False


def reset() -> None:
    """Drop the recorded graph and findings (fixture teardown)."""
    with _state_lock:
        _sites.clear()
        _live.clear()
        _edges.clear()
        _succ.clear()
        del _violations[:]


def cycles() -> List[dict]:
    """The recorded lock-order cycles (each: sites, edges with
    witnessing thread + stack, closing stack)."""
    with _state_lock:
        return list(_violations)


def edge_count() -> int:
    with _state_lock:
        return len(_edges)


def render_cycle(v: dict) -> str:
    lines = ["lock-order cycle between %d lock(s):" % len(v["sites"])]
    for site in v["sites"]:
        lines.append("  lock created at %s" % site)
    for e in v["edges"]:
        lines.append("  edge %s -> %s  [thread %s]" %
                     (e["from_site"], e["to_site"], e["thread"]))
        lines.append("    witnessed: %s" % e["stack"])
    return "\n".join(lines)


def assert_no_cycles() -> None:
    """Raise AssertionError naming every recorded cycle (the fixture
    and chaos-smoke gate)."""
    found = cycles()
    if found:
        raise AssertionError(
            "lock-order witness found %d cycle(s):\n%s" % (
                len(found),
                "\n\n".join(render_cycle(v) for v in found)))


def maybe_enable_from_env() -> bool:
    """Arm from HOROVOD_LOCKWITNESS (called by hvd.init)."""
    from . import env as _env
    if _env.env_bool(ENV_ENABLE):
        enable()
        return True
    return False
