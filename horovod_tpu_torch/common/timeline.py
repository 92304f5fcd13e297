"""Chrome-tracing timeline writer, and the port's span recorder.

Mirrors the reference's Horovod Timeline (reference: timeline.{h,cc}:
TimelineWriter with a dedicated writer thread fed by a lock-free SPSC
queue :48-100; per-tensor state machine NEGOTIATING → TOP_LEVEL →
ACTIVITY :106-154; written on the coordinator rank only,
operations.cc:422-425; format documented in docs/timeline.rst).

Python implementation uses a queue.SimpleQueue (lock-free fast path on
CPython) + daemon writer thread.  The output is standard chrome://tracing
JSON, one async span per tensor keyed by a stable "tid" so collectives
stack per tensor name.  Device-side profiling is delegated to
``torch.profiler`` (see ``start_xla_trace``, named as in the JAX
package) — host spans here, device timeline there, matching the GPU
event-queue split in the reference.

Program spans (:func:`span`, read back by :func:`spans`) name what the
host was doing inside the port: ``hvd.init`` and its phases, the
models' forward and its parts, the flash kernel's host path, the
optimizer's ``synchronize`` and ``step``, and each tensor's negotiation
and collective with their fusion and backend calls.  A span records
while a ``torch.profiler`` session runs, while a :class:`Timeline` is
open, or when the site asks for it always; otherwise :func:`span`
returns one shared no-op.  Every timestamp here, the Timeline file's
included, is on :func:`now_us`'s clock, the wall clock that
``torch.profiler``'s Chrome traces convert to, so that spans, Timeline
events and device kernels lie on one axis; :func:`stop_xla_trace`
writes the spans of its window into the device trace it exports.
"""

import collections
import itertools
import json
import logging
import os
import queue
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

logger = logging.getLogger("horovod_tpu_torch.timeline")

# The recorder's clock: the monotonic counter, shifted once, at import,
# onto the wall clock.
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
# Closed spans kept in memory; older ones are dropped (and counted).
SPAN_CAPACITY = 1 << 16


def now_us() -> float:
    """Microseconds since the epoch, monotonic within the process."""
    return (time.perf_counter_ns() + _EPOCH_OFFSET_NS) / 1e3


class Span(NamedTuple):
    """One closed span; ``parent`` is the id of the innermost span open
    on the same thread when it began (0: none)."""
    name: str
    start_us: float
    end_us: float
    id: int
    parent: int
    thread: int
    attrs: dict


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("_rec", "_name", "_attrs", "_id", "_parent", "_start")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: dict):
        self._rec, self._name, self._attrs = rec, name, attrs

    def __enter__(self):
        stack = self._rec._stack()
        self._parent = stack[-1] if stack else 0
        self._id = next(self._rec._ids)
        stack.append(self._id)
        self._start = now_us()
        return self

    def __exit__(self, *exc):
        end = now_us()
        self._rec._stack().pop()
        self._rec._add(Span(self._name, self._start, end, self._id,
                            self._parent, threading.get_ident(),
                            self._attrs))
        return False


class SpanRecorder:
    """Closed spans in a buffer of ``capacity``, oldest dropped first
    (:attr:`dropped` counts them); a thread-local stack of open span ids
    gives each span its parent.  :meth:`begin`/:meth:`end` make a span
    that ends on another thread than it began on, keyed by the caller."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._buf = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._open: Dict[object, tuple] = {}
        self.dropped = 0

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, sp: Span):
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(sp)

    def span(self, name: str, attrs: dict) -> _OpenSpan:
        return _OpenSpan(self, name, attrs)

    def begin(self, key, name: str, attrs: dict):
        if len(self._open) >= self._buf.maxlen:
            with self._lock:
                self.dropped += 1
            return
        stack = self._stack()
        self._open[key] = (name, now_us(), next(self._ids),
                           stack[-1] if stack else 0,
                           threading.get_ident(), attrs)

    def end(self, key):
        got = self._open.pop(key, None)
        if got is not None:
            name, start, id_, parent, thread, attrs = got
            self._add(Span(name, start, now_us(), id_, parent, thread,
                           attrs))

    def spans(self, since: Optional[float] = None) -> List[Span]:
        with self._lock:
            out = list(self._buf)
        if since is not None:
            out = [s for s in out if s.start_us >= since]
        return out


_recorder = SpanRecorder()
_modules = sys.modules
_PROFILER, _FLAG = "torch.autograd.profiler", "_is_profiler_enabled"
# Open Timelines and running device traces: each keeps the recorder on.
_forced = 0
_forced_lock = threading.Lock()


def _force(delta: int):
    global _forced
    with _forced_lock:
        _forced += delta


def recording() -> bool:
    """Whether :func:`span` records now: a Timeline or a device trace is
    open, or a ``torch.profiler`` session runs (its module flag
    ``_is_profiler_enabled``; where a torch lacks it, only the first
    two count)."""
    return bool(_forced or getattr(_modules.get(_PROFILER), _FLAG, False))


def span(name: str, always: bool = False, **attrs):
    """``with span("gpt.block", layer=3): ...`` records the block's host
    time while :func:`recording`, or whenever ``always``; otherwise it
    is the shared no-op :data:`NO_SPAN`."""
    # recording(), inlined: this is the cost of every site while off.
    if always or _forced or getattr(_modules.get(_PROFILER), _FLAG, False):
        return _recorder.span(name, attrs)
    return NO_SPAN


def begin_span(key, name: str, **attrs):
    """Open a span that :func:`end_span` with the same ``key`` closes,
    on any thread (a tensor's negotiation, from its submission to its
    response); nothing unless :func:`recording`."""
    if recording():
        _recorder.begin(key, name, attrs)


def end_span(key):
    """Close :func:`begin_span`'s span of ``key``, if one is open."""
    _recorder.end(key)


def spans(since: Optional[float] = None) -> List[Span]:
    """The recorder's closed spans (those starting at or after ``since``,
    microseconds on :func:`now_us`'s clock, when given).  Neither
    ``hvd.init()`` nor ``hvd.shutdown()`` clears them."""
    return _recorder.spans(since)


def dropped() -> int:
    """Spans the recorder's buffer dropped, oldest first, when full."""
    return _recorder.dropped


class TimelineWriter:
    def __init__(self, file_path: str):
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._file_path = file_path
        self._active = True
        self._thread = threading.Thread(
            target=self._run, name="hvd-timeline-writer", daemon=True)
        self._thread.start()

    def enqueue(self, record: dict):
        if self._active:
            self._queue.put(record)

    def _run(self):
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self._file_path)),
                        exist_ok=True)
            with open(self._file_path, "w") as f:
                f.write("[\n")
                first = True
                while True:
                    rec = self._queue.get()
                    if rec is None:
                        break
                    if not first:
                        f.write(",\n")
                    f.write(json.dumps(rec))
                    first = False
                    f.flush()
                f.write("\n]\n")
        except Exception:
            # Without this flip a writer that cannot open (or keep
            # writing) its file dies silently while enqueue() keeps
            # growing the queue unbounded for the rest of the run.
            self._active = False
            logger.warning(
                "timeline writer failed for %s; timeline recording "
                "disabled", self._file_path, exc_info=True)

    def close(self):
        if self._active:
            self._active = False
            self._queue.put(None)
            self._thread.join(timeout=5.0)


class Timeline:
    """Per-tensor span state machine emitting chrome-tracing events,
    timestamped on :func:`now_us`'s clock.  While it is open, on every
    rank, the span recorder records."""

    def __init__(self, file_path: str, rank: int = 0,
                 mark_cycles: bool = False):
        self.rank = rank
        self.mark_cycles = mark_cycles
        self.writer = TimelineWriter(file_path) if rank == 0 else None
        self._tids: Dict[str, int] = {}
        self._next_tid = 1
        self._lock = threading.Lock()
        self._open = True
        _force(1)

    def _tid(self, tensor_name: str) -> int:
        with self._lock:
            tid = self._tids.get(tensor_name)
            if tid is None:
                tid = self._next_tid
                self._next_tid += 1
                self._tids[tensor_name] = tid
                if self.writer:
                    self.writer.enqueue({
                        "name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": tensor_name}})
            return tid

    def negotiate_start(self, tensor_name: str, request_type: str):
        self._emit_begin(tensor_name, f"NEGOTIATE_{request_type}")

    def negotiate_rank_ready(self, tensor_name: str, rank: int):
        if self.writer:
            self.writer.enqueue({
                "name": str(rank), "ph": "i", "pid": 0,
                "tid": self._tid(tensor_name), "ts": now_us(),
                "s": "t"})

    def negotiate_end(self, tensor_name: str):
        self._emit_end(tensor_name)

    def start_activity(self, tensor_name: str, activity: str):
        self._emit_begin(tensor_name, activity)

    def end_activity(self, tensor_name: str):
        self._emit_end(tensor_name)

    def counter(self, name: str, values: Dict[str, float]):
        """Chrome-tracing counter event ("ph":"C"): renders as a
        stacked-area track alongside the spans, so live registry values
        (queue depth, fused bytes) line up with negotiation/execution
        activity in the same trace."""
        if self.writer:
            self.writer.enqueue({
                "name": name, "ph": "C", "pid": 0, "tid": 0,
                "ts": now_us(), "args": dict(values)})

    def instant(self, name: str):
        """Process-scoped instant event (steady-state replay
        enter/exit marks and similar one-shot state flips)."""
        if self.writer:
            self.writer.enqueue({
                "name": name, "ph": "i", "pid": 0, "tid": 0,
                "ts": now_us(), "s": "p"})

    def mark_cycle_start(self):
        if self.writer and self.mark_cycles:
            self.writer.enqueue({
                "name": "CYCLE_START", "ph": "i", "pid": 0, "tid": 0,
                "ts": now_us(), "s": "g"})

    def _emit_begin(self, tensor_name: str, name: str):
        if self.writer:
            self.writer.enqueue({
                "name": name, "ph": "B", "pid": 0,
                "tid": self._tid(tensor_name), "ts": now_us()})

    def _emit_end(self, tensor_name: str):
        if self.writer:
            self.writer.enqueue({
                "ph": "E", "pid": 0, "tid": self._tid(tensor_name),
                "ts": now_us()})

    def close(self):
        if self._open:
            self._open = False
            _force(-1)
        if self.writer:
            self.writer.close()
            self.writer = None


# The running device trace of start_xla_trace: (profiler, log_dir,
# whether it traces the card).
_device_trace = None
_device_trace_lock = threading.Lock()
# Host seconds a trace of the card waits after it starts and before it
# stops.  The profiler keeps a device event only when its time, taken
# on the card and converted to the host's clock, falls inside the
# window; work at either edge of it (one kernel launched as the trace
# starts and synchronized just before it stops) then came back, now
# and then, without its device event.  The margins keep the traced work
# well inside the window.
DEVICE_WINDOW_MARGIN_S = 0.01


def start_xla_trace(log_dir: str):
    """Start the device profiler alongside the host timeline: a
    ``torch.profiler`` trace of the CPU and, where there is one, the
    CUDA card, which :func:`stop_xla_trace` writes into ``log_dir`` as a
    Chrome trace (chrome://tracing, Perfetto).  The JAX package's name
    and contract (there ``jax.profiler``): a second start before a stop
    raises.  Complements host spans the way the reference's GPU event
    queue does (ops/gpu_operations.h:110-119).  On the card the window
    opens :data:`DEVICE_WINDOW_MARGIN_S` before this returns."""
    global _device_trace
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    with _device_trace_lock:
        if _device_trace is not None:
            raise RuntimeError("a device trace is already running "
                               f"(into {_device_trace[1]})")
        wanted = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
        activities = [a for a in wanted if a in supported_activities()]
        on_card = ProfilerActivity.CUDA in activities and \
            torch.cuda.is_available()
        prof = profile(activities=activities)
        prof.start()
        _force(1)
        t0 = now_us()
        if on_card:
            time.sleep(DEVICE_WINDOW_MARGIN_S)
        _device_trace = (prof, log_dir, on_card, t0)


def stop_xla_trace() -> str:
    """Stop the trace :func:`start_xla_trace` began and write it; returns
    the path of the Chrome trace (``<host>.<pid>.<ms>.pt.trace.json`` in
    its ``log_dir``).  Raises when no trace is running.

    ``torch.profiler``'s export is kept but for its metadata events
    without ``args.name`` (``process_labels``, ``process_sort_index``,
    ``thread_sort_index``: a viewer's labels and ordering), which the
    repository's trace rules refuse (every ``M`` event names its process
    or thread: ``tools/validate_trace``).  The program spans that began
    inside the window are added as ``X`` events of a process named
    ``horovod rank <r>`` (:func:`_span_events`)."""
    global _device_trace
    import socket
    with _device_trace_lock:
        if _device_trace is None:
            raise RuntimeError("no device trace is running "
                               "(start_xla_trace was not called)")
        prof, log_dir, on_card, t0 = _device_trace
        _device_trace = None
        if on_card:
            # Every kernel enqueued inside the window finishes, and the
            # window closes a margin after the last one.
            import torch
            torch.cuda.synchronize()
            time.sleep(DEVICE_WINDOW_MARGIN_S)
        prof.stop()
        _force(-1)
        window = [sp for sp in spans(t0) if sp.end_us <= now_us()]
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "%s.%d.%d.pt.trace.json" % (
            socket.gethostname(), os.getpid(), int(time.time() * 1e3)))
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] = [
            e for e in trace["traceEvents"] if e.get("ph") != "M" or
            "name" in (e.get("args") or {})]
        from .basics import _state
        trace["traceEvents"] += _span_events(
            window, trace.get("baseTimeNanoseconds", 0) / 1e3,
            _state().rank_info.rank,
            {e.get("pid") for e in trace["traceEvents"]})
        with open(path, "w") as f:
            json.dump(trace, f)
        return path


def _span_events(window: List[Span], base_us: float, rank: int,
                taken_pids=()) -> list:
    """Chrome-trace events of ``window``: one ``X`` event a span, its
    ``ts`` counted from ``base_us`` (a trace's ``baseTimeNanoseconds``
    in microseconds), with its attributes, id and parent as ``args``,
    on a lane a thread, in a process (a pid not in ``taken_pids``)
    named ``horovod rank <rank>``."""
    if not window:
        return []
    pid = 1 + max([p for p in taken_pids if isinstance(p, int)] or [0])
    names = {t.ident: t.name for t in threading.enumerate()}
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": f"horovod rank {rank}"}}]
    for tid in sorted({sp.thread for sp in window}):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": names.get(tid, str(tid))}})
    for sp in window:
        events.append({"name": sp.name, "ph": "X", "cat": "horovod",
                       "pid": pid, "tid": sp.thread,
                       "ts": sp.start_us - base_us,
                       "dur": sp.end_us - sp.start_us,
                       "args": dict(sp.attrs, id=sp.id,
                                    parent=sp.parent)})
    return events
