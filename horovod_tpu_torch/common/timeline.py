"""Chrome-tracing timeline writer.

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
"""

import json
import logging
import os
import queue
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger("horovod_tpu_torch.timeline")

# Activity names, matching the reference span vocabulary (common.h:32-62).
NEGOTIATE_ALLREDUCE = "NEGOTIATE_ALLREDUCE"
NEGOTIATE_ALLGATHER = "NEGOTIATE_ALLGATHER"
NEGOTIATE_BROADCAST = "NEGOTIATE_BROADCAST"
NEGOTIATE_ALLTOALL = "NEGOTIATE_ALLTOALL"
WAIT_FOR_DATA = "WAIT_FOR_DATA"
WAIT_FOR_OTHER_TENSOR_DATA = "WAIT_FOR_OTHER_TENSOR_DATA"
FUSE_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
UNFUSE_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
XLA_ALLREDUCE = "XLA_ALLREDUCE"
XLA_ALLGATHER = "XLA_ALLGATHER"
XLA_BROADCAST = "XLA_BROADCAST"
XLA_ALLTOALL = "XLA_ALLTOALL"
XLA_REDUCESCATTER = "XLA_REDUCESCATTER"
XLA_COMPILE = "XLA_COMPILE"
ADASUM_VHDD = "ADASUM_VHDD"
QUEUE = "QUEUE"


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
    """Per-tensor span state machine emitting chrome-tracing events."""

    def __init__(self, file_path: str, rank: int = 0,
                 mark_cycles: bool = False):
        self.rank = rank
        self.mark_cycles = mark_cycles
        self.writer = TimelineWriter(file_path) if rank == 0 else None
        self._tids: Dict[str, int] = {}
        self._next_tid = 1
        self._lock = threading.Lock()
        self._start = time.perf_counter()

    def _ts_us(self) -> float:
        return (time.perf_counter() - self._start) * 1e6

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
                "tid": self._tid(tensor_name), "ts": self._ts_us(),
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
                "ts": self._ts_us(), "args": dict(values)})

    def instant(self, name: str):
        """Process-scoped instant event (steady-state replay
        enter/exit marks and similar one-shot state flips)."""
        if self.writer:
            self.writer.enqueue({
                "name": name, "ph": "i", "pid": 0, "tid": 0,
                "ts": self._ts_us(), "s": "p"})

    def mark_cycle_start(self):
        if self.writer and self.mark_cycles:
            self.writer.enqueue({
                "name": "CYCLE_START", "ph": "i", "pid": 0, "tid": 0,
                "ts": self._ts_us(), "s": "g"})

    def _emit_begin(self, tensor_name: str, name: str):
        if self.writer:
            self.writer.enqueue({
                "name": name, "ph": "B", "pid": 0,
                "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def _emit_end(self, tensor_name: str):
        if self.writer:
            self.writer.enqueue({
                "ph": "E", "pid": 0, "tid": self._tid(tensor_name),
                "ts": self._ts_us()})

    def close(self):
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
        if on_card:
            time.sleep(DEVICE_WINDOW_MARGIN_S)
        _device_trace = (prof, log_dir, on_card)


def stop_xla_trace() -> str:
    """Stop the trace :func:`start_xla_trace` began and write it; returns
    the path of the Chrome trace (``<host>.<pid>.<ms>.pt.trace.json`` in
    its ``log_dir``).  Raises when no trace is running.

    ``torch.profiler``'s export is kept but for its metadata events
    without ``args.name`` (``process_labels``, ``process_sort_index``,
    ``thread_sort_index``: a viewer's labels and ordering), which the
    repository's trace rules refuse (every ``M`` event names its process
    or thread: ``tools/validate_trace``)."""
    global _device_trace
    import socket
    with _device_trace_lock:
        if _device_trace is None:
            raise RuntimeError("no device trace is running "
                               "(start_xla_trace was not called)")
        prof, log_dir, on_card = _device_trace
        _device_trace = None
        if on_card:
            # Every kernel enqueued inside the window finishes, and the
            # window closes a margin after the last one.
            import torch
            torch.cuda.synchronize()
            time.sleep(DEVICE_WINDOW_MARGIN_S)
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "%s.%d.%d.pt.trace.json" % (
            socket.gethostname(), os.getpid(), int(time.time() * 1e3)))
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] = [
            e for e in trace["traceEvents"] if e.get("ph") != "M" or
            "name" in (e.get("args") or {})]
        with open(path, "w") as f:
            json.dump(trace, f)
        return path
