"""Chrome-tracing timeline writer.

Mirrors the reference's Horovod Timeline (reference: timeline.{h,cc}:
TimelineWriter with a dedicated writer thread fed by a lock-free SPSC
queue :48-100; per-tensor state machine NEGOTIATING → TOP_LEVEL →
ACTIVITY :106-154; written on the coordinator rank only,
operations.cc:422-425; format documented in docs/timeline.rst).

Python implementation uses a queue.SimpleQueue (lock-free fast path on
CPython) + daemon writer thread.  The output is standard chrome://tracing
JSON, one async span per tensor keyed by a stable "tid" so collectives
stack per tensor name.  XLA device-side profiling is delegated to
``jax.profiler`` (see ``start_xla_trace``) — host spans here, device
timeline there, matching the GPU event-queue split in the reference.
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
