"""Tensor table + pending-request queue shared between the caller threads
and the background runtime.

Mirrors the reference tensor queue (reference: common/tensor_queue.{h,cc}:
mutex-guarded name → TensorTableEntry map + pending Request queue, with
duplicate-name rejection per common.h:165-168 and a shutdown flush that
fails every outstanding callback).
"""
# hvdlint-module: hot-path (instrumentation must hide behind one attribute check — docs/static_analysis.md)

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .exceptions import DuplicateTensorNameError
from .message import Request


@dataclass
class TensorTableEntry:
    tensor_name: str
    tensor: Any                       # payload (torch tensor)
    callback: Callable                # fn(status_ok, result_or_error)
    root_rank: int = -1
    device: int = 0
    process_set_id: int = 0
    # Optional second payload (e.g. alltoall splits).
    splits: Any = None
    context: dict = field(default_factory=dict)
    # CUDA ordering: recorded on the submitter's stream at submit (the
    # data plane's stream waits on it), and on the data plane's stream
    # once the result is written (the waiter's stream waits on it).
    ready_event: Any = None
    done_event: Any = None


class SHUT_DOWN_ERROR(RuntimeError):
    pass


class TensorQueue:
    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, TensorTableEntry] = {}
        self._pending: List[Request] = []

    def add(self, request: Request, entry: TensorTableEntry):
        with self._lock:
            key = (entry.tensor_name, entry.process_set_id)
            tkey = f"{entry.process_set_id}:{entry.tensor_name}"
            if tkey in self._table:
                raise DuplicateTensorNameError(
                    f"Duplicate tensor name {entry.tensor_name!r} submitted; "
                    "a previous collective with this name has not completed. "
                    "This usually means ranks are running different graphs.")
            self._table[tkey] = entry
            self._pending.append(request)

    def add_multi(self, requests: List[Request],
                  entries: List[TensorTableEntry]):
        with self._lock:
            for e in entries:
                tkey = f"{e.process_set_id}:{e.tensor_name}"
                if tkey in self._table:
                    raise DuplicateTensorNameError(
                        f"Duplicate tensor name {e.tensor_name!r} in group.")
            for r, e in zip(requests, entries):
                tkey = f"{e.process_set_id}:{e.tensor_name}"
                self._table[tkey] = e
                self._pending.append(r)

    def add_entry_only(self, entry: TensorTableEntry):
        """Table insert without queueing the request — the inline
        cache-hit path sends its own CH frame from the caller thread,
        so the entry must be resolvable by the dispatch thread but the
        request must never reach the negotiation queue."""
        with self._lock:
            tkey = f"{entry.process_set_id}:{entry.tensor_name}"
            if tkey in self._table:
                raise DuplicateTensorNameError(
                    f"Duplicate tensor name {entry.tensor_name!r} "
                    "submitted; a previous collective with this name "
                    "has not completed. This usually means ranks are "
                    "running different graphs.")
            self._table[tkey] = entry

    def queue_request(self, request: Request):
        """Queue a request whose entry is already in the table (the
        inline path falling back to negotiation on a cache miss)."""
        with self._lock:
            self._pending.append(request)

    def queue_requests(self, requests: List[Request]):
        """Bulk variant of :meth:`queue_request` (steady-state replay
        exiting with a partially-submitted batch): one lock round for
        the whole flush, preserving submission order."""
        with self._lock:
            self._pending.extend(requests)

    def pop_pending(self) -> List[Request]:
        """Drain the pending-request queue (one negotiation cycle's worth)."""
        with self._lock:
            pending, self._pending = self._pending, []
            return pending

    def push_back(self, requests: List[Request]):
        """Return unserviced requests to the queue head (e.g. when the
        coordinator has not matched them yet)."""
        with self._lock:
            self._pending = requests + self._pending

    def get_entry(self, name: str, process_set_id: int = 0
                  ) -> Optional[TensorTableEntry]:
        with self._lock:
            return self._table.get(f"{process_set_id}:{name}")

    def pop_entry(self, name: str, process_set_id: int = 0
                  ) -> Optional[TensorTableEntry]:
        with self._lock:
            return self._table.pop(f"{process_set_id}:{name}", None)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._table)

    def shutdown_flush(self, error: Optional[Exception] = None):
        """Fail every outstanding callback (reference: tensor_queue
        finalize → SHUT_DOWN_ERROR)."""
        err = error or SHUT_DOWN_ERROR(
            "Horovod-TPU has been shut down; outstanding collective "
            "was cancelled.")
        with self._lock:
            entries = list(self._table.values())
            self._table.clear()
            self._pending.clear()
        for e in entries:
            try:
                e.callback(False, err)
            except Exception:
                pass
