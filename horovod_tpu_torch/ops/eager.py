"""Eager collective API with async handles.

The framework-agnostic layer every binding (JAX, PyTorch, TF2/Keras)
calls into — analog of the reference's EnqueueTensor* entry points
(reference: operations.cc:900-1188) plus the torch-style handle table
(reference: torch/handle_manager.{h,cc}, torch/mpi_ops.py:823-846
synchronize/poll semantics).

Average is implemented as Sum + postscale 1/size, the same split the
reference uses so pre/post scaling composes correctly
(reference: tensorflow/__init__.py:337-344, operations.cc:941-948).

Counterpart of :mod:`horovod_tpu.ops.eager`: torch tensors pass through
untouched and results come back on the input's device.  A CUDA result
arrives with the event the data plane recorded after writing it;
``Handle.wait`` makes the waiting thread's current stream wait on that
event (the host does not block on the device).
"""

import itertools
import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..common import basics
from ..common.basics import (Adasum, Average, Max, Min, Product, Sum,
                             ProcessSet, global_process_set)
from ..common.exceptions import HorovodInternalError
from ..common.message import (Request, RequestType, dtype_of)
from ..common.tensor_queue import TensorTableEntry

_name_counter = itertools.count()


class Handle:
    """Future for an in-flight collective."""

    __slots__ = ("_event", "ok", "result", "error", "name", "_done")

    def __init__(self, name: str = ""):
        self._event = threading.Event()
        self.ok = False
        self.result = None
        self.error: Optional[Exception] = None
        self.name = name
        self._done = None

    def _complete(self, ok: bool, result_or_error, done_event=None):
        self.ok = ok
        if ok:
            self.result = result_or_error
            self._done = done_event
        else:
            self.error = result_or_error
        self._event.set()

    def _order_after_device_result(self):
        """The current stream waits on the data plane's done event, and
        the result's memory is marked as used by that stream."""
        done, self._done = self._done, None
        result = self.result
        tensors = result if isinstance(result, tuple) else (result,)
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(done)
                t.record_stream(stream)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"Collective {self.name!r} did not complete in time.")
        if not self.ok:
            err = self.error
            if isinstance(err, Exception) and not isinstance(
                    err, (ValueError, TypeError)):
                raise HorovodInternalError(str(err)) from err
            raise err
        if self._done is not None:
            self._order_after_device_result()
        return self.result


def poll(handle: Handle) -> bool:
    """Non-blocking completion check (reference: torch/mpi_ops.py poll)."""
    return handle.done()


def synchronize(handle: Handle, timeout: Optional[float] = None):
    """Block until the collective finishes and return its result."""
    return handle.wait(timeout)


def _auto_name(prefix: str, name: Optional[str]) -> str:
    if name is not None:
        return name
    return f"{prefix}.noname.{next(_name_counter)}"


def _resolve_op(op: Optional[str], average: Optional[bool]):
    if op is not None and average is not None:
        raise ValueError("Cannot specify both 'op' and deprecated "
                         "'average' arguments.")
    if op is None:
        op = Average if (average is None or average) else Sum
    return op


def _entry(handle: Handle, **fields) -> TensorTableEntry:
    """A table entry whose completion hands ``handle`` the result and the
    data plane's done event."""
    entry = TensorTableEntry(callback=None, **fields)
    entry.callback = lambda ok, result: handle._complete(
        ok, result, entry.done_event)
    return entry


def _runtime():
    state = basics._state()
    state.require_init()
    return state.runtime


def _submit(request_type: RequestType, tensor, name: str, *, reduce_op=Sum,
            root_rank=-1, prescale=1.0, postscale=1.0, splits=None,
            process_set: ProcessSet = global_process_set) -> Handle:
    runtime = _runtime()
    if process_set.process_set_id is None or \
            process_set.process_set_id < 0:
        # An unregistered set has no coordinator identity; letting the
        # request out with psid=-1 collides with every other
        # unregistered set's tensors and wedges the job.
        raise ValueError(
            "process set %r is not registered: pass it to "
            "hvd.init(process_sets=[...]) or call "
            "hvd.add_process_set(ps) first" % (process_set,))
    handle = Handle(name)
    # Shapeless inputs (python lists/scalars) are normalized to a CPU
    # tensor with numpy's dtype up front: the request must report their
    # REAL shape/dtype (the coordinator validates alltoall splits
    # against dim 0 and substitutes zeros by shape for joined ranks),
    # and the table entry must carry the converted tensor so
    # single-process worlds return the same type as multi-rank ones.
    if tensor is not None and not hasattr(tensor, "dtype"):
        tensor = torch.from_numpy(np.asarray(tensor))
    entry = _entry(handle, tensor_name=name, tensor=tensor,
                   root_rank=root_rank,
                   process_set_id=process_set.process_set_id, splits=splits)
    shape = tuple(tensor.shape) if tensor is not None else ()
    wire_splits = ()
    if request_type == RequestType.ALLTOALL:
        # Send splits ride the request so the coordinator can hand every
        # rank its recv splits in the response (no data-plane split
        # exchange).  splits=None means an even dim-0 split.
        if splits is None:
            from .backend import even_row_counts
            dim0 = shape[0] if shape else 1
            wire_splits = tuple(
                even_row_counts(int(dim0), process_set.size()))
        else:
            wire_splits = tuple(int(s) for s in splits)
    req = Request(
        request_rank=basics.rank(),
        request_type=request_type,
        tensor_name=name,
        tensor_shape=shape,
        tensor_type=dtype_of(tensor) if tensor is not None else 0,
        root_rank=root_rank,
        prescale_factor=prescale,
        postscale_factor=postscale,
        process_set_id=process_set.process_set_id,
        reduce_op=reduce_op,
        process_set_ranks=tuple(process_set.ranks or ()),
        splits=wire_splits,
    )
    runtime.submit(req, entry)
    return handle


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------
def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set) -> Handle:
    op = _resolve_op(op, average)
    name = _auto_name("allreduce", name)
    if op == Average:
        reduce_op, postscale_factor = Sum, postscale_factor / process_set.size()
    elif op == Adasum:
        return _submit(RequestType.ADASUM, tensor, name,
                       reduce_op=Adasum, prescale=prescale_factor,
                       postscale=postscale_factor, process_set=process_set)
    else:
        reduce_op = op
    return _submit(RequestType.ALLREDUCE, tensor, name,
                   reduce_op=reduce_op, prescale=prescale_factor,
                   postscale=postscale_factor, process_set=process_set)


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set):
    return synchronize(allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set))


def grouped_allreduce_async(tensors: Sequence[Any], average=None, name=None,
                            op=None, prescale_factor=1.0,
                            postscale_factor=1.0,
                            process_set=global_process_set) -> List[Handle]:
    """Submit a group atomically: the fusion planner keeps group members
    in one fused batch (reference: group_table.{h,cc},
    operations.cc:1006-1013)."""
    op = _resolve_op(op, average)
    base = _auto_name("grouped_allreduce", name)
    if op == Average:
        reduce_op, postscale_factor = Sum, postscale_factor / process_set.size()
        rtype = RequestType.ALLREDUCE
    elif op == Adasum:
        reduce_op, rtype = Adasum, RequestType.ADASUM
    else:
        reduce_op, rtype = op, RequestType.ALLREDUCE
    runtime = _runtime()
    handles, reqs, entries = [], [], []
    for i, t in enumerate(tensors):
        tname = f"{base}.{i}"
        h = Handle(tname)
        handles.append(h)
        entries.append(_entry(
            h, tensor_name=tname, tensor=t,
            process_set_id=process_set.process_set_id))
        reqs.append(Request(
            request_rank=basics.rank(), request_type=rtype,
            tensor_name=tname, tensor_shape=tuple(t.shape),
            tensor_type=dtype_of(t), prescale_factor=prescale_factor,
            postscale_factor=postscale_factor,
            process_set_id=process_set.process_set_id,
            reduce_op=reduce_op,
            process_set_ranks=tuple(process_set.ranks or ())))
    runtime.submit_group(reqs, entries)
    return handles


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set):
    handles = grouped_allreduce_async(
        tensors, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set)
    return [h.wait() for h in handles]


# ---------------------------------------------------------------------------
# allgather / broadcast / alltoall / reducescatter
# ---------------------------------------------------------------------------
def allgather_async(tensor, name=None,
                    process_set=global_process_set) -> Handle:
    name = _auto_name("allgather", name)
    return _submit(RequestType.ALLGATHER, tensor, name,
                   process_set=process_set)


def allgather(tensor, name=None, process_set=global_process_set):
    return synchronize(allgather_async(tensor, name, process_set))


def broadcast_async(tensor, root_rank: int, name=None,
                    process_set=global_process_set) -> Handle:
    name = _auto_name("broadcast", name)
    return _submit(RequestType.BROADCAST, tensor, name, root_rank=root_rank,
                   process_set=process_set)


def broadcast(tensor, root_rank: int, name=None,
              process_set=global_process_set):
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set) -> Handle:
    name = _auto_name("alltoall", name)
    return _submit(RequestType.ALLTOALL, tensor, name, splits=splits,
                   process_set=process_set)


def alltoall(tensor, splits=None, name=None,
             process_set=global_process_set):
    """Returns (tensor, received_splits) when splits given, else tensor —
    matching reference alltoall semantics (operations.cc:1099-1160)."""
    result = synchronize(alltoall_async(tensor, splits, name, process_set))
    out, recv_splits = result
    if splits is None:
        return out
    return out, recv_splits


def reducescatter_async(tensor, name=None, op=None,
                        process_set=global_process_set) -> Handle:
    """First-class reduce-scatter (TPU addition; the reference only uses
    it inside hierarchical allreduce — SURVEY §2.3 FSDP row)."""
    name = _auto_name("reducescatter", name)
    reduce_op = op or Sum
    return _submit(RequestType.REDUCESCATTER, tensor, name,
                   reduce_op=reduce_op, process_set=process_set)


def reducescatter(tensor, name=None, op=None,
                  process_set=global_process_set):
    return synchronize(reducescatter_async(tensor, name, op, process_set))


# ---------------------------------------------------------------------------
# join / barrier
# ---------------------------------------------------------------------------
def join() -> int:
    """Graceful early exit: this rank stops contributing; other ranks'
    collectives substitute zeros for it.  Blocks until every rank joins
    and returns the last-joined rank (reference: operations.cc:1164-1188,
    torch/mpi_ops.py:846-870).

    The entry name is the fixed "join" on every rank: the coordinator's
    JOIN response names it so each rank pops its own entry.  While
    joined, the background runtime substitutes zero tensors for this
    rank's missing contributions (JoinOp semantics).
    """
    runtime = _runtime()
    runtime.set_joined(True)
    h = _submit(RequestType.JOIN, None, "join")
    try:
        return h.wait()
    finally:
        runtime.set_joined(False)


def barrier(process_set=global_process_set):
    # Fixed per-process-set name: every rank must use the same tensor
    # name or the coordinator's response wouldn't match local entries.
    h = _submit(RequestType.BARRIER, None,
                f"barrier.ps{process_set.process_set_id}",
                process_set=process_set)
    return h.wait()
