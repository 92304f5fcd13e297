"""Row-sharded embedding tables over the eager alltoall plane.

Counterpart of :mod:`horovod_tpu.sparse.embedding`, whose docstring gives
the exchange protocol (ids, then rows, then gradients: three alltoalls
with explicit splits under the tensor names
``sparse.<table>.{ids,rows,grads}.<call>``), the round-robin ownership
(``owner = id % size``, ``slot = id // size``) and the generational
touch tracking behind ``durable_items``.

The port keeps each rank's slice, the ids, the exchanged rows and the
gradients on ``device`` (``None``: the card); only the per-owner counts
(the alltoall's splits) and the touched marks at a commit cross to the
host.  The JAX engine's arithmetic is numpy's and ordered, and the port
keeps its order bit for bit on every device:

* rows start from the same splitmix64 hash, computed with numpy on the
  host (a torch right shift of ``int64`` is arithmetic, where the hash
  needs a logical one) and copied to the device once;
* ``np.add.at`` and ``np.subtract.at`` apply duplicate indices one after
  another in input order, where ``index_add_`` on the card adds them by
  atomics in no order; :func:`ordered_scatter` applies the k-th
  occurrence of every index in round k, so each row sees its updates in
  input order (duplicate ids of a batch in batch order, then the
  requesters' updates in rank order).
"""

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.delta import RowDelta, assemble_table
from ..common import env as _env
from ..common import metrics
from ..models.gpt import resolve_device

_A2A_OPS = metrics.counter(
    "hvd_sparse_alltoall_ops_total",
    "Alltoall exchanges issued by the sparse embedding engine, by "
    "stage (ids/rows/grads)")
_A2A_BYTES = metrics.counter(
    "hvd_sparse_alltoall_bytes_total",
    "Payload bytes sent by sparse embedding alltoalls, by stage")
_LOOKUP_SECONDS = metrics.histogram(
    "hvd_sparse_lookup_seconds",
    "Wall time of ShardedEmbedding lookup/apply_gradients calls")


def _hvd_rank_size() -> Tuple[int, int]:
    from ..common import basics
    return basics.rank(), basics.size()


def _alltoall(tensor: torch.Tensor, splits, name: str
              ) -> Tuple[torch.Tensor, np.ndarray]:
    from ..ops import eager
    out, recv = eager.alltoall(tensor, splits=splits, name=name)
    return out, np.asarray(recv, np.int64)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ordered_scatter(target: torch.Tensor, index: torch.Tensor,
                    values: torch.Tensor, op: str) -> torch.Tensor:
    """``target[index[i]] += values[i]`` (``op="add"``) or ``-=``
    (``"sub"``) for every i in order, in place, as ``np.add.at`` and
    ``np.subtract.at`` do: the k-th occurrence of each index is applied
    in round k, so every row of ``target`` takes its updates in the
    order of ``index``, exactly and on any device.  Returns ``target``."""
    if op not in ("add", "sub"):
        raise ValueError("op must be 'add' or 'sub', got %r" % (op,))
    n = index.numel()
    if not n:
        return target
    order = torch.sort(index, stable=True).indices
    ranked = index[order]
    pos = torch.arange(n, device=index.device)
    starts = torch.ones(n, dtype=torch.bool, device=index.device)
    starts[1:] = ranked[1:] != ranked[:-1]
    run_start = torch.cummax(torch.where(starts, pos, 0), 0).values
    occurrence = torch.empty_like(pos)
    occurrence[order] = pos - run_start
    by_round = torch.sort(occurrence, stable=True).indices
    counts = torch.bincount(occurrence).tolist()
    idx, vals = index[by_round], values[by_round]
    start = 0
    for c in counts:
        # No index repeats within a round: a plain (deterministic) put.
        rows, upd = idx[start:start + c], vals[start:start + c]
        now = target[rows]
        target.index_put_((rows,), now + upd if op == "add" else now - upd)
        start += c
    return target


class _LookupContext:
    """Routing state one lookup leaves behind for its backward (see the
    JAX engine's): ``inv`` scatters unique rows back to input order when
    the exchange ran over the batch's unique ids, else is ``None``."""

    __slots__ = ("perm", "send_counts", "recv_splits", "recv_slots",
                 "n_ids", "inv", "n_unique")

    def __init__(self, perm, send_counts, recv_splits, recv_slots,
                 n_ids, inv=None, n_unique=None):
        self.perm = perm
        self.send_counts = send_counts
        self.recv_splits = recv_splits
        self.recv_slots = recv_slots
        self.n_ids = n_ids
        self.inv = inv
        self.n_unique = n_unique if n_unique is not None else n_ids


class _PendingLookup:
    """In-flight state of one table's staged lookup (the overlapped
    multi-table path drives several of these concurrently)."""

    __slots__ = ("table", "t0", "ids", "ex_ids", "inv", "call",
                 "perm", "send_ids", "send_counts", "handle",
                 "recv_splits", "recv_slots")

    def __init__(self, table, t0, ids, ex_ids, inv, call):
        self.table = table
        self.t0 = t0
        self.ids = ids
        self.ex_ids = ex_ids
        self.inv = inv
        self.call = call
        self.perm = None
        self.send_ids = None
        self.send_counts = None
        self.handle = None
        self.recv_splits = None
        self.recv_slots = None


class ShardedEmbedding:
    """One embedding table, row-sharded across the Horovod world, its
    slice on ``device`` (``None``: the card; without one, pass
    ``device="cpu"``).

    ``rank``/``size`` default to the live Horovod world; pass them
    explicitly (with ``size=1``) to use the engine without ``hvd.init``.
    Row init is deterministic per (name, seed, row) and equal to the JAX
    engine's bit for bit at every world size.
    """

    def __init__(self, name: str, num_rows: int, dim: int,
                 rank: Optional[int] = None,
                 size: Optional[int] = None,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 init_scale: float = 0.01, device=None):
        if num_rows <= 0 or dim <= 0:
            raise ValueError("num_rows and dim must be positive")
        if (rank is None) != (size is None):
            raise ValueError("pass both rank and size or neither")
        self.device = resolve_device(device)
        if rank is None:
            rank, size = _hvd_rank_size()
        if not 0 <= rank < size:
            raise ValueError("rank %d outside world of %d"
                             % (rank, size))
        self.name = str(name)
        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.rank = int(rank)
        self.size = int(size)
        self.dtype = dtype
        self.seed = int(seed)
        self._local_ids = np.arange(self.rank, self.num_rows,
                                    self.size, dtype=np.int64)
        self.local = torch.from_numpy(self._init_rows(
            self._local_ids, float(init_scale))).to(self.device)
        # Touch generations per local slot, as in the JAX engine; on the
        # device, so an update marks its rows without a host copy.
        self._touch_gen = torch.zeros(len(self._local_ids),
                                      dtype=torch.int64, device=self.device)
        self._gen = 0
        self._snap_gen = 0
        self._ctx: Optional[_LookupContext] = None
        self._lock = threading.Lock()
        self._call = 0

    @property
    def _np_dtype(self) -> np.dtype:
        return torch.empty((), dtype=self.dtype).numpy().dtype

    # ------------------------------------------------------------------
    # init / addressing
    # ------------------------------------------------------------------
    def _init_rows(self, ids: np.ndarray, scale: float) -> np.ndarray:
        """The JAX engine's seekable splitmix64 init of (seed, table,
        row*dim+col) into uniform [-scale, scale), computed in numpy's
        ``uint64`` (logical shifts) on the host."""
        table_seed = np.uint64(int.from_bytes(
            self.name.encode()[:8].ljust(8, b"\0"), "little"))
        ctr = (ids[:, None].astype(np.uint64)
               * np.uint64(self.dim)
               + np.arange(self.dim, dtype=np.uint64)[None, :])
        with np.errstate(over="ignore"):
            z = (ctr + np.uint64(self.seed)
                 * np.uint64(0x9E3779B97F4A7C15) + table_seed)
            z = (z + np.uint64(0x9E3779B97F4A7C15))
            z = (z ^ (z >> np.uint64(30))) \
                * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) \
                * np.uint64(0x94D049BB133111EB)
            z = z ^ (z >> np.uint64(31))
        u = (z >> np.uint64(11)).astype(np.float64) / float(2 ** 53)
        return ((2.0 * u - 1.0) * scale).astype(self._np_dtype)

    def owner_of(self, ids: torch.Tensor) -> torch.Tensor:
        return ids % self.size

    def slot_of(self, ids: torch.Tensor) -> torch.Tensor:
        return ids // self.size

    @property
    def local_ids(self) -> np.ndarray:
        return self._local_ids

    # ------------------------------------------------------------------
    # forward / backward
    # ------------------------------------------------------------------
    def _as_ids(self, ids) -> torch.Tensor:
        """``ids`` as a 1-D int64 tensor on the table's device, checked
        against the table on the host (an out-of-range index on the card
        is a device-side assert, not an exception)."""
        if isinstance(ids, torch.Tensor):
            ids = ids.to(torch.int64)
        else:
            ids = torch.from_numpy(np.ascontiguousarray(
                np.asarray(ids, np.int64)))
        if ids.dim() != 1:
            raise ValueError("lookup ids must be 1-D, got shape %s"
                             % (tuple(ids.shape),))
        if ids.numel():
            lo, hi = (int(v) for v in torch.aminmax(ids))
            if lo < 0 or hi >= self.num_rows:
                raise ValueError(
                    "lookup ids out of range [0, %d): min %d max %d"
                    % (self.num_rows, lo, hi))
        return ids.to(self.device)

    def lookup(self, ids) -> torch.Tensor:
        """Gather rows for ``ids`` (any rank's rows) via the alltoall
        exchange; returns ``(len(ids), dim)`` on the table's device in
        input order.  EVERY rank must call lookup for the same table in
        the same step, like any collective.  With
        ``HOROVOD_SPARSE_DEDUPE`` (default on) only the batch's unique
        ids cross the wire."""
        p = self._lookup_start(ids)
        if self.size == 1:
            return self._lookup_finish_local(p)
        self._lookup_route(p)
        recv_ids, recv_splits = _alltoall(
            p.send_ids, p.send_counts,
            name="sparse.%s.ids.%d" % (self.name, p.call))
        served = self._lookup_serve(p, recv_ids, recv_splits)
        rows, _ = _alltoall(
            served, p.recv_splits,
            name="sparse.%s.rows.%d" % (self.name, p.call))
        return self._lookup_finish(p, rows)

    # --- staged lookup internals (shared by lookup_overlapped) --------
    def _lookup_start(self, ids) -> _PendingLookup:
        t0 = time.perf_counter()
        ids = self._as_ids(ids)
        if _env.sparse_dedupe_enabled():
            ex_ids, inv = torch.unique(ids, sorted=True,
                                       return_inverse=True)
        else:
            ex_ids, inv = ids, None
        return _PendingLookup(self, t0, ids, ex_ids, inv,
                              self._next_call())

    def _lookup_finish_local(self, p: "_PendingLookup") -> torch.Tensor:
        slots = self.slot_of(p.ex_ids)
        self._ctx = _LookupContext(None, None, None, slots,
                                   len(p.ids), inv=p.inv,
                                   n_unique=len(p.ex_ids))
        gathered = self.local[slots]
        out = gathered if p.inv is None else gathered[p.inv]
        _LOOKUP_SECONDS.observe(
            time.perf_counter() - p.t0, op="lookup")
        return out

    def _lookup_route(self, p: "_PendingLookup"):
        """The owner-sorted send layout of the ids exchange; the
        per-owner counts are the one value that crosses to the host."""
        owners = self.owner_of(p.ex_ids)
        p.perm = torch.sort(owners, stable=True).indices
        p.send_ids = p.ex_ids[p.perm]
        p.send_counts = torch.bincount(
            owners, minlength=self.size).cpu().numpy()

    def _lookup_serve(self, p: "_PendingLookup", recv_ids,
                      recv_splits) -> torch.Tensor:
        _A2A_OPS.inc(1, stage="ids")
        _A2A_BYTES.inc(_nbytes(p.send_ids), stage="ids")
        p.recv_splits = np.asarray(recv_splits, np.int64)
        p.recv_slots = self.slot_of(recv_ids)
        served = self.local[p.recv_slots]
        _A2A_OPS.inc(1, stage="rows")
        _A2A_BYTES.inc(_nbytes(served), stage="rows")
        return served

    def _lookup_finish(self, p: "_PendingLookup",
                       rows: torch.Tensor) -> torch.Tensor:
        gathered = torch.empty((len(p.ex_ids), self.dim), dtype=self.dtype,
                               device=self.device)
        gathered[p.perm] = rows
        out = gathered if p.inv is None else gathered[p.inv]
        self._ctx = _LookupContext(p.perm, p.send_counts,
                                   p.recv_splits, p.recv_slots,
                                   len(p.ids), inv=p.inv,
                                   n_unique=len(p.ex_ids))
        _LOOKUP_SECONDS.observe(
            time.perf_counter() - p.t0, op="lookup")
        return out

    def apply_gradients(self, grad, lr: float = 0.01):
        """Route ``grad`` (``(len(ids), dim)`` w.r.t. the last lookup's
        output) back to the owning ranks and apply a sparse SGD update
        (``row -= lr * grad``; duplicate ids accumulate, in input
        order).  Marks every updated row touched."""
        t0 = time.perf_counter()
        ctx, self._ctx = self._ctx, None
        if ctx is None:
            raise RuntimeError(
                "apply_gradients without a preceding lookup on table "
                "%r" % self.name)
        grad = torch.as_tensor(grad, dtype=self.dtype,
                               device=self.device).contiguous()
        if tuple(grad.shape) != (ctx.n_ids, self.dim):
            raise ValueError(
                "grad shape %s does not match last lookup (%d, %d)"
                % (tuple(grad.shape), ctx.n_ids, self.dim))
        if ctx.inv is not None:
            # One accumulated gradient per unique id, in table dtype,
            # before the lr scaling and the exchange.
            acc = torch.zeros((ctx.n_unique, self.dim), dtype=self.dtype,
                              device=self.device)
            grad = ordered_scatter(acc, ctx.inv, grad, "add")
        if self.size == 1:
            grad_recv, recv_slots = grad, ctx.recv_slots
        else:
            call = self._next_call()
            grad_recv, _ = _alltoall(
                grad[ctx.perm], ctx.send_counts,
                name="sparse.%s.grads.%d" % (self.name, call))
            _A2A_OPS.inc(1, stage="grads")
            _A2A_BYTES.inc(_nbytes(grad), stage="grads")
            recv_slots = ctx.recv_slots
        # In table dtype end to end, as the JAX engine's ``lr * g``.
        ordered_scatter(self.local, recv_slots, lr * grad_recv, "sub")
        self._gen += 1
        self._touch_gen[recv_slots] = self._gen
        _LOOKUP_SECONDS.observe(
            time.perf_counter() - t0, op="apply_gradients")

    def _next_call(self) -> int:
        with self._lock:
            self._call += 1
            return self._call

    # ------------------------------------------------------------------
    # touched-row lifecycle (differential checkpoints)
    # ------------------------------------------------------------------
    def touched_count(self) -> int:
        return int((self._touch_gen > 0).sum())

    def snapshot_touched(self) -> np.ndarray:
        """LOCAL slot indices touched since the last clear (sorted, on
        the host), recording the touch generation a later
        ``clear_touched(slots)`` forgets up to."""
        self._snap_gen = self._gen
        return np.flatnonzero((self._touch_gen > 0).cpu().numpy())

    def clear_touched(self, slots: Optional[np.ndarray] = None):
        """Forget touched marks — call ONLY after the delta carrying
        them is durably committed.  With ``slots`` (the most recent
        ``snapshot_touched`` result), rows re-touched after that
        snapshot stay marked; without, everything clears."""
        if slots is None:
            self._touch_gen.zero_()
            self._gen = 0
            self._snap_gen = 0
        else:
            slots = torch.as_tensor(np.asarray(slots, np.int64),
                                    device=self.device)
            stale = slots[self._touch_gen[slots] <= self._snap_gen]
            self._touch_gen[stale] = 0

    # ------------------------------------------------------------------
    # durable state (RowDelta items over the checkpoint pipeline)
    # ------------------------------------------------------------------
    def item_prefix(self) -> str:
        return "sparse/%s/rows" % self.name

    def item_name(self) -> str:
        return "%s.r%05d" % (self.item_prefix(), self.rank)

    def durable_items(self, full: bool) -> Dict[str, RowDelta]:
        """This rank's checkpoint item, copied to the host: all owned
        rows (``full=True``, a base) or only the touched ones (a
        delta).  Byte-equal to the JAX engine's for the same table."""
        if full:
            ids, values = self._local_ids, self.local.cpu().numpy()
        else:
            slots = self.snapshot_touched()
            ids = self._local_ids[slots]
            values = self.local[torch.from_numpy(slots).to(
                self.device)].cpu().numpy()
        return {self.item_name():
                RowDelta(ids, values, self.num_rows)}

    def load_durable_items(self, items: Dict[str, object]):
        """Rebuild the local slice from restored checkpoint items
        written at ANY world size, on the table's device."""
        table = assemble_table(items, self.item_prefix(),
                               dtype=self._np_dtype)
        if table is None:
            raise KeyError(
                "no checkpoint items under %r" % self.item_prefix())
        if table.shape != (self.num_rows, self.dim):
            raise ValueError(
                "restored table %r has shape %s, expected (%d, %d)"
                % (self.name, table.shape, self.num_rows, self.dim))
        self.local = torch.from_numpy(np.ascontiguousarray(
            table[self._local_ids])).to(self.device)
        self._touch_gen = torch.zeros(len(self._local_ids),
                                      dtype=torch.int64, device=self.device)
        self._gen = 0
        self._snap_gen = 0
        self._ctx = None

    def full_table(self, items: Optional[Dict[str, object]] = None
                   ) -> torch.Tensor:
        """The complete table on the table's device: assembled from a
        restored checkpoint's ``items``, or (at size 1 only) the live
        slice."""
        if items is not None:
            return torch.from_numpy(assemble_table(
                items, self.item_prefix(),
                dtype=self._np_dtype)).to(self.device)
        if self.size != 1:
            raise RuntimeError(
                "full_table() without items is single-rank only")
        return self.local.clone()


def lookup_overlapped(tables: Sequence[ShardedEmbedding],
                      ids_list: Sequence) -> List[torch.Tensor]:
    """Look up several tables with their alltoall exchanges in flight
    together (the JAX engine's staged path): results and backward
    contexts equal the serial ``lookup`` per table."""
    if len(tables) != len(ids_list):
        raise ValueError("need one ids batch per table (%d vs %d)"
                         % (len(tables), len(ids_list)))
    if len(set(id(t) for t in tables)) != len(tables):
        raise ValueError("tables must be distinct")
    from ..ops import eager
    pend = [t._lookup_start(ids)
            for t, ids in zip(tables, ids_list)]
    outs: List[Optional[torch.Tensor]] = [None] * len(pend)
    remote = []
    for i, p in enumerate(pend):
        if p.table.size == 1:
            outs[i] = p.table._lookup_finish_local(p)
        else:
            p.table._lookup_route(p)
            p.handle = eager.alltoall_async(
                p.send_ids, splits=p.send_counts,
                name="sparse.%s.ids.%d" % (p.table.name, p.call))
            remote.append(i)
    for i in remote:
        p = pend[i]
        recv_ids, recv_splits = eager.synchronize(p.handle)
        served = p.table._lookup_serve(p, recv_ids,
                                       np.asarray(recv_splits))
        p.handle = eager.alltoall_async(
            served, splits=p.recv_splits,
            name="sparse.%s.rows.%d" % (p.table.name, p.call))
    for i in remote:
        p = pend[i]
        rows, _ = eager.synchronize(p.handle)
        outs[i] = p.table._lookup_finish(p, rows)
    return outs


def bag_segments(offsets, n_ids: int) -> np.ndarray:
    """The bag sizes of ``offsets`` over ``n_ids`` ids (torch
    EmbeddingBag convention: bag i owns ids[offsets[i]:offsets[i+1]])."""
    offsets = np.asarray(offsets, np.int64)
    sizes = np.diff(np.concatenate([offsets, [n_ids]]))
    if (sizes < 0).any():
        raise ValueError("offsets must be non-decreasing")
    return sizes


def pool_bags(rows: torch.Tensor, sizes: np.ndarray,
              mode: str) -> torch.Tensor:
    """Sum (or mean) ``rows`` per bag of ``sizes``, each bag's rows added
    in order as ``np.add.at`` adds them."""
    seg = torch.from_numpy(np.repeat(np.arange(len(sizes)), sizes)).to(
        rows.device)
    out = torch.zeros((len(sizes), rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    ordered_scatter(out, seg, rows, "add")
    if mode == "mean":
        out = out / _bag_divisor(sizes, out)
    return out


def _bag_divisor(sizes: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.maximum(sizes, 1)).to(
        like.device, like.dtype)[:, None]


class EmbeddingBag:
    """Sum/mean-pool looked-up rows per example (the DLRM bag shape).

    ``offsets`` follow the torch EmbeddingBag convention: example i
    owns ids[offsets[i]:offsets[i+1]].  The backward expands a bag
    gradient back to per-id row gradients (mean divides by bag size).
    """

    def __init__(self, table: ShardedEmbedding, mode: str = "sum"):
        if mode not in ("sum", "mean"):
            raise ValueError("mode must be 'sum' or 'mean'")
        self.table = table
        self.mode = mode
        self._sizes: Optional[np.ndarray] = None

    def forward(self, ids, offsets) -> torch.Tensor:
        rows = self.table.lookup(ids)
        sizes = bag_segments(offsets, rows.shape[0])
        self._sizes = sizes
        return pool_bags(rows, sizes, self.mode)

    def backward(self, bag_grad, lr: float = 0.01):
        """Expand the per-bag gradient to per-id gradients and apply
        them through the table's alltoall backward."""
        if self._sizes is None:
            raise RuntimeError("backward before forward")
        sizes, self._sizes = self._sizes, None
        bag_grad = torch.as_tensor(bag_grad, dtype=self.table.dtype,
                                   device=self.table.device)
        if self.mode == "mean":
            bag_grad = bag_grad / _bag_divisor(sizes, bag_grad)
        row_grad = torch.repeat_interleave(
            bag_grad, torch.from_numpy(sizes).to(bag_grad.device), dim=0)
        self.table.apply_gradients(row_grad, lr=lr)
