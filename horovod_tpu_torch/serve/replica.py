"""Snapshot-consistent serving replica over committed checkpoints.

Counterpart of :mod:`horovod_tpu.serve.replica`, whose docstring gives
the design: bootstrap from the newest valid committed step (base plus
delta chain, past corrupt steps), tail newly committed steps (an
incremental delta apply when the step's ``delta_of`` is the served step,
else a full rebase), flip an immutable snapshot in with ONE reference
assignment, the ``serve.delta_apply`` failpoint between build and flip,
the freshness gauges and the staleness bound.

The port keeps each snapshot's tables on ``device`` (``None``: the
card): a lookup gathers there, and a delta apply copies only the touched
rows up.  The flip stays a snapshot guarantee on the card only if a new
snapshot's tables are complete before a reader on another thread can
see them: the tail thread synchronizes its stream before the flip, and
readers and the tail thread queue their work on the device's current
stream (no side streams), so a table the caching allocator frees after
a flip is reused only behind the reads queued on it.  Delta masks (the
row-source attribution of ``hvd_serve_rows_total``) stay on the host.
"""

import logging
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import CheckpointManager, RowDelta
from ..checkpoint.delta import assemble_table
from ..common import env as _env
from ..common import failpoints as _fp
from ..common import flight_recorder as _fr
from ..common import metrics
from ..models.gpt import resolve_device
from ..sparse.embedding import bag_segments, pool_bags

logger = logging.getLogger("horovod_tpu_torch.serve")

_FRESH_STEPS = metrics.gauge(
    "hvd_serve_freshness_steps",
    "Freshest committed training step minus the step the replica "
    "currently serves (0 = fully caught up)")
_FRESH_SECONDS = metrics.gauge(
    "hvd_serve_freshness_seconds",
    "Wall seconds the replica has been behind the freshest committed "
    "step (0 while caught up)")
_LOOKUP_SECONDS = metrics.histogram(
    "hvd_serve_lookup_seconds",
    "Serving read latency by op (lookup = raw rows, bag = pooled "
    "EmbeddingBag read)")
_ROWS = metrics.counter(
    "hvd_serve_rows_total",
    "Rows served, split by whether the row was last written by the "
    "bootstrap/rebase base image or an incrementally applied delta")
_FLIPS = metrics.counter(
    "hvd_serve_snapshot_flips_total",
    "Atomic snapshot installs by kind (bootstrap / delta / rebase)")
_REJECTS = metrics.counter(
    "hvd_serve_rejects_total",
    "Reads refused, by reason (staleness = freshness lag exceeded "
    "HOROVOD_SERVE_MAX_STALENESS_STEPS)")

# Sparse-table checkpoint items are named sparse/<table>/rows.r<rank>
# (ShardedEmbedding.item_name).
_ITEM_RE = re.compile(r"^sparse/(.+)/rows\.r\d+$")


class StalenessError(RuntimeError):
    """Read refused: the replica is farther behind the freshest
    committed step than HOROVOD_SERVE_MAX_STALENESS_STEPS allows."""


class _Snapshot:
    """One immutable served view: exactly one committed step's tables
    (on the device) and, per table, which rows a delta wrote (on the
    host)."""

    __slots__ = ("step", "tables", "delta_mask")

    def __init__(self, step: int, tables: Dict[str, torch.Tensor],
                 delta_mask: Dict[str, np.ndarray]):
        self.step = step
        self.tables = tables
        self.delta_mask = delta_mask


def _split_by_table(items: Dict[str, object]
                    ) -> Dict[str, Dict[str, object]]:
    """Group checkpoint items by embedding-table name, dropping anything
    that is not a sparse-table shard."""
    by_table: Dict[str, Dict[str, object]] = {}
    for name, item in items.items():
        m = _ITEM_RE.match(name)
        if m is not None:
            by_table.setdefault(m.group(1), {})[name] = item
    return by_table


def _full_snapshot(step: int, items: Dict[str, object],
                   device: torch.device) -> "_Snapshot":
    """A from-scratch snapshot: every sparse table assembled on the host
    and copied to ``device``, delta masks cleared."""
    tables: Dict[str, torch.Tensor] = {}
    masks: Dict[str, np.ndarray] = {}
    for name in _split_by_table(items):
        table = assemble_table(items, "sparse/%s/rows" % name)
        if table is None:  # pragma: no cover - split guarantees a hit
            continue
        tables[name] = torch.from_numpy(table).to(device)
        masks[name] = np.zeros(table.shape[0], dtype=bool)
    return _Snapshot(step, tables, masks)


class ServingReplica:
    """Read-only embedding server over a trainer's checkpoint directory,
    its tables on ``device`` (``None``: the card; without one, pass
    ``device="cpu"``).  Reads are lock-free against a single immutable
    snapshot reference; only the tail thread (or explicit ``poll_once``
    calls) installs new snapshots."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = resolve_device(device)
        # Read-only manager: world_size=1 needs no coordinator, and
        # keep=None never collects the trainer's steps.
        self._mgr = CheckpointManager(directory, rank=0, world_size=1,
                                      keep=None)
        self._snap: Optional[_Snapshot] = None
        self._latest_known: Optional[int] = None
        self._behind_since: Optional[float] = None
        self._poll_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # snapshot lifecycle (tail side)
    # ------------------------------------------------------------------
    def bootstrap(self) -> int:
        """Load the newest valid committed step and install it as the
        first served snapshot; returns the served step.  Raises
        CheckpointNotFoundError when nothing has been committed."""
        step, items = self._mgr.restore_latest()
        self._install(_full_snapshot(step, items, self.device),
                      "bootstrap")
        with self._poll_lock:
            self._refresh_freshness()
        return step

    def poll_once(self) -> int:
        """Apply every step committed since the served one (delta apply
        when the chain lines up, full rebase otherwise), refresh the
        freshness gauges, and return how many snapshots were installed.
        A corrupt step is skipped: the replica keeps serving the last
        good snapshot."""
        with self._poll_lock:
            advanced = 0
            if self._snap is None:
                raise RuntimeError("poll_once before bootstrap")
            for step in self._mgr.committed_steps():
                if step <= self._snap.step:
                    continue
                try:
                    if self._try_advance(step):
                        advanced += 1
                except Exception as e:  # corrupt link, torn disk, ...
                    logger.warning(
                        "serve: cannot advance to committed step %d "
                        "(%s); still serving step %d", step, e,
                        self._snap.step)
            self._refresh_freshness()
            return advanced

    def _try_advance(self, step: int) -> bool:
        """Build the snapshot of one newly committed ``step`` and install
        it.  Returns False when a failpoint dropped the flip."""
        snap = self._snap
        items, parent = self._mgr.step_items(step)
        new = mode = None
        if parent is not None and parent == snap.step:
            try:
                new = self._apply_delta(snap, step, items)
                mode = "delta"
            except KeyError:
                pass  # table unknown to this snapshot line: rebase
        elif parent is None:
            new = _full_snapshot(step, items, self.device)
            mode = "rebase"
        if new is None:
            new = _full_snapshot(step, self._mgr.restore(step),
                                 self.device)
            mode = "rebase"
        # The torn-apply window: built, not yet visible.
        if _fp.ENABLED:
            if _fp.maybe_fail("serve.delta_apply") == "drop":
                return False
        self._install(new, mode)
        return True

    def _apply_delta(self, snap: "_Snapshot", step: int,
                     items: Dict[str, object]) -> "_Snapshot":
        """Copy-on-write application of one committed step's RowDelta
        items on top of ``snap``: only the tables the step touched are
        copied (on the device), the others are shared by reference."""
        tables = dict(snap.tables)
        masks = dict(snap.delta_mask)
        for name, shard_items in _split_by_table(items).items():
            base = tables.get(name)
            if base is None:
                logger.warning("serve: step %d touches unknown table "
                               "%r; rebase required", step, name)
                raise KeyError(name)
            table = base.clone()
            mask = masks[name].copy()
            for d in shard_items.values():
                if not isinstance(d, RowDelta):
                    continue
                if d.num_rows != table.shape[0]:
                    raise ValueError(
                        "RowDelta for a %d-row table applied to a %d-row "
                        "table" % (d.num_rows, table.shape[0]))
                if len(d.rows):
                    table[torch.from_numpy(d.rows).to(self.device)] = \
                        torch.from_numpy(d.values).to(self.device,
                                                      table.dtype)
                mask[d.rows] = True
            tables[name] = table
            masks[name] = mask
        return _Snapshot(step, tables, masks)

    def _install(self, snap: "_Snapshot", mode: str):
        if self.device.type == "cuda":
            # The snapshot's copies must be complete before a reader on
            # another thread can see it.
            torch.cuda.current_stream(self.device).synchronize()
        self._snap = snap  # THE atomic flip: one reference assignment
        _FLIPS.inc(kind=mode)
        if _fr.ENABLED:
            _fr.record(_fr.SERVE, phase="flip", step=snap.step,
                       mode=mode, tables=len(snap.tables))

    def _refresh_freshness(self):
        """Update the freshness gauges (called with _poll_lock held)."""
        steps = self._mgr.committed_steps()
        latest = steps[-1] if steps else None
        self._latest_known = latest
        snap = self._snap
        if snap is None or latest is None:
            return
        lag = max(0, latest - snap.step)
        _FRESH_STEPS.set(float(lag))
        if lag == 0:
            self._behind_since = None
            _FRESH_SECONDS.set(0.0)
        else:
            now = time.monotonic()
            if self._behind_since is None:
                self._behind_since = now
            _FRESH_SECONDS.set(now - self._behind_since)

    # ------------------------------------------------------------------
    # tail thread
    # ------------------------------------------------------------------
    def start(self):
        """Start the background tail thread (after bootstrap)."""
        if self._snap is None:
            raise RuntimeError("start before bootstrap")
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._tail_loop,
                                        name="hvd-serve-tail",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def _tail_loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                # Serving must outlive any tail hiccup.
                logger.exception("serve: poll failed; still serving")
            self._stop.wait(_env.serve_poll_seconds())

    # ------------------------------------------------------------------
    # read side (lock-free)
    # ------------------------------------------------------------------
    def freshness(self) -> Tuple[int, Optional[int]]:
        """(served step, freshest known committed step)."""
        snap = self._snap
        if snap is None:
            raise RuntimeError("freshness before bootstrap")
        return snap.step, self._latest_known

    def table_names(self) -> List[str]:
        snap = self._snap
        return sorted(snap.tables) if snap is not None else []

    def _check_staleness(self, snap: "_Snapshot"):
        bound = _env.serve_max_staleness_steps()
        if not bound:
            return
        latest = self._latest_known
        lag = 0 if latest is None else max(0, latest - snap.step)
        if lag > bound:
            _REJECTS.inc(reason="staleness")
            raise StalenessError(
                "replica serves step %d but step %d is committed "
                "(lag %d > bound %d)" % (snap.step, latest, lag, bound))

    def lookup(self, table: str, ids) -> Tuple[torch.Tensor, int]:
        """Batch id lookup against the current snapshot, gathered on the
        device.  Returns ``(rows, served_step)``: every row is the
        committed value at exactly that step.  Raises KeyError (unknown
        table), IndexError (id out of range, checked on the host as
        numpy indexes), :class:`StalenessError`."""
        t0 = time.perf_counter()
        snap = self._snap
        if snap is None:
            raise RuntimeError("lookup before bootstrap")
        self._check_staleness(snap)
        arr = snap.tables[table]
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, np.int64)
        n = arr.shape[0]
        if ids.size and (ids.max() >= n or ids.min() < -n):
            raise IndexError("ids out of range for table %r of %d rows: "
                             "min %d max %d" % (table, n, ids.min(),
                                                ids.max()))
        rows = arr[torch.from_numpy(ids).to(arr.device)]
        n_delta = int(np.count_nonzero(snap.delta_mask[table][ids]))
        if n_delta:
            _ROWS.inc(float(n_delta), source="delta")
        if ids.size - n_delta:
            _ROWS.inc(float(ids.size - n_delta), source="base")
        _LOOKUP_SECONDS.observe(time.perf_counter() - t0, op="lookup")
        return rows, snap.step

    def embedding_bag(self, table: str, ids, offsets,
                      mode: str = "sum") -> Tuple[torch.Tensor, int]:
        """Pooled EmbeddingBag read (torch offsets convention), pooled
        on the device in the JAX replica's order.  Returns ``(pooled,
        served_step)``."""
        if mode not in ("sum", "mean"):
            raise ValueError("mode must be 'sum' or 'mean'")
        t0 = time.perf_counter()
        rows, step = self.lookup(table, ids)
        out = pool_bags(rows, bag_segments(offsets, rows.shape[0]), mode)
        _LOOKUP_SECONDS.observe(time.perf_counter() - t0, op="bag")
        return out, step
