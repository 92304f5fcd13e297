"""Differential checkpoint payloads: row deltas over huge tables.

Recsys-scale models are dominated by embedding tables of which a
training step touches a tiny fraction (Check-N-Run, NSDI '22 — the
production blueprint in PAPERS.md).  Persisting the full table every
checkpoint burns orders of magnitude more bytes than the update
stream; persisting only the rows touched since the last committed
checkpoint cuts the save to the touch rate.

The unit of differential state is :class:`RowDelta`: a set of global
row ids plus their values for one logical table.  A *base* checkpoint
stores every owned row as a RowDelta whose ``rows`` cover the shard; a
*delta* checkpoint stores only the touched rows.  Restore replays the
chain base→…→tip by merging RowDeltas name-wise (later rows overwrite
earlier ones), so the reconstructed table is bit-identical to what a
full checkpoint at the tip would have stored.  RowDeltas travel
through the existing shard pipeline (they pickle like any other item),
so the checksum, atomic-rename, and two-phase-commit machinery applies
unchanged.

The chain lives in manifest metadata (``delta_of`` / ``base_step`` /
``chain_len``); :class:`~.manager.CheckpointManager` bounds it with
``HOROVOD_CKPT_DELTA_CHAIN_MAX`` and GC protects every kept step's
ancestors.

Counterpart of :mod:`horovod_tpu.checkpoint.delta`, copied.  A
``RowDelta`` pickles under the JAX package's class path, so the shards
of both packages hold the same bytes (``shard_io``).
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np


class RowDelta:
    """Sparse row update for one table: ``table[rows] = values``.

    ``rows`` are GLOBAL row ids (int64, ascending, unique), ``values``
    is ``(len(rows), *row_shape)``; ``num_rows`` is the full table's
    first dimension so restore can materialize at any world size.
    """

    __slots__ = ("rows", "values", "num_rows")

    def __init__(self, rows, values, num_rows: int):
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
        values = np.ascontiguousarray(np.asarray(values))
        if rows.ndim != 1:
            raise ValueError("RowDelta rows must be 1-D, got shape %s"
                             % (rows.shape,))
        if len(values) != len(rows):
            raise ValueError(
                "RowDelta rows/values length mismatch: %d rows vs %d "
                "value rows" % (len(rows), len(values)))
        if len(rows) and (rows.min() < 0 or rows.max() >= num_rows):
            raise ValueError(
                "RowDelta row ids out of range [0, %d): min %d max %d"
                % (num_rows, rows.min(), rows.max()))
        self.rows = rows
        self.values = values
        self.num_rows = int(num_rows)

    def __reduce__(self):
        # Explicit pickle shape: keeps the on-disk format independent
        # of __slots__ internals (a future field rides the tuple).
        return (self.__class__,
                (self.rows, self.values, self.num_rows))

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.values.nbytes)

    def merged_with(self, newer: "RowDelta") -> "RowDelta":
        """Overlay ``newer`` on self: newer rows win, unseen rows keep
        their old values.  Both operands stay untouched."""
        if newer.num_rows != self.num_rows:
            raise ValueError(
                "RowDelta table size changed mid-chain: %d -> %d"
                % (self.num_rows, newer.num_rows))
        if not len(newer.rows):
            return self
        if not len(self.rows):
            return newer
        keep = ~np.isin(self.rows, newer.rows, assume_unique=True)
        rows = np.concatenate([self.rows[keep], newer.rows])
        values = np.concatenate([self.values[keep], newer.values])
        order = np.argsort(rows, kind="stable")
        return RowDelta(rows[order], values[order], self.num_rows)

    def apply_to(self, table: np.ndarray) -> np.ndarray:
        """Scatter this delta's rows into a full table array
        (in place; returns ``table``)."""
        if len(table) != self.num_rows:
            raise ValueError(
                "RowDelta for a %d-row table applied to a %d-row "
                "array" % (self.num_rows, len(table)))
        if len(self.rows):
            table[self.rows] = self.values
        return table

    def __eq__(self, other):
        return (isinstance(other, RowDelta)
                and self.num_rows == other.num_rows
                and np.array_equal(self.rows, other.rows)
                and np.array_equal(self.values, other.values)
                and self.values.dtype == other.values.dtype)

    def __repr__(self):
        return ("RowDelta(%d/%d rows, %s)"
                % (len(self.rows), self.num_rows, self.values.dtype))


def merge_item(base, newer):
    """Chain-replay merge rule for one item name: RowDeltas overlay
    row-wise; anything else is replaced by the newer value."""
    if isinstance(base, RowDelta) and isinstance(newer, RowDelta):
        return base.merged_with(newer)
    return newer


def merge_items(accumulated: Dict[str, object],
                step_items: Dict[str, object]) -> Dict[str, object]:
    """Apply one chain step's items onto the accumulated state (base
    first, tip last).  Mutates and returns ``accumulated``."""
    for name, value in step_items.items():
        prev = accumulated.get(name)
        accumulated[name] = merge_item(prev, value) \
            if prev is not None else value
    return accumulated


def assemble_table(items: Dict[str, object], prefix: str,
                   dtype=None) -> Optional[np.ndarray]:
    """Materialize a full ``(num_rows, *row_shape)`` table from every
    RowDelta item whose name starts with ``prefix`` (one item per
    writing rank — any historical world size).  Returns None when no
    matching item exists; raises when the union of shards does not
    cover the table (a restore from deltas whose base is gone)."""
    shards = [v for n, v in sorted(items.items())
              if n.startswith(prefix) and isinstance(v, RowDelta)]
    if not shards:
        return None
    num_rows = shards[0].num_rows
    row_shape = shards[0].values.shape[1:]
    out_dtype = dtype or shards[0].values.dtype
    table = np.zeros((num_rows,) + row_shape, out_dtype)
    covered = np.zeros(num_rows, bool)
    for sh in shards:
        sh.apply_to(table)
        covered[sh.rows] = True
    if not covered.all():
        missing = int((~covered).sum())
        raise ValueError(
            "table %r: %d of %d rows covered by no shard (delta chain "
            "without its base?)" % (prefix, missing, num_rows))
    return table


def delta_stats(items: Iterable[object]) -> Tuple[int, int]:
    """(rows, bytes) summed over the RowDelta items in ``items``."""
    rows = nbytes = 0
    for v in items:
        if isinstance(v, RowDelta):
            rows += len(v.rows)
            nbytes += v.nbytes
    return rows, nbytes
