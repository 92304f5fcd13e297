"""Data materialization for the estimator API.

The reference materializes the DataFrame to Parquet via Petastorm and
reads it back with per-worker shard readers (reference:
spark/common/util.py prepare_data/get_simple_meta_from_parquet).
As in :mod:`horovod_tpu.spark.util` (this is its copy, numpy only, so
each package reads the other's shards), the intermediate format is
plain npz column shards — memory-mappable and numpy-native — with a
JSON metadata sidecar.  The contract is the same: ``prepare_data``
writes train/val shards + metadata into the Store; ``data_shards``
gives a rank its partition.
"""

import io
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

METADATA_FILE = "_metadata.json"


def _to_pandas(df):
    """Accept a pandas DataFrame or a pyspark DataFrame."""
    if hasattr(df, "toPandas"):       # pyspark
        return df.toPandas()
    return df


def prepare_data(num_partitions: int, store, df,
                 feature_cols: Sequence[str], label_cols: Sequence[str],
                 validation=None, seed: int = 0) -> Dict:
    """Materialize ``df`` into npz shards under the store's train/val
    paths and return the metadata dict (also written as a sidecar).

    ``validation``: None, a float fraction for a random split, or a
    column name whose truthy rows go to the validation set (reference:
    spark/common/params.py validation semantics).
    """
    pdf = _to_pandas(df)
    cols = list(feature_cols) + list(label_cols)
    missing = [c for c in cols if c not in pdf.columns]
    if missing:
        raise ValueError(f"columns {missing} not in DataFrame "
                         f"(has {list(pdf.columns)})")

    arrays = {}
    for c in cols:
        v = np.asarray(pdf[c].tolist())
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        arrays[c] = v
    n = len(pdf)

    rng = np.random.RandomState(seed)
    if validation is None:
        val_mask = np.zeros(n, dtype=bool)
    elif isinstance(validation, str):
        val_mask = np.asarray(pdf[validation].tolist()).astype(bool)
    else:
        val_mask = rng.rand(n) < float(validation)

    meta = {"columns": {}, "train_rows": 0, "val_rows": 0,
            "num_partitions": num_partitions}
    for split, mask, path in (
            ("train", ~val_mask, store.get_train_data_path()),
            ("val", val_mask, store.get_val_data_path())):
        # Clear any previously materialized shards: a re-fit with fewer
        # partitions must not leave stale part files that data_shards
        # would silently mix into training.
        store.delete(path)
        rows = int(mask.sum())
        meta[f"{split}_rows"] = rows
        if split == "val" and rows == 0:
            continue
        idx = np.nonzero(mask)[0]
        rng.shuffle(idx)
        parts = np.array_split(idx, num_partitions)
        # Per-part row counts ride the metadata so workers can size
        # steps_per_epoch without opening a single shard.
        meta[f"{split}_part_rows"] = [len(p) for p in parts]
        for i, part in enumerate(parts):
            shard = {c: arrays[c][part] for c in cols}
            buf = io.BytesIO()
            np.savez(buf, **shard)
            store.write(os.path.join(path, f"part-{i:05d}.npz"),
                        buf.getvalue())
    row_bytes = sum(arrays[c][0:1].nbytes for c in cols) if n else 0
    meta["avg_row_size"] = row_bytes
    for c in cols:
        meta["columns"][c] = {"dtype": str(arrays[c].dtype),
                              "shape": list(arrays[c].shape[1:])}
    store.write(os.path.join(store.get_train_data_path(), METADATA_FILE),
                json.dumps(meta).encode())
    return meta


def read_metadata(store) -> Dict:
    raw = store.read(os.path.join(store.get_train_data_path(),
                                  METADATA_FILE))
    return json.loads(raw.decode())


def data_shards(store, split: str, rank: int, size: int,
                cols: Sequence[str]) -> Dict[str, np.ndarray]:
    """Load this rank's partitions of a split, concatenated per column.

    Partitions are assigned round-robin by rank (reference:
    partitions_per_process assignment, spark/common/util.py)."""
    path = (store.get_train_data_path() if split == "train"
            else store.get_val_data_path())
    parts = sorted(store.list(path, "part-*.npz"))
    mine = parts[rank::size]
    out: Dict[str, List[np.ndarray]] = {c: [] for c in cols}
    for p in mine:
        with np.load(io.BytesIO(store.read(p))) as z:
            for c in cols:
                out[c].append(z[c])
    return {c: (np.concatenate(v) if v else np.zeros((0,)))
            for c, v in out.items()}


def stream_batches(store, split: str, rank: int, size: int,
                   cols: Sequence[str], batch_size: int,
                   seed: int = 0, shuffle: bool = True,
                   drop_remainder: bool = False):
    """Streaming batch iterator over this rank's partitions: at most
    ONE part file is resident at a time, so datasets larger than
    worker memory train fine as long as individual partitions fit
    (reference: the Estimator streams Petastorm parquet row-groups,
    spark/common/estimator.py:25-108 + petastorm readers).

    Shuffle granularity matches Petastorm's trade: part-file order and
    within-part row order are reshuffled per seed (pass seed+epoch for
    a fresh epoch order); rows never shuffle ACROSS parts — prepare
    shuffles rows into parts once at materialization, so the
    two-level shuffle approximates a global one.  Remainder rows of
    each part carry into the next part's first batch; a final short
    batch is yielded unless ``drop_remainder``.
    """
    path = (store.get_train_data_path() if split == "train"
            else store.get_val_data_path())
    parts = sorted(store.list(path, "part-*.npz"))
    mine = list(parts[rank::size])
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(mine)
    leftover: Optional[Dict[str, np.ndarray]] = None  # < batch_size

    for p in mine:
        with store.open_read(p) as f, np.load(f) as z:
            block = {c: z[c] for c in cols}
        n = len(next(iter(block.values()))) if block else 0
        if n == 0:
            continue
        if shuffle:
            idx = rng.permutation(n)
            block = {c: v[idx] for c, v in block.items()}
        if leftover is not None:
            block = {c: np.concatenate([leftover[c], block[c]])
                     for c in cols}
            n = len(next(iter(block.values())))
            leftover = None
        stop = (n // batch_size) * batch_size
        for s in range(0, stop, batch_size):
            yield tuple(block[c][s:s + batch_size] for c in cols)
        if stop < n:
            leftover = {c: block[c][stop:] for c in cols}
    if leftover is not None and not drop_remainder:
        yield tuple(leftover[c] for c in cols)


def shard_rows(meta: Dict, split: str, rank: int, size: int) -> int:
    """Rows this rank will stream for ``split``, from metadata alone.
    Metadata written before per-part counts existed falls back to an
    even distribution of the split total (an ESTIMATE — use
    :func:`part_row_counts` when exactness matters)."""
    part_rows = meta.get(f"{split}_part_rows")
    if part_rows is not None:
        return int(sum(part_rows[rank::size]))
    total = int(meta.get(f"{split}_rows", 0))
    base, rem = divmod(total, max(size, 1))
    return base + (1 if rank < rem else 0)


def part_row_counts(store, split: str, col: str) -> List[int]:
    """Exact per-part row counts read from the npz member HEADERS (a
    few hundred bytes per part, no data) — the recovery path for
    legacy metadata that predates ``<split>_part_rows``."""
    import zipfile
    from numpy.lib import format as npf

    path = (store.get_train_data_path() if split == "train"
            else store.get_val_data_path())
    counts = []
    for p in sorted(store.list(path, "part-*.npz")):
        with store.open_read(p) as f, zipfile.ZipFile(f) as zf:
            with zf.open(col + ".npy") as m:
                version = npf.read_magic(m)
                if version >= (2, 0):
                    shape, _, _ = npf.read_array_header_2_0(m)
                else:
                    shape, _, _ = npf.read_array_header_1_0(m)
        counts.append(int(shape[0]) if shape else 1)
    return counts


def sync_steps_per_epoch(meta: Dict, split: str, size: int,
                         batch_size: int, ceil: bool = False,
                         store=None, col: Optional[str] = None) -> int:
    """Per-epoch step count EVERY rank can run: the minimum over
    ranks' shard sizes.  Synchronous DP allreduces once per batch, so
    a rank running extra steps would block forever in a collective its
    peers never join (reference: the coordinator only fires a tensor
    once all ranks submit it, controller.cc IncrementTensorCount).

    Row counts come from the metadata's per-part table; for legacy
    metadata without one, pass ``store``+``col`` so the EXACT counts
    are read from shard headers — the even-split estimate must never
    size a synchronized step count (a rank whose true shard is
    smaller than the estimate would still desync).  Raises if any
    rank would stream nothing at all."""
    part_rows = meta.get(f"{split}_part_rows")
    if part_rows is None and store is not None and col is not None:
        part_rows = part_row_counts(store, split, col)
    if part_rows is not None:
        rows = [int(sum(part_rows[r::size])) for r in range(size)]
    else:
        rows = [shard_rows(meta, split, r, size) for r in range(size)]
    if min(rows) == 0:
        empty = [r for r, n in enumerate(rows) if n == 0]
        raise ValueError(
            f"rank(s) {empty} of {size} have no {split} rows "
            f"({meta.get(f'{split}_rows', 0)} total); use fewer "
            "workers or more data")
    if ceil:
        return max(min(-(-n // batch_size) for n in rows), 1)
    return max(min(n // batch_size for n in rows), 1)


def batches(shard: Dict[str, np.ndarray], cols: Sequence[str],
            batch_size: int, seed: int = 0, shuffle: bool = True,
            drop_remainder: bool = True):
    """Yield per-column batch tuples from a shard, at one static batch
    shape unless ``drop_remainder`` is off."""
    n = len(next(iter(shard.values()))) if shard else 0
    if n == 0:
        return
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    stop = n - batch_size + 1 if drop_remainder else n
    if stop <= 0 and not drop_remainder:
        stop = n
    for s in range(0, max(stop, 0), batch_size):
        sel = idx[s:s + batch_size]
        yield tuple(shard[c][sel] for c in cols)
