"""CheckpointManager: the async sharded save/restore pipeline.

Save path (per rank)::

    save_async(step, items)            # returns immediately
      └─ writer thread:
           serialize own shard  ──  ckpt.serialize
           write + fsync + rename    ckpt.shard_write[.torn]
           prepare mark              ckpt.prepare
           (rank 0 only) gather all marks → write MANIFEST → GC
                                     ckpt.manifest_publish

``save_async`` captures only a shallow dict of host-side references —
the elastic ``State.save()`` that precedes it already copied device
values to host, and its snapshots are rebound (never mutated in place)
on the next save, so the writer thread serializes a stable view while
training runs ahead.  The pipeline is double-buffered: one save in
flight, one queued; queuing a third supersedes the queued one (its
outcome is recorded as ``superseded``).

Restore path: newest committed step first, full checksum verification,
fall back to the previous committed step when anything fails
validation.  Restoring at world size M from an N-way checkpoint reads
the manifest layout and merges the N shards — the caller re-shards by
construction since the item dict is world-shape-independent.

Differential checkpoints (Check-N-Run shape; see delta.py): a save
may declare itself a *delta* over the newest committed step
(``delta_of``), persisting only rows touched since then as
:class:`~.delta.RowDelta` items plus whatever small dense items the
caller passes in full.  The manifest records the chain link
(``meta.delta_of`` / ``base_step`` / ``chain_len``); restore walks
the chain to its base and replays the steps in order with the same
per-shard checksum verification, so a corrupt link invalidates the
tip exactly like a corrupt dense shard.  ``delta_plan()`` bounds the
chain with ``HOROVOD_CKPT_DELTA_CHAIN_MAX`` and forces a full base
after a world-size change; GC never reaps a kept step's ancestors.

Rank-local items (``local_items``): model-parallel state (sharded
embedding rows) is NOT replicated across ranks, so it cannot ride the
round-robin item partition — each rank writes its ``local_items``
(globally unique names, e.g. suffixed with the rank) into its own
shard and the manifest layout is extended from the prepare marks.

Counterpart of :mod:`horovod_tpu.checkpoint.manager`, copied.
"""

import logging
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import env as _env
from ..common import failpoints as _fp
from ..common import flight_recorder as _fr
from ..common import metrics
from . import delta as _delta
from . import manifest as _mf
from . import shard_io
from .coordinator import CommitCoordinator, LocalCommitCoordinator

logger = logging.getLogger("horovod_tpu_torch.checkpoint")


class CheckpointError(RuntimeError):
    pass


class CheckpointNotFoundError(CheckpointError):
    """No committed-and-valid checkpoint exists under the directory."""


_SAVE_SECONDS = metrics.histogram(
    "hvd_ckpt_save_seconds",
    "Checkpoint save latency by phase (capture is the part training "
    "blocks on; write/commit overlap training)")
_RESTORE_SECONDS = metrics.histogram(
    "hvd_ckpt_restore_seconds", "Checkpoint restore latency by phase")
_BYTES = metrics.counter(
    "hvd_ckpt_bytes_total", "Checkpoint bytes by direction")
_COMMITS = metrics.counter(
    "hvd_ckpt_commits_total",
    "Checkpoint save outcomes by kind "
    "(committed/prepared/failed/superseded)")
_FALLBACKS = metrics.counter(
    "hvd_ckpt_restore_fallbacks_total",
    "Restores that skipped an invalid newest checkpoint")
_GC_REMOVED = metrics.counter(
    "hvd_ckpt_gc_removed_total", "Checkpoint step dirs removed by GC")
_PENDING = metrics.gauge(
    "hvd_ckpt_pending_saves", "Snapshots captured but not yet durable")
_DELTA_ROWS = metrics.counter(
    "hvd_ckpt_delta_rows_total",
    "Table rows persisted by differential (RowDelta) checkpoint items")
_DELTA_BYTES = metrics.counter(
    "hvd_ckpt_delta_bytes_total",
    "Payload bytes of differential (RowDelta) checkpoint items")
_DELTA_CHAIN = metrics.gauge(
    "hvd_ckpt_delta_chain_len",
    "Length of the committed delta chain (0 = tip is a full base)")
_RESTORE_CHAIN_LINKS = metrics.histogram(
    "hvd_ckpt_restore_chain_links",
    "Steps replayed per restore (1 = plain full checkpoint)",
    bounds=metrics.log_bounds(1.0, 2.0, 10))


class _Pending:
    __slots__ = ("step", "items", "local_items", "delta_of", "done",
                 "outcome", "error")

    def __init__(self, step: int, items: Dict[str, object],
                 local_items: Optional[Dict[str, object]] = None,
                 delta_of: Optional[int] = None):
        self.step = step
        self.items = items
        self.local_items = local_items or {}
        self.delta_of = delta_of
        self.done = threading.Event()
        self.outcome: Optional[str] = None
        self.error: Optional[BaseException] = None


class CheckpointManager:
    """Durable sharded checkpoints under one root directory.

    One instance per (rank, incarnation); rebuild it after an elastic
    resize (cheap — the on-disk state is the only state that matters).
    ``rank``/``world_size`` describe the SAVING layout; restore works
    regardless of the layout a checkpoint was written with.

    The directory must be shared storage when ``world_size > 1``
    (same-host path, NFS, or a FUSE-mounted bucket): rank 0 validates
    peers' shards only through their prepare-mark checksums, and
    restore reads every shard.
    """

    def __init__(self, directory: str, rank: int = 0,
                 world_size: int = 1,
                 coordinator: Optional[CommitCoordinator] = None,
                 keep: Optional[int] = 3,
                 commit_timeout_s: float = 60.0):
        if world_size > 1 and coordinator is None:
            raise ValueError(
                "multi-rank checkpointing needs a shared "
                "CommitCoordinator (Local for threads, KV for "
                "processes)")
        self.directory = str(directory)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.keep = keep
        self.commit_timeout_s = commit_timeout_s
        self.coordinator = coordinator or LocalCommitCoordinator()
        self._lock = threading.Lock()
        self._queued: Optional[_Pending] = None
        self._inflight: Optional[_Pending] = None
        self._wake = threading.Event()
        self._closed = False
        self._writer: Optional[threading.Thread] = None
        self._outcomes: Dict[int, str] = {}
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------
    # save pipeline
    # ------------------------------------------------------------------
    def save_async(self, step: int, items: Dict[str, object],
                   local_items: Optional[Dict[str, object]] = None,
                   delta_of: Optional[int] = None):
        """Enqueue a snapshot for durable write; returns after the
        host-side capture (a shallow reference copy — see module
        docstring for why that is a stable view).

        ``items`` is the replicated dict (identical on every rank,
        round-robin sharded).  ``local_items`` are THIS rank's
        model-parallel items, written into its own shard regardless of
        the partition; names must be globally unique.  ``delta_of``
        declares the save a differential step over that committed
        parent (use :meth:`delta_plan` to pick it) — every rank must
        pass the same value or the commit is rejected."""
        t0 = time.perf_counter()
        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        if not isinstance(items, dict):
            raise ValueError("checkpoint items must be a dict of "
                             "name -> object")
        if not items and not local_items:
            raise ValueError("checkpoint items must be a non-empty "
                             "dict of name -> object")
        pending = _Pending(int(step), dict(items),
                           dict(local_items or {}),
                           None if delta_of is None else int(delta_of))
        with self._lock:
            superseded = self._queued
            self._queued = pending
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop,
                    name="hvd-ckpt-writer-r%d" % self.rank, daemon=True)
                self._writer.start()
        if superseded is not None:
            superseded.outcome = "superseded"
            superseded.done.set()
            self._record_outcome(superseded)
        _PENDING.inc()
        self._wake.set()
        _SAVE_SECONDS.observe(time.perf_counter() - t0, phase="capture")

    def save(self, step: int, items: Dict[str, object],
             timeout: Optional[float] = None,
             local_items: Optional[Dict[str, object]] = None,
             delta_of: Optional[int] = None) -> str:
        """Synchronous save; returns the outcome (``committed`` on the
        arbiter, ``prepared`` on other ranks).  Raises on failure."""
        self.save_async(step, items, local_items=local_items,
                        delta_of=delta_of)
        if not self.wait(timeout):
            raise CheckpointError("checkpoint save timed out")
        outcome = self._outcomes.get(int(step))
        if outcome not in ("committed", "prepared"):
            raise CheckpointError(
                "checkpoint step %d not durable: %s"
                % (step, outcome or "unknown"))
        return outcome

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued save reached a terminal outcome;
        False when ``timeout`` expired first."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            with self._lock:
                pending = self._inflight or self._queued
            if pending is None:
                return True
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not pending.done.wait(remaining):
                return False

    def outcome(self, step: int) -> Optional[str]:
        with self._lock:
            return self._outcomes.get(int(step))

    def close(self, timeout: float = 30.0):
        """Drain pending saves (bounded) and stop the writer."""
        self.wait(timeout)
        self._closed = True
        self._wake.set()
        w = self._writer
        if w is not None:
            w.join(timeout=5.0)

    def abort(self):
        """Emergency teardown: drop the queued snapshot (outcome
        ``aborted``) and refuse further saves.  The in-flight write,
        if any, runs to completion — it is atomic either way.  Used on
        fatal errors and by harnesses modeling a process death."""
        with self._lock:
            self._closed = True
            dropped, self._queued = self._queued, None
        self._wake.set()
        if dropped is not None:
            dropped.outcome = "aborted"
            dropped.done.set()
            self._record_outcome(dropped)

    def _record_outcome(self, pending: "_Pending"):
        with self._lock:
            self._outcomes[pending.step] = pending.outcome
        _COMMITS.inc(1, outcome=pending.outcome)
        _PENDING.dec()

    def _writer_loop(self):
        while True:
            self._wake.wait(0.5)
            with self._lock:
                if self._queued is None:
                    self._wake.clear()
                    if self._closed:
                        return
                    continue
                pending = self._queued
                self._queued = None
                self._inflight = pending
            try:
                pending.outcome = self._write_one(pending)
            except _fp.FailpointError as e:
                pending.outcome = "failed"
                pending.error = e
                logger.warning("ckpt save step %d failed (injected): "
                               "%s", pending.step, e)
            except Exception as e:
                pending.outcome = "failed"
                pending.error = e
                logger.exception("ckpt save step %d failed",
                                 pending.step)
            finally:
                with self._lock:
                    self._inflight = None
                pending.done.set()
                self._record_outcome(pending)

    def _write_one(self, pending: "_Pending") -> str:
        t_start = time.perf_counter()
        step, items = pending.step, pending.items
        layout = _mf.assign_shards(list(items), self.world_size)
        own = sorted(n for n, r in layout.items() if r == self.rank)
        own_items = {n: items[n] for n in own}
        own_items.update(pending.local_items)
        sdir = _mf.step_dir(self.directory, step)
        os.makedirs(sdir, exist_ok=True)

        if pending.delta_of is not None and _fp.ENABLED:
            # Failpoint site: a differential save about to hit disk.
            # crash() models a rank dying mid-delta-write — the chain
            # tip must stay the last COMMITTED base+delta state, never
            # a torn or partially-applied link.
            _fp.maybe_fail("ckpt.delta_write", rank=self.rank)

        payload = shard_io.serialize_items(own_items, rank=self.rank)
        _SAVE_SECONDS.observe(time.perf_counter() - t_start,
                              phase="serialize")
        d_rows, d_bytes = _delta.delta_stats(own_items.values())
        if d_rows or d_bytes:
            _DELTA_ROWS.inc(d_rows)
            _DELTA_BYTES.inc(d_bytes)

        t_w = time.perf_counter()
        fname = _mf.shard_name(self.rank, self.world_size)
        digest, nbytes = shard_io.write_shard(
            os.path.join(sdir, fname), payload, rank=self.rank)
        _BYTES.inc(nbytes, direction="write")
        _SAVE_SECONDS.observe(time.perf_counter() - t_w, phase="write")

        entry = {"rank": self.rank, "filename": fname,
                 "sha256": digest, "nbytes": nbytes,
                 "items": sorted(own_items)}
        if pending.delta_of is not None:
            entry["delta_of"] = pending.delta_of
        if _fr.ENABLED:
            _fr.record(_fr.CKPT, rank=self.rank, phase="prepare",
                       step=step, nbytes=nbytes,
                       delta_of=pending.delta_of)
        self.coordinator.prepare(step, self.rank, entry)

        if self.rank != 0:
            _SAVE_SECONDS.observe(time.perf_counter() - t_start,
                                  phase="total")
            return "prepared"

        t_c = time.perf_counter()
        marks = self.coordinator.gather(step, self.world_size,
                                        self.commit_timeout_s)
        if marks is None:
            # A rank died (or its mark was lost) mid-checkpoint: the
            # step is abandoned — no manifest, hence invisible.
            _SAVE_SECONDS.observe(time.perf_counter() - t_c,
                                  phase="commit")
            return "failed"
        # Chain agreement: a delta link is only valid when EVERY rank
        # wrote against the same parent — a rank that raced a
        # different delta_plan() answer (e.g. restored later and saw
        # an older tip) would otherwise produce an unreplayable chain.
        parents = {m.get("delta_of") for m in marks}
        if len(parents) > 1 or parents != {pending.delta_of}:
            logger.error(
                "ckpt: step %d abandoned — ranks disagree on the "
                "delta parent (%s)", step, sorted(
                    parents, key=lambda p: (p is None, p)))
            _SAVE_SECONDS.observe(time.perf_counter() - t_c,
                                  phase="commit")
            return "failed"
        meta = {}
        if pending.delta_of is not None:
            try:
                parent = _mf.read_manifest(
                    _mf.step_dir(self.directory, pending.delta_of))
            except (OSError, ValueError) as e:
                # The parent vanished between delta_plan() and commit
                # (GC race, external cleanup): committing would
                # publish an unreplayable tip.
                logger.error("ckpt: step %d abandoned — delta parent "
                             "%d unreadable: %s", step,
                             pending.delta_of, e)
                _SAVE_SECONDS.observe(time.perf_counter() - t_c,
                                      phase="commit")
                return "failed"
            pmeta = parent.meta or {}
            meta = {"delta_of": pending.delta_of,
                    "base_step": int(pmeta.get("base_step",
                                               parent.step)),
                    "chain_len": int(pmeta.get("chain_len", 0)) + 1}
        # The manifest layout extends the replicated partition with
        # every rank's local (model-parallel) items, straight from the
        # prepare marks; the replicated names keep rank 0's layout so
        # a rank that skipped an assigned item is still caught by the
        # restore coverage check.
        for m in marks:
            for n in m.get("items", ()):
                layout.setdefault(n, m["rank"])
        man = _mf.Manifest(step=step, world_size=self.world_size,
                           shards=marks, layout=layout, meta=meta)
        _mf.write_manifest(sdir, man, rank=self.rank)
        self.coordinator.mark_committed(step)
        if _fr.ENABLED:
            _fr.record(_fr.CKPT, rank=self.rank, phase="commit",
                       step=step, outcome="committed",
                       chain_len=meta.get("chain_len", 0))
        _DELTA_CHAIN.set(float(meta.get("chain_len", 0)))
        _SAVE_SECONDS.observe(time.perf_counter() - t_c, phase="commit")
        _SAVE_SECONDS.observe(time.perf_counter() - t_start,
                              phase="total")
        self.gc()
        logger.info(
            "ckpt: step %d committed (%d ranks, %d items%s)", step,
            self.world_size, len(items) + len(pending.local_items),
            ", delta of %d" % pending.delta_of
            if pending.delta_of is not None else "")
        return "committed"

    # ------------------------------------------------------------------
    # differential chain planning
    # ------------------------------------------------------------------
    def delta_plan(self) -> Optional[int]:
        """The parent step the NEXT save may be a delta of, or None
        when it must be a full base: no committed tip yet, the chain
        already at ``HOROVOD_CKPT_DELTA_CHAIN_MAX`` links, or the tip
        was written at a different world size (rank-local shard names
        would not line up across the resize).  Every rank derives the
        same answer from the same committed on-disk state — the commit
        phase cross-checks anyway (see ``_write_one``)."""
        chain_max = _env.ckpt_delta_chain_max()
        if chain_max <= 0:
            return None
        steps = self.committed_steps()
        if not steps:
            return None
        tip = steps[-1]
        try:
            man = _mf.read_manifest(_mf.step_dir(self.directory, tip))
        except (OSError, ValueError):
            return None
        if man.world_size != self.world_size:
            return None
        meta = man.meta or {}
        if int(meta.get("chain_len", 0)) + 1 > chain_max:
            return None
        return tip

    def chain_of(self, step: int) -> List[int]:
        """The steps restore will replay for ``step``, base first.
        Raises :class:`CheckpointCorruptError` on a broken link
        (missing/corrupt parent manifest, a cycle, or a chain longer
        than any legal bound)."""
        chain, seen = [], set()
        cur: Optional[int] = step
        while cur is not None:
            if cur in seen or len(chain) > 100000:
                raise shard_io.CheckpointCorruptError(
                    "step %d: delta chain contains a cycle at %d"
                    % (step, cur))
            seen.add(cur)
            chain.append(cur)
            try:
                man = _mf.read_manifest(
                    _mf.step_dir(self.directory, cur))
            except (OSError, ValueError) as e:
                raise shard_io.CheckpointCorruptError(
                    "step %d: chain link %d has no readable manifest: "
                    "%s" % (step, cur, e))
            parent = (man.meta or {}).get("delta_of")
            cur = None if parent is None else int(parent)
        chain.reverse()
        return chain

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def committed_steps(self) -> List[int]:
        return _mf.committed_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def _read_step_items(self, step: int) -> Dict[str, object]:
        """One step's OWN items (no chain replay), verifying every
        shard against the manifest."""
        sdir = _mf.step_dir(self.directory, step)
        man = _mf.read_manifest(sdir)
        items: Dict[str, object] = {}
        nbytes = 0
        for entry in man.shards:
            shard = shard_io.read_shard(
                os.path.join(sdir, entry["filename"]),
                expect_sha256=entry.get("sha256"))
            missing = set(entry.get("items", [])) - set(shard)
            if missing:
                raise shard_io.CheckpointCorruptError(
                    "shard %s missing items %s"
                    % (entry["filename"], sorted(missing)))
            items.update(shard)
            nbytes += int(entry.get("nbytes", 0))
        uncovered = set(man.layout) - set(items)
        if uncovered:
            raise shard_io.CheckpointCorruptError(
                "step %d: items %s in layout but in no shard"
                % (step, sorted(uncovered)))
        _BYTES.inc(nbytes, direction="read")
        return items

    def step_items(self, step: int) -> Tuple[Dict[str, object],
                                             Optional[int]]:
        """One committed step's OWN items (no chain replay) plus its
        ``delta_of`` parent (None for a full base) — the incremental
        read the serving replica tails with: when the parent equals the
        step a replica already serves, the RowDelta items here are
        exactly the rows that changed.  Verifies every shard against
        the manifest; raises like :meth:`restore` on corruption."""
        sdir = _mf.step_dir(self.directory, step)
        man = _mf.read_manifest(sdir)
        parent = (man.meta or {}).get("delta_of")
        return (self._read_step_items(step),
                None if parent is None else int(parent))

    def restore(self, step: int) -> Dict[str, object]:
        """Restore one step, verifying every shard against its
        manifest.  A differential step replays its whole chain, base
        first — RowDelta items merge row-wise, everything else is
        replaced by the newer value — so the result is bit-identical
        to what a full checkpoint at ``step`` would have stored.
        Raises :class:`CheckpointCorruptError` / ``ValueError`` /
        ``OSError`` when any link fails validation."""
        t0 = time.perf_counter()
        chain = self.chain_of(step)
        items: Dict[str, object] = {}
        for link in chain:
            _delta.merge_items(items, self._read_step_items(link))
        _RESTORE_SECONDS.observe(time.perf_counter() - t0,
                                 phase="total")
        _RESTORE_CHAIN_LINKS.observe(float(len(chain)))
        if _fr.ENABLED:
            _fr.record(_fr.CKPT, rank=self.rank, phase="restore",
                       step=step, chain=len(chain),
                       seconds=round(time.perf_counter() - t0, 4))
        return items

    def restore_latest(self) -> Tuple[int, Dict[str, object]]:
        """Restore the newest VALID committed step, falling back past
        corrupt ones (counted in
        ``hvd_ckpt_restore_fallbacks_total``)."""
        steps = self.committed_steps()
        for step in reversed(steps):
            try:
                return step, self.restore(step)
            except (shard_io.CheckpointCorruptError, ValueError,
                    OSError) as e:
                logger.warning("ckpt: step %d failed validation (%s); "
                               "falling back", step, e)
                _FALLBACKS.inc()
        raise CheckpointNotFoundError(
            "no valid committed checkpoint under %s (checked steps "
            "%s)" % (self.directory, steps))

    # ------------------------------------------------------------------
    # retention
    # ------------------------------------------------------------------
    def gc(self, keep: Optional[int] = None):
        """Keep the newest ``keep`` committed steps; drop older ones
        and any uncommitted step dir older than the newest committed
        step (abandoned two-phase leftovers).  A kept differential
        step pins its whole chain: reaping a base would silently
        invalidate every delta above it."""
        keep = self.keep if keep is None else keep
        if keep is None:
            return
        committed = self.committed_steps()
        kept = committed[-keep:] if keep > 0 else []
        protected = set(kept)
        for step in kept:
            try:
                protected.update(self.chain_of(step))
            except shard_io.CheckpointCorruptError:
                # A broken chain offers nothing to protect; restore
                # will fall back past this step anyway.
                continue
        doomed = set(committed) - protected
        if committed:
            newest = committed[-1]
            doomed.update(s for s in _mf.list_step_dirs(self.directory)
                          if s < newest and s not in committed
                          and s not in protected)
        for step in sorted(doomed):
            sdir = _mf.step_dir(self.directory, step)
            try:
                shutil.rmtree(sdir)
                _GC_REMOVED.inc()
                logger.debug("ckpt gc: removed step %d", step)
            except OSError as e:
                logger.warning("ckpt gc: failed to remove %s: %s",
                               sdir, e)
