"""The elastic driver: monitors host membership, replans rank
assignments, and manages worker processes across resets.

Reference: runner/elastic/driver.py — discovery poll thread
(``_discover_hosts`` :177-196), rank-stable assignment recomputation
(``_update_host_assignments`` :228-260, ≥1 surviving host required
:242-243), worker spawn/respawn, and result collection.

Counterpart of :mod:`horovod_tpu.runner.elastic.driver`, copied; the
locality test is ``runner/gpu_run.is_local``.  Deltas from the reference:
  * every epoch publishes a fresh ``torch.distributed`` store and
    negotiation-controller address in the rendezvous KV store — a world
    change re-forms the process group in place on surviving workers (no
    process restart);
  * workers learn of membership changes by polling the KV discovery
    generation at ``state.commit()`` instead of a per-worker push RPC.
"""

import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ...common import env as env_mod
from ...common import failpoints as _fp
from ...common import flight_recorder as _fr
from ...common import metrics
from ..hosts import (HostInfo, INVALID_SLOT_INFO, SlotInfo,
                     get_host_assignments)
from .discovery import HostDiscovery, HostManager
from .policy import (ElasticPolicy, KIND_SCALE_UP, Signals,
                     TRIGGER_DEATH, TRIGGER_MIGRATION, TRIGGER_SCALE_UP,
                     note_resize, observe_autoscale)
from .registration import WorkerStateRegistry

logger = logging.getLogger("horovod_tpu_torch.elastic")

_EPOCHS = metrics.counter(
    "hvd_elastic_epochs_total",
    "Elastic epochs planned (initial formation + every resize)")
_WORKER_FAILURES = metrics.counter(
    "hvd_elastic_worker_failures_total",
    "In-plan worker processes that exited non-zero")
_WORLD_SIZE = metrics.gauge(
    "hvd_elastic_world_size", "World size of the current elastic epoch")

DISCOVER_HOSTS_FREQUENCY_SECS = 1.0

# KV scopes/keys the driver publishes (worker side reads these).
ELASTIC_SCOPE = "elastic"
KEY_GENERATION = "generation"     # bumped on every discovery change
# Written by the rank-0 worker's coordinator (controller_net
# _make_rank_lost_publisher) when liveness/reconnect machinery
# promotes a rank to lost: the driver polls it so a WEDGED worker —
# whose process never exits, so the spawn monitor never fires — still
# gets its host evicted and the world replanned.  Keyed per rank
# ("lost-<rank>") so correlated failures inside one poll interval
# don't overwrite each other.
KEY_LOST_RANK = "lost-%d"
# Written by the rank-0 coordinator's straggler scorer (controller_net
# _make_rank_slow_publisher) as a HEARTBEAT while a rank stays flagged
# slow: the driver's migration policy treats a notice fresher than
# SLOW_NOTICE_STALE_S as "flagged right now" — a recovered rank simply
# stops being republished and its notice ages out.  A rank with a
# LOST notice is dead, not slow; the death path owns it.
KEY_SLOW_RANK = "slow-%d"
SLOW_NOTICE_STALE_S = 10.0  # ~5x the scorer's republish heartbeat
# Written by the rank-0 coordinator's SLO plane (controller_net
# _make_slo_publisher) on burn-rate alert crossings: the job-level
# load reading (achieved steps/s + cycle time over the short window)
# the driver folds into ElasticPolicy.Signals — consumed read-only
# until the SLO-driven resize controller lands (ROADMAP item 4).  One
# key, not per-rank: the SLIs are a job-level reading.
KEY_SLO = "slo"
SLO_NOTICE_STALE_S = 60.0   # alerts re-fire every ~30s while burning
# Driver-process metrics snapshot, readable through the (job-secret
# guarded) rendezvous HTTP server at GET /metrics/driver — the driver
# has no worker /metrics endpoint, so the KV store is its read path.
METRICS_SCOPE = "metrics"
KEY_DRIVER_METRICS = "driver"
# Durable-checkpoint coordination scope (shared with
# checkpoint/coordinator.py KVCommitCoordinator): the driver seeds
# ckpt/latest from disk at startup so a job restarted after a
# whole-job preemption learns the restore point before any worker has
# rendezvoused (restart-from-latest-valid).
from ...checkpoint import ENV_DIR as ENV_CKPT_DIR
from ...checkpoint.coordinator import KEY_LATEST as KEY_CKPT_LATEST
from ...checkpoint.coordinator import SCOPE as CKPT_SCOPE



class _LiveWorker:
    def __init__(self, slot: SlotInfo, epoch: int,
                 thread: threading.Thread):
        self.slot = slot
        self.epoch = epoch
        self.thread = thread


class ElasticDriver:
    def __init__(self, rendezvous, discovery: HostDiscovery, min_np: int,
                 max_np: Optional[int] = None, timeout: float = 600,
                 reset_limit: Optional[int] = None, verbose: int = 0):
        self._rendezvous = rendezvous
        self._host_manager = HostManager(discovery)
        self._min_np = min_np
        self._max_np = max_np
        self._timeout = timeout
        self._verbose = verbose
        self._registry = WorkerStateRegistry(self, self._host_manager,
                                             reset_limit=reset_limit)
        self._create_worker_fn: Optional[Callable] = None

        self._lock = threading.RLock()
        self._assign_cond = threading.Condition(self._lock)
        self._epoch = 0
        self._world_size = 0
        self._host_assignments: Dict[str, List[SlotInfo]] = {}
        self._rank0_addr: Optional[str] = None
        self._world_info: Dict = {}
        self._live: Dict[Tuple[str, int], _LiveWorker] = {}
        self._results: Dict[str, int] = {}     # "host:slot" -> exit code
        self._generation = 0

        self._shutdown = threading.Event()
        self._error_message: Optional[str] = None
        self._ckpt_latest: Optional[int] = None
        self._lost_handled: set = set()   # (epoch, rank) dedup

        # Closed-loop elasticity (docs/failure_recovery.md
        # "Autoscaling"): the policy decides WHEN to resize; the
        # driver actuates.  _resize_trigger labels the next plan's
        # resize for metrics + the flight-recorder verdict.
        self._policy = ElasticPolicy(min_np, max_np)
        self._slow_active: Dict[int, float] = {}   # rank -> score
        self._migration: Optional[Dict] = None     # in-flight evict
        self._resize_trigger: Optional[str] = None
        self._last_planned_size = 0
        self._discovery_thread = threading.Thread(
            target=self._discover_hosts, name="hvd-elastic-discovery",
            daemon=True)

    # ------------------------------------------------------------------
    # public API (used by the launcher and the rendezvous handler)
    # ------------------------------------------------------------------
    @property
    def registry(self) -> WorkerStateRegistry:
        return self._registry

    @property
    def host_manager(self) -> HostManager:
        return self._host_manager

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def start(self, np: int, create_worker_fn: Callable[[SlotInfo], int]):
        """Wait for min_np slots, plan the first epoch, spawn workers."""
        self._create_worker_fn = create_worker_fn
        self._seed_ckpt_latest()
        self.wait_for_available_slots(max(np or 0, self._min_np))
        with self._lock:
            self._plan_epoch()
            self._registry.reset(self._world_size)
            self._spawn_missing()
        self._discovery_thread.start()

    def record_ready(self, host: str, slot: int):
        self._registry.record_ready(host, slot)

    def get_slot_info(self, host: str, local_rank: int, last_epoch: int,
                      timeout: float = 10.0) -> Tuple[SlotInfo, Dict, int]:
        """Blocks (bounded) until an epoch newer than ``last_epoch`` is
        planned; returns (slot_info, world_info, epoch).  slot_info is
        INVALID_SLOT_INFO when the slot was retired from the plan."""
        deadline = time.monotonic() + timeout
        with self._assign_cond:
            while self._epoch <= last_epoch and not self._shutdown.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None, {}, self._epoch   # still pending
                self._assign_cond.wait(remaining)
            if self._shutdown.is_set():
                return INVALID_SLOT_INFO, dict(self._world_info), self._epoch
            for s in self._host_assignments.get(host, []):
                if s.local_rank == local_rank:
                    return s, dict(self._world_info), self._epoch
            return INVALID_SLOT_INFO, dict(self._world_info), self._epoch

    def resume(self):
        """Replan the world after a barrier evaluation and (re)spawn
        worker processes for slots without a live worker."""
        with self._lock:
            if self._shutdown.is_set():
                return
            # Failure-driven resume: hosts held pending by the
            # scale-up gate become replacements for whatever just
            # died — backfilling LOST capacity is not growth, so it is
            # not gated on HOROVOD_ELASTIC_SCALE_UP or the policy; the
            # slot cap keeps it from growing past the last plan.
            needed = self._last_planned_size - \
                self._host_manager.available_slots()
            if needed > 0:
                admitted = self._host_manager.admit_pending(
                    max_slots=needed)
                if admitted:
                    logger.info("elastic: admitted pending host(s) %s "
                                "as replacements", admitted)
            if not self._wait_for_min_slots_locked():
                return
            self._plan_epoch()
            self._registry.reset(self._world_size)
            self._spawn_missing()

    def stop(self, error_message: Optional[str] = None):
        with self._assign_cond:
            self._error_message = error_message or self._error_message
            self._shutdown.set()
            self._assign_cond.notify_all()

    def finished(self) -> bool:
        return self._shutdown.is_set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until the run finishes; returns True on clean finish,
        False when the timeout expired or the run errored."""
        deadline = None if timeout is None else time.monotonic() + timeout
        finished = self._shutdown.wait(timeout)
        if not finished:
            return False
        # Let worker monitor threads drain.
        for lw in list(self._live.values()):
            t = None if deadline is None else max(0.0,
                                                  deadline - time.monotonic())
            lw.thread.join(t)
        return self._error_message is None

    @property
    def error_message(self) -> Optional[str]:
        return self._error_message

    def get_results(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._results)

    def wait_for_available_slots(self, min_np: int):
        """Poll discovery until at least min_np slots exist (reference:
        driver.py wait_for_available_slots)."""
        deadline = time.monotonic() + self._timeout
        while time.monotonic() < deadline:
            self._host_manager.update_available_hosts()
            if self._host_manager.available_slots() >= min_np:
                return
            if self._shutdown.is_set():
                raise RuntimeError("elastic driver shut down while waiting "
                                   "for hosts")
            time.sleep(DISCOVER_HOSTS_FREQUENCY_SECS)
        raise TimeoutError(
            f"Timed out waiting for {min_np} slots; only "
            f"{self._host_manager.available_slots()} available.")

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _wait_for_min_slots_locked(self) -> bool:
        if self._host_manager.available_slots() >= self._min_np:
            return True
        # Release the lock while waiting so discovery can make progress.
        self._lock.release()
        try:
            self.wait_for_available_slots(self._min_np)
            return True
        except TimeoutError as e:
            self.stop(error_message=str(e))
            return False
        finally:
            self._lock.acquire()

    def _plan_epoch(self):
        """Compute rank-stable assignments for a new epoch and publish
        the epoch's world info (coordinator/controller endpoints)."""
        current = self._host_manager.current_hosts
        if not current:
            raise RuntimeError("no hosts available to plan an epoch")
        host_infos = [HostInfo(h, s) for h, s in current.items()]
        slots = get_host_assignments(host_infos, self._min_np,
                                     self._max_np)
        self._epoch += 1
        self._world_size = slots[0].size if slots else 0
        _EPOCHS.inc()
        _WORLD_SIZE.set(self._world_size)
        # Label the resize for the autoscale lane: direction from the
        # size delta, trigger from whoever initiated it (the policy
        # stamps _resize_trigger before actuating; an unlabeled shrink
        # is a death, an unlabeled growth is legacy immediate-admit
        # discovery).  Epoch 1 is formation, not a resize.
        prev_size = self._last_planned_size
        self._last_planned_size = self._world_size
        trigger = self._resize_trigger
        self._resize_trigger = None
        if prev_size and self._world_size != prev_size:
            direction = "up" if self._world_size > prev_size else "down"
            if trigger is None:
                trigger = TRIGGER_SCALE_UP if direction == "up" \
                    else TRIGGER_DEATH
            note_resize(direction, trigger)
            if trigger == TRIGGER_DEATH:
                # Post-recovery cycles are noisy; give the policy the
                # same refractory period its own decisions get.
                self._policy.note_external_resize()
        else:
            # Same-size replan (1:1 replacement) or first formation —
            # not a resize, so no counter; the FR label still says
            # which.
            trigger = "formation" if prev_size == 0 else "replacement"
        assignments: Dict[str, List[SlotInfo]] = OrderedDict()
        for s in slots:
            assignments.setdefault(s.hostname, []).append(s)
        self._host_assignments = assignments
        self._rank0_addr = slots[0].hostname
        rank0 = slots[0].hostname
        # Local host aliases must resolve from every worker; keep
        # loopback for single-host runs, hostname otherwise.
        from ..gpu_run import is_local
        addr = "127.0.0.1" if is_local(rank0) else rank0
        # The coordinator/controller ports are chosen by the rank-0
        # WORKER on its own host (a port free on the driver machine may
        # be taken on rank 0's host) and published back through the
        # rendezvous KV under elastic_endpoints/<epoch>; the driver only
        # advertises the address workers should combine those ports
        # with.
        self._world_info = {
            "epoch": self._epoch,
            "size": self._world_size,
            "rank0_addr": addr,
            # Discovery generation this plan reflects: workers seed
            # their change-poll with it, so a change landing between
            # plan and worker init is still noticed.
            "generation": self._generation,
        }
        if self._ckpt_latest is not None:
            # Restart-from-latest-valid: every plan advertises the
            # newest committed checkpoint step known at job start, so
            # workers (even ones joining epochs later) restore before
            # the first sync instead of re-deriving it from disk scans.
            self._world_info["ckpt_latest_step"] = self._ckpt_latest
        if self._rendezvous is not None:
            self._rendezvous.init(self._host_assignments)
        if _fr.ENABLED:
            _fr.record(_fr.ELASTIC, rank="driver", event="epoch_plan",
                       epoch=self._epoch, size=self._world_size,
                       trigger=trigger)
        logger.info("elastic: epoch %d planned, size=%d hosts=%s",
                    self._epoch, self._world_size, list(current.keys()))
        self._publish_metrics()
        self._assign_cond.notify_all()

    def _spawn_missing(self):
        for host, slots in self._host_assignments.items():
            for slot in slots:
                key = (host, slot.local_rank)
                lw = self._live.get(key)
                if lw is not None and lw.thread.is_alive():
                    continue
                self._spawn(slot)

    def _spawn(self, slot: SlotInfo):
        key = (slot.hostname, slot.local_rank)
        epoch = self._epoch

        def monitor():
            try:
                # Failpoint site: worker lifecycle, evaluated where the
                # driver owns the spawn.  crash()/error() stand in for
                # a worker that dies before (or instead of) running —
                # the registry records the failure and the reset
                # machinery replans, exactly as for a real non-zero
                # exit.  crash_ok: the DRIVER must survive; it is the
                # worker's death being modeled.
                if _fp.ENABLED and _fp.maybe_fail(
                        "elastic.worker", rank=slot.rank, epoch=epoch,
                        crash_ok=True) == "crash":
                    raise _fp.FailpointError(
                        "elastic.worker: injected worker crash "
                        "(rank %d, epoch %d)" % (slot.rank, epoch))
                code = self._create_worker_fn(slot)
            except Exception:
                logger.exception("worker launch failed for %s", key)
                code = 1
            self._on_worker_exit(slot.hostname, slot.local_rank, code)

        t = threading.Thread(target=monitor,
                             name=f"hvd-elastic-{slot.hostname}-"
                                  f"{slot.local_rank}",
                             daemon=True)
        self._live[key] = _LiveWorker(slot, epoch, t)
        t.start()

    def _on_worker_exit(self, host: str, local_rank: int, code: int):
        with self._lock:
            in_plan = any(s.local_rank == local_rank
                          for s in self._host_assignments.get(host, []))
            self._results[f"{host}:{local_rank}"] = code
        if self._shutdown.is_set():
            return
        if not in_plan:
            logger.debug("retired worker %s:%d exited with %d", host,
                         local_rank, code)
            return
        if code == 0:
            self._registry.record_success(host, local_rank)
        else:
            logger.warning("worker %s:%d failed with exit code %d", host,
                           local_rank, code)
            _WORKER_FAILURES.inc()
            self._registry.record_failure(host, local_rank)

    def _seed_ckpt_latest(self):
        """Scan ``HOROVOD_CHECKPOINT_DIR`` (when configured) for the
        newest committed checkpoint and seed the rendezvous KV's
        ``ckpt/latest`` key — the restart-from-latest-valid path after
        a whole-job preemption, where no rank remembers anything."""
        directory = env_mod.env_str_opt(ENV_CKPT_DIR)
        if not directory:
            return
        try:
            from ...checkpoint.manifest import committed_steps
            steps = committed_steps(directory)
        except Exception:
            logger.exception("ckpt: scan of %s failed", directory)
            return
        if not steps:
            logger.info("ckpt: no committed checkpoint under %s "
                        "(cold start)", directory)
            return
        self._ckpt_latest = steps[-1]
        logger.info("ckpt: job will restart from committed step %d "
                    "(%s)", self._ckpt_latest, directory)
        if self._rendezvous is not None and \
                self._rendezvous.kvstore is not None:
            self._rendezvous.kvstore.put(
                CKPT_SCOPE, KEY_CKPT_LATEST,
                str(self._ckpt_latest).encode())

    def _publish_metrics(self):
        """Refresh the driver's registry snapshot in the rendezvous KV
        so scrapers can read launcher-side metrics (epochs, worker
        failures, world size) that no worker endpoint carries."""
        if self._rendezvous is None or self._rendezvous.kvstore is None:
            return
        try:
            self._rendezvous.kvstore.put(
                METRICS_SCOPE, KEY_DRIVER_METRICS,
                json.dumps(metrics.snapshot()).encode())
        except Exception:
            logger.debug("driver metrics publish failed", exc_info=True)

    def _list_elastic_keys(self) -> Optional[set]:
        """One ``elastic`` scope listing per discovery tick, shared by
        the lost-rank and slow-rank polls: O(notices present), not
        O(world) — at 64-256 ranks (relay-tree worlds) the per-slot
        GET form was the driver's own flat-star scan.  None = no KV
        store or a listing hiccup (both polls skip the tick)."""
        if self._rendezvous is None or self._rendezvous.kvstore is None:
            return None
        try:
            return set(self._rendezvous.kvstore.keys(ELASTIC_SCOPE))
        except Exception:
            logger.warning("elastic: notice listing failed; will "
                           "retry next tick", exc_info=True)
            return None

    def _poll_lost_ranks(self, present: Optional[set] = None):
        """Act on lost-rank notices the rank-0 coordinator published:
        record the failure against the rank's slot so the registry
        barrier fires and the host is blacklisted — the eviction path
        for a wedged worker whose process never exits."""
        if present is None:
            present = self._list_elastic_keys()
            if present is None:
                return
        with self._lock:
            slots = [s for ss in self._host_assignments.values()
                     for s in ss]
        for slot in slots:
            key = KEY_LOST_RANK % slot.rank
            if key not in present:
                continue
            try:
                raw = self._rendezvous.kvstore.get(ELASTIC_SCOPE, key)
            except Exception:
                # Per-slot, logged, and non-aborting: a KV hiccup must
                # not silently disable wedged-host eviction (the
                # checkpoint-coordinator silent-swallow lesson).
                logger.warning("elastic: lost-rank poll failed for "
                               "rank %d; will retry next tick",
                               slot.rank, exc_info=True)
                continue
            if raw is None:
                continue
            try:
                notice = json.loads(raw.decode())
                rank = int(notice["rank"])
                epoch = int(notice.get("epoch", 0))
            except (ValueError, KeyError):
                continue
            with self._lock:
                if epoch and epoch != self._epoch:
                    continue  # stale notice from a replaced epoch
                if (epoch, rank) in self._lost_handled:
                    continue
                self._lost_handled.add((epoch, rank))
            logger.warning(
                "elastic: coordinator promoted rank %d (%s:%d) to "
                "lost (%s); evicting", rank, slot.hostname,
                slot.local_rank, notice.get("reason", "?"))
            if _fr.ENABLED:
                _fr.record(_fr.ELASTIC, rank="driver", event="evict",
                           lost_rank=rank, epoch=epoch,
                           reason=notice.get("reason", "?"))
            self._registry.record_failure(slot.hostname,
                                          slot.local_rank)

    def _poll_slow_ranks(self, present: Optional[set] = None):
        """Refresh the flagged-slow view from the coordinator's
        ``slow-<rank>`` KV heartbeats.  A notice older than
        SLOW_NOTICE_STALE_S is a recovered rank (the scorer stopped
        republishing); a rank with a LOST notice is dead, and the
        death path owns it — its slow state is dropped so migration
        never races eviction."""
        if present is None:
            present = self._list_elastic_keys()
            if present is None:
                return
        active: Dict[int, float] = {}
        with self._lock:
            slots = [s for ss in self._host_assignments.values()
                     for s in ss]
        for slot in slots:
            if (KEY_LOST_RANK % slot.rank) in present:
                continue
            key = KEY_SLOW_RANK % slot.rank
            if key not in present:
                continue
            try:
                raw = self._rendezvous.kvstore.get(ELASTIC_SCOPE, key)
            except Exception:
                logger.warning("elastic: slow-rank poll failed for "
                               "rank %d; will retry next tick",
                               slot.rank, exc_info=True)
                continue
            if raw is None:
                continue
            try:
                notice = json.loads(raw.decode())
                rank = int(notice["rank"])
                score = float(notice.get("score", 0.0))
                wall = float(notice.get("wall", 0.0))
            except (ValueError, KeyError, TypeError):
                # TypeError: a JSON null (or list/dict) in a numeric
                # field — float(None) — must not escape into the
                # policy tick.
                continue
            if time.time() - wall > SLOW_NOTICE_STALE_S:
                continue  # stale heartbeat: the rank recovered
            active[rank] = score
        self._slow_active = active

    def _poll_slo(self) -> Dict[str, Optional[float]]:
        """The coordinator's last SLO notice, staleness-bounded like
        the slow-rank heartbeats: a notice older than
        SLO_NOTICE_STALE_S means the burn resolved (alerts re-fire
        while it persists) and must not keep steering the policy."""
        out: Dict[str, Optional[float]] = {"steps_per_s": None,
                                           "cycle_time_s": None}
        if self._rendezvous is None or self._rendezvous.kvstore is None:
            return out
        try:
            raw = self._rendezvous.kvstore.get(ELASTIC_SCOPE, KEY_SLO)
        except Exception:
            return out
        if not raw:
            return out
        try:
            notice = json.loads(raw.decode())
            wall = float(notice.get("wall", 0.0))
        except (ValueError, AttributeError, TypeError):
            # TypeError: '"wall": null' (or any non-numeric JSON
            # value) — float(None) — must not escape into the
            # policy tick.
            return out
        if time.time() - wall > SLO_NOTICE_STALE_S:
            return out
        for key in ("steps_per_s", "cycle_time_s"):
            v = notice.get(key)
            if isinstance(v, (int, float)):
                out[key] = float(v)
        return out

    def _read_kv_ckpt_latest(self) -> Optional[int]:
        """The newest committed checkpoint step per the coordination
        KV (checkpoint/coordinator.py publishes it on every commit) —
        the migration state machine's evidence that a fresh durable
        checkpoint exists before it evicts a straggler."""
        if self._rendezvous is None or self._rendezvous.kvstore is None:
            return None
        try:
            raw = self._rendezvous.kvstore.get(CKPT_SCOPE,
                                               KEY_CKPT_LATEST)
            return int(raw.decode()) if raw else None
        except Exception:
            return None

    def _policy_tick(self) -> bool:
        """Feed the resize policy one tick of signals and actuate any
        decision; returns True when host membership changed (caller
        bumps the discovery generation)."""
        if not env_mod.policy_enabled():
            return False
        with self._lock:
            size = self._world_size
        pending = len(self._host_manager.pending_hosts()) \
            if env_mod.elastic_scale_up_enabled() else 0
        slo = self._poll_slo()
        decision = self._policy.observe(Signals(
            size, pending_hosts=pending,
            straggler_scores=dict(self._slow_active),
            cycle_time_s=slo["cycle_time_s"],
            steps_per_s=slo["steps_per_s"]))
        if decision is None:
            return False
        if decision.kind == KIND_SCALE_UP:
            return self._actuate_scale_up(decision)
        self._start_migration(decision)
        return False

    def _actuate_scale_up(self, decision) -> bool:
        t0 = time.monotonic()
        admitted = self._host_manager.admit_pending()
        if not admitted:
            return False
        with self._lock:
            self._resize_trigger = TRIGGER_SCALE_UP
            epoch = self._epoch
        observe_autoscale("admission", time.monotonic() - t0)
        if _fr.ENABLED:
            _fr.record(_fr.ELASTIC_SCALE_UP, rank="driver",
                       hosts=",".join(admitted), epoch=epoch,
                       trigger=decision.trigger)
        logger.info("elastic: scale-up admitting host(s) %s (%s)",
                    admitted, decision.reason)
        return True

    def _start_migration(self, decision):
        """Begin checkpoint-then-evict for a persistently slow rank:
        remember the checkpoint step at decision time and let
        ``_tick_migration`` evict once a NEWER commit lands (bounded
        by HOROVOD_STRAGGLER_MIGRATE_CKPT_WAIT — a straggler slow
        enough to stall checkpointing still gets evicted)."""
        rank = decision.rank
        with self._lock:
            if self._migration is not None:
                return  # one migration in flight at a time
            slot = next((s for ss in self._host_assignments.values()
                         for s in ss if s.rank == rank), None)
            if slot is None:
                return
            self._migration = {
                "rank": rank,
                "host": slot.hostname,
                "local_rank": slot.local_rank,
                "epoch": self._epoch,
                "decided": time.monotonic(),
                "ckpt0": self._read_kv_ckpt_latest(),
                "deadline": time.monotonic() +
                env_mod.straggler_migrate_ckpt_wait(),
                "score": self._slow_active.get(rank, 0.0),
            }
            mig = dict(self._migration)
        if _fr.ENABLED:
            _fr.record(_fr.ELASTIC_MIGRATE, rank="driver",
                       peer=rank, host=mig["host"], phase="decided",
                       score=round(mig["score"], 3))
        logger.warning(
            "elastic: migration decided for rank %d (%s): waiting for "
            "a fresh checkpoint before evicting (%s)", rank,
            mig["host"], decision.reason)

    def _tick_migration(self) -> bool:
        """Advance an in-flight migration; returns True when the
        eviction fired (the caller bumps the generation so survivors
        re-rendezvous — the slow rank's collectives still succeed, so
        nothing else would make them notice)."""
        with self._lock:
            mig = self._migration
            if mig is None:
                return False
            if mig["epoch"] != self._epoch:
                # The world replanned under us (a death beat the
                # migration to it) — the straggler evidence is void.
                self._migration = None
                return False
        latest = self._read_kv_ckpt_latest()
        ckpt_fresh = latest is not None and \
            (mig["ckpt0"] is None or latest > mig["ckpt0"])
        timed_out = time.monotonic() >= mig["deadline"]
        if not ckpt_fresh and not timed_out:
            return False
        with self._lock:
            self._migration = None
            self._resize_trigger = TRIGGER_MIGRATION
        observe_autoscale("admission",
                          time.monotonic() - mig["decided"])
        if _fr.ENABLED:
            _fr.record(_fr.ELASTIC_MIGRATE, rank="driver",
                       peer=mig["rank"], host=mig["host"],
                       phase="evict",
                       ckpt_step=latest if latest is not None else -1,
                       ckpt_fresh=ckpt_fresh)
        logger.warning(
            "elastic: evicting straggler rank %d host %s (%s)",
            mig["rank"], mig["host"],
            "checkpoint %s committed" % latest if ckpt_fresh
            else "checkpoint wait timed out")
        # FAILURE is sticky in the registry, so the (alive) slow
        # worker's own re-rendezvous cannot resurrect the slot; the
        # barrier then blacklists the host (decaying cooldown) and
        # resume() replans without it.
        self._registry.record_failure(mig["host"], mig["local_rank"])
        return True

    def _discover_hosts(self):
        while not self._shutdown.is_set():
            # With the policy engine armed, newly discovered hosts
            # are held PENDING and admitted only on a policy decision
            # (or as failure replacements in resume()); legacy
            # immediate growth survives as policy-off + scale-up-on.
            admit_new = env_mod.elastic_scale_up_enabled() and \
                not env_mod.policy_enabled()
            try:
                changed = self._host_manager.update_available_hosts(
                    admit_new=admit_new)
            except Exception:
                logger.exception("host discovery failed; retrying")
                changed = False
            present = self._list_elastic_keys()
            if present is not None:
                self._poll_lost_ranks(present)
                self._poll_slow_ranks(present)
            if self._tick_migration():
                changed = True
            if self._policy_tick():
                changed = True
            self._publish_metrics()
            if changed:
                with self._lock:
                    self._generation += 1
                    gen = self._generation
                logger.info("elastic: host membership changed "
                            "(generation %d)", gen)
                if self._rendezvous is not None and \
                        self._rendezvous.kvstore is not None:
                    self._rendezvous.kvstore.put(
                        ELASTIC_SCOPE, KEY_GENERATION,
                        str(gen).encode())
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS)
