"""Process-level runtime state and the ``hvd.*`` basics API.

Counterpart of :mod:`horovod_tpu.common.basics` (reference:
common/basics.py:22-258 backed by the extern "C" query API in
operations.cc:708-896): one process-wide runtime whose data plane is
PyTorch on the tensors' own device.

A world of one process runs the reference's ``SingleProcessBackend`` +
``LoopbackController`` path.  A larger world (the launcher's env
contract, ``runner/gpu_run.py``: ``HOROVOD_RANK``/``HOROVOD_SIZE``/...
plus ``HOROVOD_TPU_COORDINATOR`` and ``HOROVOD_CONTROLLER_ADDR``) joins
one ``torch.distributed`` process group at
``tcp://$HOROVOD_TPU_COORDINATOR`` that carries CPU tensors over gloo
and CUDA tensors over NCCL, or over gloo when local ranks share a card
(``ops/dist_ops.py``), and negotiates through ``controller_net``.  When
rank 0 runs on another host than the launcher, rank 0 picks both ports
and publishes them through the rendezvous KV (``runner/endpoints.py``).

An elastic worker (``HOROVOD_ELASTIC=1`` with a rendezvous address, as
``runner/elastic_run.py`` starts it) asks the driver for its rank, size
and fresh endpoints at every ``init``; ``shutdown`` then ``init`` re-forms
the world in the same process.  ``shutdown`` destroys the process group
before it leaves the negotiation controller, so that a survivor stuck in
a collective with a dead peer is released by its peers' teardown, and a
re-init keeps the card the process took at its first init.
"""

import atexit
import datetime
import logging
import os
import threading
from typing import List, Optional, Sequence

from . import env as env_mod
from .env import Knobs, RankInfo
from .exceptions import NotInitializedError

logger = logging.getLogger("horovod_tpu_torch")

# Reduction op constants, matching the reference's enum values
# (reference: common/basics.py Average/Sum/Adasum constants + common.h).
Average = "Average"
Sum = "Sum"
Adasum = "Adasum"
Min = "Min"
Max = "Max"
Product = "Product"


class ProcessSet:
    """A subset of ranks forming their own collective group.

    The analog of ``hvd.init(comm=[ranks])`` sub-communicators
    (reference: common/basics.py:33-65, controller.h:112-117).  The global
    process set contains every rank.
    """

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(ranks) if ranks is not None else None)
        self.process_set_id: int = 0 if ranks is None else -1

    def included(self, rank: int) -> bool:
        return self.ranks is None or rank in self.ranks

    def size(self) -> int:
        state = _state()
        return (state.rank_info.size if self.ranks is None
                else len(self.ranks))

    def rank(self) -> int:
        state = _state()
        if self.ranks is None:
            return state.rank_info.rank
        return self.ranks.index(state.rank_info.rank)

    def __repr__(self):
        return f"ProcessSet(ranks={self.ranks or 'global'})"


global_process_set = ProcessSet(None)


class HorovodTpuState:
    """Per-process singleton (analog of HorovodGlobalState,
    reference: common/global_state.h:43-132)."""

    def __init__(self):
        self.initialized = False
        self.init_lock = threading.Lock()
        self.rank_info = RankInfo()
        self.knobs = Knobs()
        self.process_sets: List[ProcessSet] = [global_process_set]
        # Monotonic: ids are NEVER reused.  Deriving the next id from
        # len(process_sets) would hand a removed set's id to a new set
        # while another registered set still holds it — two live sets
        # sharing an id collides every (psid, name)-keyed coordinator
        # structure.  Advances identically on every rank because
        # add/remove_process_set are collective calls (reference
        # contract, process_set.h).
        self.next_process_set_id = 1  # 0 = global
        self.backend = None          # ops data-plane backend
        # How CUDA tensors cross ranks ("nccl" or "gloo"), decided once
        # at init; None in a world of one.
        self.transport: Optional[str] = None
        self.process_group_owned = False
        self.runtime = None          # background negotiation runtime
        self.timeline = None
        self.metrics_server = None   # /metrics HTTP endpoint (opt-in)
        self.parameter_manager = None   # legacy HOROVOD_AUTOTUNE GP
        self.tune_session = None     # autotune-then-freeze (rank 0)
        self.elastic_enabled = False
        self.host_messages = None    # elastic host-update queue
        self.is_homogeneous = True
        # The card this process took at its first multi-process init;
        # an elastic re-init keeps it even if its local rank changed.
        self.card: Optional[int] = None
        # Monotonic per-process init counter (observability; NOT safe
        # as a cross-rank namespace — freshly spawned elastic workers
        # start at 0 while survivors are at N).
        self.init_generation = 0

    def require_init(self):
        if not self.initialized:
            raise NotInitializedError()


_global_state = HorovodTpuState()


def _state() -> HorovodTpuState:
    return _global_state


def _init_process_group(state: HorovodTpuState) -> bool:
    """Join the world's ``torch.distributed`` process group, where the
    JAX package joins ``jax.distributed``: a TCP store at
    ``$HOROVOD_TPU_COORDINATOR`` (rank 0 hosts it), world size and rank
    from the env contract.  Picks this rank's card and the transport of
    CUDA tensors (``dist_ops.cuda_transport``, agreed by every rank
    through the store: ``dist_ops.world_transport``) and logs it.
    Returns whether this call made the group (a group the caller made
    stays the caller's)."""
    import torch
    import torch.distributed as dist
    from ..ops.dist_ops import (card_identity, cuda_transport,
                                process_group_backend, world_transport)
    info = state.rank_info
    state.transport = cuda_transport(info.local_size)
    if torch.cuda.is_available():
        if state.card is None:
            state.card = info.local_rank % torch.cuda.device_count()
        torch.cuda.set_device(state.card)
    if dist.is_initialized():
        return False
    coordinator = env_mod.env_str_opt(env_mod.HOROVOD_TPU_COORDINATOR)
    if coordinator is None:
        raise RuntimeError(
            f"{env_mod.HOROVOD_TPU_COORDINATOR} must name host:port of the "
            "process group's store for multi-process runs (the launcher "
            "sets it)")
    timeout = datetime.timedelta(seconds=env_mod.start_timeout())
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), info.size,
                          is_master=info.rank == 0, timeout=timeout)
    state.transport = world_transport(
        store, info.rank, info.size, state.transport,
        card_identity(state.card if torch.cuda.is_available() else None))
    dist.init_process_group(
        process_group_backend(state.transport), store=store,
        world_size=info.size, rank=info.rank, timeout=timeout)
    logger.info("rank %d of %d: CUDA tensors cross ranks over %s "
                "(local_size %d, %d card(s) visible)", info.rank, info.size,
                state.transport, info.local_size,
                torch.cuda.device_count())
    return True


def init(comm=None, process_sets=None):
    """Initialize horovod_tpu_torch.

    ``comm`` may be a list of ranks forming a sub-world (reference
    semantics of ``hvd.init(comm=[0,1])``, common/basics.py:33-65); mpi4py
    communicators are not supported (there is no MPI path) — the
    rendezvous is the launcher's env contract instead.
    """
    state = _state()
    with state.init_lock:
        if state.initialized:
            # Re-init is a no-op for the world, but process sets must
            # NOT be silently dropped: register them now (the
            # reference allows post-init registration via
            # add_process_set; dropping them here left ids at -1 and
            # sent colliding psid=-1 requests — a measured 4-rank
            # wedge, tests/test_stress_protocol.py).
            if process_sets:
                for ps in process_sets:
                    if getattr(ps, "process_set_id", -1) in (-1, None):
                        add_process_set(ps)
            return
        state.knobs = Knobs.from_env()
        # Opt-in lock-order witness (docs/static_analysis.md): arm
        # BEFORE any control-plane object constructs its locks so the
        # whole incarnation's acquisition graph is recorded.
        from . import lockwitness as _lw
        _lw.maybe_enable_from_env()
        if state.knobs.elastic and \
                env_mod.env_str_opt(env_mod.HOROVOD_RENDEZVOUS_ADDR):
            # Elastic worker: rank identity comes from the driver's
            # rendezvous, fresh every epoch (reference:
            # gloo/gloo_context.cc:154-200 elastic rank re-query).
            from ..runner.elastic.worker import (
                RendezvousHostUpdateSource, elastic_rendezvous)
            from . import elastic as elastic_mod
            info = elastic_rendezvous()
            state.elastic_enabled = True
            src = RendezvousHostUpdateSource(
                seed_generation=int(info.get("generation", 0)))
            elastic_mod.set_host_update_source(src)
        state.rank_info = RankInfo.from_env()

        if comm is not None and not hasattr(comm, "Get_rank"):
            ranks = sorted(comm)
            if state.rank_info.launched and ranks:
                # Restrict the world to the given ranks.
                if state.rank_info.rank in ranks:
                    sub_rank = ranks.index(state.rank_info.rank)
                    state.rank_info.rank = sub_rank
                    state.rank_info.size = len(ranks)

        if state.rank_info.size > 1 and \
                env_mod.env_str_opt(
                    env_mod.HOROVOD_TPU_COORDINATOR) is None \
                and env_mod.env_str_opt("HOROVOD_RANK0_ADDR") and \
                env_mod.env_str_opt(env_mod.HOROVOD_RENDEZVOUS_ADDR):
            # Static launch with a remote rank 0: the launcher could
            # not pick valid ports for rank 0's host, so rank 0 picks
            # them here and publishes via the rendezvous KV
            # (runner/endpoints.py).
            from ..runner.endpoints import STATIC_KEY, resolve_endpoints
            from ..runner.http_server import RendezvousClient
            client = RendezvousClient(
                env_mod.env_require(env_mod.HOROVOD_RENDEZVOUS_ADDR),
                int(env_mod.env_require(
                    env_mod.HOROVOD_RENDEZVOUS_PORT)))
            eps = resolve_endpoints(
                client, state.rank_info.rank,
                env_mod.env_require("HOROVOD_RANK0_ADDR"), STATIC_KEY,
                timeout=env_mod.start_timeout())
            os.environ[env_mod.HOROVOD_TPU_COORDINATOR] = \
                eps["coordinator"]
            os.environ["HOROVOD_CONTROLLER_ADDR"] = \
                eps["controller_addr"]

        if state.rank_info.size > 1:
            state.process_group_owned = _init_process_group(state)

        # Failpoint rank= predicates resolve against the final rank of
        # this incarnation (elastic rendezvous above may have changed
        # the env contract since import time).
        from . import failpoints
        failpoints.set_rank(state.rank_info.rank)

        # Black-box flight recorder: rank-tag events recorded from here
        # on, and install the SIGUSR2 dump hook (no-op off the main
        # thread or when the recorder is disarmed).
        from . import flight_recorder
        flight_recorder.set_rank(state.rank_info.rank)
        if flight_recorder.ENABLED:
            flight_recorder.install_signal_handler()

        # Why-is-it-slow plane: rank-tag the sampling profiler and the
        # SLO evaluator (both armed at import from HOROVOD_PROFILE /
        # HOROVOD_SLO; set_rank is a no-op when disarmed).
        from . import profiler as profiler_mod
        from . import slo as slo_mod
        profiler_mod.set_rank(state.rank_info.rank)
        slo_mod.set_rank(state.rank_info.rank)

        from ..ops.backend import create_backend
        state.backend = create_backend(state)

        from .runtime import BackgroundRuntime
        state.runtime = BackgroundRuntime(state)
        state.runtime.start()

        if state.knobs.timeline:
            from .timeline import Timeline
            state.timeline = Timeline(
                state.knobs.timeline, rank=state.rank_info.rank,
                mark_cycles=state.knobs.timeline_mark_cycles)
            state.runtime.timeline = state.timeline

        if state.knobs.metrics_port is not None and \
                state.metrics_server is None:
            from . import metrics as metrics_mod
            # Per-local-rank offset: with several ranks on one host a
            # fixed port would let only the first binder serve; 0
            # still means "ephemeral" for every rank.
            port = state.knobs.metrics_port
            if port:
                port += state.rank_info.local_rank
            try:
                state.metrics_server = metrics_mod.serve(
                    port=port,
                    cluster_provider=cluster_metrics_snapshot,
                    status_provider=status,
                    profile_provider=profiler_mod.profile_dict)
                logger.info("metrics endpoint on port %d",
                            state.metrics_server.port)
            except (OSError, OverflowError, ValueError):
                # Includes out-of-range ports (bind raises
                # OverflowError, not OSError): a bad observability
                # knob must never take down training.
                logger.warning(
                    "could not start the /metrics endpoint on port %d",
                    port, exc_info=True)

        if process_sets:
            for ps in process_sets:
                add_process_set(ps)

        state.init_generation += 1
        state.initialized = True
        logger.debug("horovod_tpu_torch initialized: rank=%d size=%d "
                     "local=%d/%d", state.rank_info.rank, state.rank_info.size,
                     state.rank_info.local_rank, state.rank_info.local_size)


def shutdown():
    state = _state()
    with state.init_lock:
        if not state.initialized:
            return
        if state.runtime is not None:
            # Quiesce (not detach): halts the cycle loop AND disables
            # recv-thread response dispatch before the backend closes,
            # so a late frame can't execute against a freed ring
            # communicator; the controller attachment itself stays up
            # as the teardown-ordering signal (below).
            state.runtime.quiesce()
        if state.timeline is not None:
            state.timeline.close()
            state.timeline = None
        if state.metrics_server is not None:
            state.metrics_server.stop()
            state.metrics_server = None
        if state.backend is not None and hasattr(state.backend, "close"):
            state.backend.close()
        state.backend = None
        # The process group goes before the controller: a peer whose
        # data-plane thread waits in a collective on a dead rank's
        # neighbour is released when that neighbour's pairs close (gloo
        # reports "connection closed by peer"), and only then can it
        # leave the controller that rank 0's drain waits on.  Destroying
        # the group touches no store, so a dead rank 0 cannot block it.
        if state.process_group_owned:
            import torch.distributed as dist
            dist.destroy_process_group()
            state.process_group_owned = False
        if state.runtime is not None:
            state.runtime.detach()
            state.runtime = None
        state.tune_session = None
        state.parameter_manager = None
        state.transport = None
        state.initialized = False


atexit.register(shutdown)


def is_initialized() -> bool:
    return _state().initialized


def rank() -> int:
    state = _state()
    state.require_init()
    return state.rank_info.rank


def size() -> int:
    state = _state()
    state.require_init()
    return state.rank_info.size


def local_rank() -> int:
    state = _state()
    state.require_init()
    return state.rank_info.local_rank


def local_size() -> int:
    state = _state()
    state.require_init()
    return state.rank_info.local_size


def cross_rank() -> int:
    state = _state()
    state.require_init()
    return state.rank_info.cross_rank


def cross_size() -> int:
    state = _state()
    state.require_init()
    return state.rank_info.cross_size


def num_chips() -> int:
    """Accelerator cards across the world: size() counts processes,
    this counts devices (every rank sees the same card count)."""
    return local_chips() * size()


def local_chips() -> int:
    import torch
    _state().require_init()
    return torch.cuda.device_count()


def is_homogeneous() -> bool:
    state = _state()
    state.require_init()
    return state.is_homogeneous


def mpi_threads_supported() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    # The TCP control plane is the gloo analog and is always available.
    return True


def gloo_enabled() -> bool:
    return True


def nccl_built() -> bool:
    import torch.distributed as dist
    return dist.is_nccl_available()


def ccl_built() -> bool:
    return False


def cuda_built() -> bool:
    return True


def rocm_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def xla_enabled() -> bool:
    return False


def metrics_snapshot() -> dict:
    """Plain-dict snapshot of this process's runtime metrics registry:
    ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``.
    Labeled metrics map ``"k=v,..."`` child keys to values; histograms
    carry count/sum/min/max plus fixed log-scale buckets.  Meaningful
    before/after init (the registry is process-wide); see
    docs/observability.md."""
    from . import metrics as metrics_mod
    return metrics_mod.snapshot()


def cluster_metrics_snapshot():
    """Merged cross-rank snapshot, available on the rank that hosts the
    Python coordinator once HOROVOD_METRICS_AGG_SECONDS-driven polls
    have collected per-rank snapshots; None anywhere else (workers,
    native coordinator, aggregation disabled).  With a relay tree
    armed (HOROVOD_COORD_FANOUT>0) the merge is O(fanout) at the root:
    relays pre-aggregate their subtree's replies into one MA frame
    each, and the returned ``ranks`` list still names every leaf
    contributor."""
    state = _state()
    server = getattr(getattr(state.runtime, "controller", None),
                     "server", None)
    if server is None or not hasattr(server, "merged_metrics"):
        return None
    return server.merged_metrics()


def status() -> dict:
    """The live job-health view (JSON-ready) served at ``GET /status``
    next to ``/metrics`` — the "which rank is slow RIGHT NOW" plane
    (docs/observability.md).

    Every rank reports its local view: replay + tune phase, queue
    depth, op rate, and its own phase-time EWMAs when the straggler
    observatory (``HOROVOD_STRAGGLER=1``) is armed.  The rank hosting
    the Python coordinator additionally embeds the ``cluster`` section:
    per-rank alive/limbo/wedged/lost liveness states, straggler scores
    and slow flags, and negotiation counters.  ``tools/hvdtop.py``
    renders this dict live."""
    from . import metrics as metrics_mod
    from . import profiler as profiler_mod
    from . import slo as slo_mod
    from . import straggler as straggler_mod
    state = _state()
    rt = state.runtime
    out = {
        "rank": state.rank_info.rank,
        "size": state.rank_info.size,
        "initialized": state.initialized,
        "straggler_armed": straggler_mod.ENABLED,
        "profile_armed": profiler_mod.ENABLED,
        "slo_armed": slo_mod.ENABLED,
    }
    snap = metrics_mod.snapshot()
    counters = snap.get("counters", {})

    def _total(name):
        v = counters.get(name, 0.0)
        return sum(v.values()) if isinstance(v, dict) else v

    replay = getattr(rt, "replay", None)
    out["replay"] = {
        "enabled": bool(state.knobs.replay_enabled),
        "active": bool(replay is not None and replay.active),
        "cycles_replayed": _total("hvd_steady_state_cycles_replayed"),
        "entries": _total("hvd_steady_state_entries"),
    }
    out["tune"] = tune_status()
    if rt is not None:
        out["queue_depth"] = rt.tensor_queue.outstanding()
    out["ops_dispatched"] = _total("hvd_responses_dispatched_total")
    collector = getattr(rt, "phase_collector", None)
    if straggler_mod.ENABLED and collector is not None:
        out["phases"] = collector.local_phases()
    if slo_mod.ENABLED:
        out["slo"] = slo_mod.slo_status()
    if profiler_mod.ENABLED:
        prof = profiler_mod.instance()
        if prof is not None:
            out["hot_frames"] = prof.top_frames()
    server = getattr(getattr(rt, "controller", None), "server", None)
    cluster = getattr(server, "status", None)
    if cluster is not None:
        out["cluster"] = cluster()
    return out


def slo_status() -> dict:
    """The SLO plane's live view (``hvd.slo_status()``): targets,
    short/long-window achieved SLIs, burn rates, and alert counts —
    ``{"enabled": False}`` when ``HOROVOD_SLO`` is off.  Callable
    before init (the plane arms at import)."""
    from . import slo as slo_mod
    return slo_mod.slo_status()


def tune_status() -> Optional[dict]:
    """The autotune-then-freeze lifecycle view (docs/autotune.md).

    On the rank hosting the tuning session (rank 0 with
    ``HOROVOD_TUNE=1``) this is the session's full status — phase
    (search/frozen/aborted), per-class sample counts and live/frozen
    knobs.  On every other rank it is the worker-side view: the
    currently applied worker knobs plus whether steady-state replay is
    being held for an active search.  None before init or when tuning
    was never enabled."""
    state = _state()
    sess = state.tune_session
    if sess is not None:
        return sess.status()
    rt = state.runtime
    if rt is None or not (state.knobs.tune or state.knobs.autotune
                          or state.knobs.tune_profile_loaded):
        return None
    # The runtime's own lifecycle bit, not the replay tracker's hold:
    # with replay disabled there is no tracker, but the search is
    # still live until the freeze/abort announcement lands.
    holding = bool(getattr(rt, "tuning_active", False))
    return {
        "phase": ("search" if holding else "frozen"),
        "worker": {
            "cycle_time_ms": state.knobs.cycle_time_ms,
            "coalesce": state.knobs.request_coalescing,
            "replay_warmup": state.knobs.replay_warmup_cycles,
        },
        "profile_loaded": state.knobs.tune_profile_loaded,
    }


def start_timeline(file_path: str, mark_cycles: bool = False):
    """Start timeline recording at runtime (reference:
    horovod_start_timeline, operations.cc:738-764)."""
    state = _state()
    state.require_init()
    from .timeline import Timeline
    if state.timeline is not None:
        state.timeline.close()
    state.timeline = Timeline(file_path, rank=state.rank_info.rank,
                              mark_cycles=mark_cycles)
    if state.runtime is not None:
        state.runtime.timeline = state.timeline


def stop_timeline():
    state = _state()
    state.require_init()
    if state.timeline is not None:
        state.timeline.close()
        state.timeline = None
    if state.runtime is not None:
        state.runtime.timeline = None


def add_process_set(ranks) -> ProcessSet:
    state = _state()
    ps = ranks if isinstance(ranks, ProcessSet) else ProcessSet(ranks)
    if getattr(ps, "process_set_id", -1) is not None and \
            ps.process_set_id >= 0:
        # Double registration would duplicate the registry entry and
        # desync it from the id sentinel; registered iff id >= 0.
        raise ValueError(
            "process set %r is already registered (id %d); call "
            "remove_process_set first to re-register" %
            (ps, ps.process_set_id))
    ps.process_set_id = state.next_process_set_id
    state.next_process_set_id += 1
    state.process_sets.append(ps)
    _invalidate_replay("process_set_change")
    return ps


def remove_process_set(ps: ProcessSet):
    state = _state()
    if ps in state.process_sets and ps.process_set_id != 0:
        state.process_sets.remove(ps)
        # Unregistered again: submit-time validation rejects it until
        # re-added (which assigns a FRESH id — ids are never reused).
        ps.process_set_id = -1
        _invalidate_replay("process_set_change")


def _invalidate_replay(reason: str):
    """Process-set membership changed: a frozen steady-state schedule
    may reference the old grouping — exit replay / reset convergence
    (collective call, so every rank invalidates at the same point)."""
    rt = _state().runtime
    if rt is not None and getattr(rt, "replay", None) is not None:
        rt.replay.note_disruption(reason)
