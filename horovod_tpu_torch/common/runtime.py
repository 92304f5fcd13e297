"""Background runtime: the per-process coordination thread.

Mirrors the reference background loop (reference: operations.cc:356-585
BackgroundThreadLoop / RunLoopOnce :587-645 / PerformOperation :253-332):
one thread per process owns all communication — it drains the tensor
queue every cycle, runs negotiation through the controller, executes the
fused responses on the data-plane backend, and fires completion
callbacks.

Counterpart of :mod:`horovod_tpu.common.runtime`.  Entries carry torch
tensors, which stay on their own device.  A world of one process
negotiates through the ``LoopbackController``, a larger one through the
``NetworkController`` (``controller_net``).

CUDA ordering (the reference's ``torch/ready_event.{h,cc}``): ``submit``
records an event on the caller's current stream; the data plane runs
each response on a stream of the runtime's own, made to wait on those
events, and records a done event there that ``Handle.wait`` makes the
waiter's stream wait on.  Every tensor the runtime's stream touches is
marked with ``record_stream``, so the caching allocator does not hand
its memory out while that stream may still read it.

A failed incarnation (a peer died, the controller broke) fails every
pending handle with the error, and a later submission raises it as
``HorovodInternalError``, the exception the elastic retry loop restores
from.  ``quiesce`` waits for the data-plane streams and drops them, so
no tensor of the old incarnation is held past its teardown.
"""
# hvdlint-module: hot-path (instrumentation must hide behind one attribute check — docs/static_analysis.md)

import contextlib
import itertools
import logging
import threading
import time
from typing import Dict, List, Optional

import torch

from . import failpoints as _fp
from . import flight_recorder as _fr
from . import metrics
from . import slo as _slo
from . import straggler as _sg
from . import timeline as tl
from .controller import LoopbackController
from .exceptions import HorovodInternalError
from .message import (Request, RequestType, Response, ResponseType,
                      torch_dtype)
from .replay import SteadyStateReplay
from .stall_inspector import StallInspector
from .tensor_queue import TensorQueue, TensorTableEntry

logger = logging.getLogger("horovod_tpu_torch.runtime")

_CYCLES = metrics.counter(
    "hvd_cycles_total", "Background cycle-loop iterations")
_CYCLE_SECONDS = metrics.histogram(
    "hvd_cycle_seconds",
    "Work-cycle duration (queue drain through response dispatch)")
_QUEUE_DEPTH = metrics.gauge(
    "hvd_queue_depth", "Tensor-table entries awaiting completion")
_SUBMIT_LATENCY = metrics.histogram(
    "hvd_submit_latency_seconds",
    "submit() to completion-callback latency per tensor")
_RESPONSES = metrics.counter(
    "hvd_responses_dispatched_total",
    "Responses executed on this rank, by collective type")
_JOIN_ZEROS = metrics.counter(
    "hvd_join_zero_substituted_total",
    "Zero tensors substituted for collectives this joined rank "
    "did not submit")


def _ready_event(device: torch.device) -> "torch.cuda.Event":
    """An event on the current stream of ``device``: work enqueued there
    so far (the tensor's producer) happens before it."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _latency_wrapped(cb, collector=None):
    """Stamp submit time into the completion callback so the
    submit-to-callback latency histogram sees every path (negotiated,
    inline cache hit, error flush)."""
    t0 = time.perf_counter()

    def wrapped(ok, result):
        dt = time.perf_counter() - t0
        _SUBMIT_LATENCY.observe(dt)
        if _sg.ENABLED and collector is not None:
            # Straggler observatory: the submit→executed e2e phase
            # EWMA (published into MR frames by the controller).
            # Disabled cost: this one attribute check.
            collector.note_latency(dt)
        return cb(ok, result)
    return wrapped


class BackgroundRuntime:
    def __init__(self, state):
        self.state = state
        self.tensor_queue = TensorQueue()
        # Cross-rank group ids for grouped submissions (group-atomic
        # fusion).  Monotonic per process; ranks agree because grouped
        # collectives are submitted in the same order everywhere (the
        # same ordering contract auto-generated tensor names rely on).
        self._group_counter = itertools.count()
        self.stall_inspector = StallInspector(
            warning_time_s=state.knobs.stall_warning_time_s,
            shutdown_time_s=state.knobs.stall_shutdown_time_s,
            world_size=state.rank_info.size,
        ) if not state.knobs.stall_check_disable else None
        self.timeline = None
        # Per-runtime phase-time EWMAs for the straggler observatory
        # (common/straggler.py): fed from the hot paths behind the
        # ENABLED gate, published into MR metrics frames by the
        # controller (rank-labeled, so relay pre-aggregation carries
        # every rank's summary through intact).
        self.phase_collector = _sg.PhaseCollector()
        self.controller = self._make_controller()
        if hasattr(self.controller, "set_phase_collector"):
            self.controller.set_phase_collector(self.phase_collector)
        if self.stall_inspector is not None:
            # On the rank hosting the Python coordinator, local stall
            # warnings also name the current top straggler — "everyone
            # blocked on rank 3" reads differently from "coordinator
            # wedged" (common/straggler.py).  getattr chains resolve
            # to None everywhere else (loopback, workers, native).
            top = getattr(getattr(self.controller, "server", None),
                          "straggler_top", None)
            if top is not None:
                self.stall_inspector.set_straggler_provider(top)
            # And WHY it is slow: the coordinator's per-rank profile
            # digests (common/profiler.py) name the dominant frame of
            # the implicated rank in the same warning line.
            rc = getattr(getattr(self.controller, "server", None),
                         "profile_root_cause", None)
            if rc is not None:
                self.stall_inspector.set_root_cause_provider(rc)
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        # Direct dispatch: the controller's recv thread EXECUTES each
        # response the moment its frame decodes (no queue hop to this
        # thread — on a 1-core host that handoff is a context switch,
        # a fixed ~0.1-0.2 ms per op).  The background thread then only
        # services submissions/negotiation.  Ordering still follows the
        # coordinator's broadcast order: the recv loop is the single
        # sequential consumer of the socket.
        self._inline = False
        if hasattr(self.controller, "set_response_callback"):
            self.controller.set_response_callback(self._dispatch_response)
            self._inline = hasattr(self.controller,
                                   "try_inline_cache_hit")
        elif hasattr(self.controller, "set_receive_callback"):
            self.controller.set_receive_callback(self._wake.set)
        # Steady-state replay (common/replay.py): negotiation-free
        # execution of converged cycles.  Networked worlds only (a
        # loopback world has no round-trip to skip).  Autotune no
        # longer disables replay outright: while a tuning search is
        # live (HOROVOD_TUNE / HOROVOD_AUTOTUNE, not yet frozen) the
        # tracker is HELD — it observes but refuses entry, labeled
        # hvd_steady_state_exits{reason="tuning"} — and the
        # freeze/convergence PA announcement releases it, so the
        # lifecycle is warmup -> freeze -> replay (docs/autotune.md).
        # A reloaded tuned profile means the search already ran:
        # replay is free from the first cycle.
        self.replay: Optional[SteadyStateReplay] = None
        # Worker-side tuning lifecycle bit, tracked on the runtime
        # itself (not only via the replay tracker — which may not
        # exist, e.g. HOROVOD_STEADY_STATE_REPLAY=0): flipped by the
        # tuning_active field of PA announcements; read by
        # hvd.tune_status().
        self.tuning_active = (state.knobs.tune or
                              state.knobs.autotune) and \
            not state.knobs.tune_profile_loaded
        if self._inline and state.knobs.replay_enabled:
            self.replay = SteadyStateReplay(
                self, warmup_cycles=state.knobs.replay_warmup_cycles)
            if self.tuning_active:
                self.replay.set_tuning(True)
            if hasattr(self.controller, "set_replay_observer"):
                self.controller.set_replay_observer(self.replay)
        # Request coalescing (tunable): when on (default), the inline
        # fast path is taken only from an IDLE table so async bursts
        # drain as one coalesced CH/RQ frame per kind; off = every
        # eligible submission goes inline immediately (one frame per
        # op — lower latency for strictly synchronous loops, more
        # frames for bursty ones).  The tuner explores both.
        self._coalesce = state.knobs.request_coalescing
        if hasattr(self.controller, "set_params_hook"):
            self.controller.set_params_hook(self._apply_tuned_params)
        self._thread: Optional[threading.Thread] = None
        self._cycle_time_s = state.knobs.cycle_time_ms / 1000.0
        self._entry_sizes: Dict[tuple, int] = {}  # (psid, name)
        self._joined = False
        # Device of this rank's latest submission: where a joined rank
        # builds the zeros it substitutes.
        self._device = torch.device("cpu")
        # The data plane's own CUDA stream, one per device.
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._error: Optional[Exception] = None
        # Called once when a fatal control-plane error surfaces (e.g.
        # coordinator connection lost in an elastic resize): lets
        # side-band machinery unblock FAST — the TF graph-collective
        # layer aborts in-flight CollectiveReduceV2 waits so the user
        # thread unwinds immediately instead of riding out the
        # collective timeout while peers tear the world down.
        self._fatal_listeners = []
        self._fatal_fired = False
        self._dispatch_disabled = False
        # Serializes recv-thread direct dispatch against quiesce():
        # backend.close() must never overlap a running
        # _perform_operation (the ring backend has its own fusion-lock
        # serialization, but the XLA mesh backend has none).
        self._dispatch_lock = threading.Lock()
        if hasattr(self.controller, "set_broken_callback"):
            self.controller.set_broken_callback(self._on_fatal)

    def set_joined(self, flag: bool):
        """While joined, this rank substitutes zeros for collectives it
        did not submit (JoinOp, reference collective_operations.h:259)."""
        self._joined = flag
        if flag and self.replay is not None:
            # Join changes every cached response's validity (zeros get
            # substituted for this rank); negotiate until re-converged.
            self.replay.note_disruption("join")

    def wake(self):
        """Wake the background cycle (replay exit flushes its partial
        batch into the negotiation queue and needs a cycle now)."""
        self._wake.set()

    def _apply_tuned_params(self, params: dict):
        """Adopt tuned worker knobs announced through a PA frame
        (horovod_tpu/tune).  Runs at the frame's position in the
        response stream — identical on every rank — so no two ranks
        ever run different knobs for the same cycle."""
        knobs = self.state.knobs
        if "cycle_time_ms" in params:
            knobs.cycle_time_ms = float(params["cycle_time_ms"])
            self._cycle_time_s = knobs.cycle_time_ms / 1000.0
        if "coalesce" in params:
            self._coalesce = bool(params["coalesce"])
            knobs.request_coalescing = self._coalesce
        if "tuning_active" in params:
            self.tuning_active = bool(params["tuning_active"])
        replay = self.replay
        if replay is not None:
            if "replay_warmup" in params:
                knobs.replay_warmup_cycles = int(params["replay_warmup"])
                replay.set_warmup(knobs.replay_warmup_cycles)
            if "tuning_active" in params:
                replay.set_tuning(bool(params["tuning_active"]))

    def _make_controller(self):
        if self.state.rank_info.size == 1:
            return LoopbackController(self.state)
        from .controller_net import NetworkController
        return NetworkController(self.state)

    # ------------------------------------------------------------------
    # submission API (called from user/framework threads)
    # ------------------------------------------------------------------
    def _raise_error(self):
        """Raise the incarnation's fatal error as HorovodInternalError
        (the elastic retry loop's signal), as ``Handle.wait`` does."""
        err = self._error
        if isinstance(err, HorovodInternalError):
            raise err
        raise HorovodInternalError(str(err)) from err

    def submit(self, request: Request, entry: TensorTableEntry):
        if self._error is not None:
            self._raise_error()
        if _fp.ENABLED:
            # Failpoint site: eager submission, on the caller's thread.
            # delay() models framework-side jitter; error() a rank that
            # dies mid-step (the chaos harness crashes ranks here).
            _fp.maybe_fail("runtime.submit",
                           rank=self.state.rank_info.rank)
        if _fr.ENABLED:
            # Flight-recorder site (the per-collective record the NCCL
            # flight recorder keeps): disabled cost is this ONE
            # attribute check, pinned by tests/test_flight_recorder.py.
            _fr.record(_fr.SUBMIT, rank=self.state.rank_info.rank,
                       name=request.tensor_name,
                       type=request.request_type.name)
        entry.callback = _latency_wrapped(entry.callback,
                                          self.phase_collector)
        nelem = 1
        for d in request.tensor_shape:
            nelem *= d
        self._entry_sizes[(request.process_set_id,
                           request.tensor_name)] = nelem
        if entry.tensor is not None:
            self._device = entry.tensor.device
            if entry.tensor.is_cuda:
                entry.ready_event = _ready_event(entry.tensor.device)
        replay = self.replay
        if replay is not None and not self._joined:
            if replay.active and replay.eligible(request):
                # Frozen schedule: match + execute locally, no wire
                # traffic.  False = replay just exited (unseen tensor,
                # signature change, armed failpoint, ...) — fall
                # through; THIS request rides the negotiation round.
                if replay.replay_submit(request, entry):
                    return
            elif replay.eligible(request):
                if replay.observe_submit(request) and \
                        replay.replay_submit(request, entry):
                    return
            else:
                # Joins/barriers/allgathers/alltoalls break cycle
                # convergence (see replay.py for why).
                replay.note_disruption(
                    request.request_type.name.lower())
        if self.timeline:
            self.timeline.negotiate_start(
                request.tensor_name, request.request_type.name)
        tl.begin_span((request.process_set_id, request.tensor_name),
                      "negotiate", tensor=request.tensor_name,
                      op=request.request_type.name)
        # Inline fast path only from an IDLE table: during an async
        # burst (N grads submitted before any completes) the first op
        # goes inline and the rest queue, so the background drain sends
        # them as ONE coalesced CH/RQ frame per kind instead of one
        # frame per tensor — look-ahead fusion then sees whole cycles
        # (r05 measured one RQ frame per tensor).  Synchronous loops
        # always see an idle table, so the tiny-op floor is unchanged.
        if self._inline and request.group_id < 0 and not self._joined \
                and (not self._coalesce or
                     self.tensor_queue.outstanding() == 0):
            # Inline cache-hit fast path: entry lands in the table
            # FIRST (the recv thread may dispatch the response
            # immediately), then the CH frame goes out on THIS thread
            # — no background wake.  Bit/request order on the socket
            # is per-rank arbitrary by protocol (the coordinator
            # counts per tensor), so racing the background thread's
            # own sends under the controller's send lock is safe.
            self.tensor_queue.add_entry_only(entry)
            # Stall bookkeeping BEFORE the frame goes out: once the CH
            # frame is sent the recv thread may dispatch and remove()
            # at any moment — recording afterwards would resurrect a
            # completed tensor and later trip a spurious stall
            # shutdown.
            if self.stall_inspector is not None:
                self.stall_inspector.record_uncached_tensor(
                    request.tensor_name, request.request_rank)
            try:
                sent = self.controller.try_inline_cache_hit(request)
            except Exception as e:
                # Mirror the background loop's error contract: fail
                # every outstanding callback (including this entry)
                # and surface to future submitters — otherwise the
                # stale table entry turns the real connectivity error
                # into DuplicateTensorNameError on retry.
                self._error = e
                self.tensor_queue.shutdown_flush(e)
                self._raise_error()
            if sent:
                return
            # Cache miss: fall back to the negotiation queue.
            self.tensor_queue.queue_request(request)
            self._wake.set()
            return
        self.tensor_queue.add(request, entry)
        self._wake.set()

    def submit_group(self, requests: List[Request],
                     entries: List[TensorTableEntry]):
        if self._error is not None:
            self._raise_error()
        if self.replay is not None:
            # Grouped submissions negotiate (group atomicity is the
            # coordinator's job); they also invalidate a frozen cycle.
            self.replay.note_disruption("group")
        group_id = next(self._group_counter)
        for entry in entries:
            entry.callback = _latency_wrapped(entry.callback,
                                              self.phase_collector)
            if entry.tensor is not None and entry.tensor.is_cuda:
                self._device = entry.tensor.device
                entry.ready_event = _ready_event(entry.tensor.device)
        for request in requests:
            request.group_id = group_id
            nelem = 1
            for d in request.tensor_shape:
                nelem *= d
            self._entry_sizes[(request.process_set_id,
                               request.tensor_name)] = nelem
            if self.timeline:
                # Grouped tensors get the same negotiation span as
                # single submissions — dispatch closes one span per
                # tensor name, so every name must open one here.
                self.timeline.negotiate_start(
                    request.tensor_name, request.request_type.name)
            tl.begin_span((request.process_set_id, request.tensor_name),
                          "negotiate", tensor=request.tensor_name,
                          op=request.request_type.name)
        self.tensor_queue.add_multi(requests, entries)
        self._wake.set()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-background", daemon=True)
        self._thread.start()

    def stop_background(self):
        """Halt the cycle loop WITHOUT detaching from the coordinator
        — teardown sequencing needs the controller attachment as a
        liveness signal (see basics.shutdown: the rank-0 coordinator
        drain-waits on attachments, which lets non-leader ranks
        disconnect their jax coordination client while the leader is
        still alive; a leader going down under an attached client is
        process-fatal in jax)."""
        self._shutdown.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def quiesce(self):
        """Stop executing NEW responses and fail outstanding
        callbacks, while keeping the controller attached (see
        stop_background).  Must precede backend teardown: the recv
        thread direct-dispatches responses, so without this a frame
        arriving mid-shutdown would execute against a closed/freed
        backend."""
        if self.replay is not None:
            # Exit replay BEFORE disabling dispatch so a final partial
            # batch flushes into the (about-to-be-failed) queue rather
            # than executing against a closing backend.
            self.replay.set_enabled(False)
        self.stop_background()
        self._dispatch_disabled = True
        # A dispatch that passed the disabled check before we set it
        # may still be running on the recv thread; taking the lock
        # waits it out so the caller can close the backend safely.
        # Bounded: a dispatch stuck inside a compiled collective whose
        # peer already quiesced would otherwise hang shutdown forever
        # (mirror stop_background's join timeout).
        if self._dispatch_lock.acquire(timeout=10.0):
            self._dispatch_lock.release()
        else:
            logger.warning(
                "quiesce: in-flight response dispatch did not finish "
                "within 10s; proceeding with backend teardown")
        self.tensor_queue.shutdown_flush()
        # The streams' last work must end before the tensors it touched
        # (record_stream holds them) go back to the next incarnation.
        for stream in self._streams.values():
            stream.synchronize()
        self._streams.clear()

    def detach(self):
        """Close the controller attachment and flush callbacks."""
        if hasattr(self.controller, "shutdown"):
            self.controller.shutdown()
        self.tensor_queue.shutdown_flush()

    def stop(self):
        self.stop_background()
        self.detach()

    # ------------------------------------------------------------------
    # the cycle loop
    # ------------------------------------------------------------------
    def _loop(self):
        while not self._shutdown.is_set():
            # Event-driven sleep: waking on submit keeps single-process
            # latency near zero; the timed wait bounds the negotiation
            # cadence like the reference cycle (default 1 ms).
            self._wake.wait(timeout=self._cycle_time_s)
            self._wake.clear()
            try:
                self._run_once()
            except Exception as e:  # surface to future submitters
                logger.exception("background runtime error")
                self._on_fatal(e)
                # A broken control plane never heals within a world
                # incarnation — stop cycling (elastic re-init builds
                # a fresh runtime) instead of re-raising every 1 ms.
                return

    def add_fatal_listener(self, fn):
        self._fatal_listeners.append(fn)

    def _on_fatal(self, err: Exception):
        if self._fatal_fired:
            return
        self._fatal_fired = True
        self._error = err
        if _fr.ENABLED:
            _fr.record(_fr.FATAL, rank=self.state.rank_info.rank,
                       role="runtime", error=str(err)[:200])
            _fr.trigger_dump("fatal")
        self.tensor_queue.shutdown_flush(err)
        for fn in list(self._fatal_listeners):
            try:
                fn(err)
            except Exception:
                logger.warning("fatal listener failed", exc_info=True)

    def replay_execute(self, resp: Response):
        """Execute a frozen-schedule response on the SUBMITTING thread
        (steady-state replay): same serialization and error contract as
        recv-thread direct dispatch — replay must never overlap a
        quiesce()'d backend teardown or another dispatch."""
        with self._dispatch_lock:
            if self._dispatch_disabled:
                return  # quiesced: entries already flushed with error
            try:
                self._perform_operation(resp)
            except Exception as e:
                logger.exception("replay dispatch error")
                self._on_fatal(e)

    def _dispatch_response(self, resp: Response):
        """Executes on the controller's recv thread (direct dispatch).
        Mirrors the background loop's error contract: a failure
        surfaces to future submitters and flushes outstanding
        callbacks."""
        with self._dispatch_lock:
            if self._dispatch_disabled:
                return  # quiesced: entries already flushed with error
            try:
                self._perform_operation(resp)
            except Exception as e:
                logger.exception("response dispatch error")
                self._on_fatal(e)

    def _run_once(self):
        if _fp.ENABLED:
            # Failpoint site: one background work cycle.  delay()
            # stretches the negotiation cadence; error() is fatal to
            # the incarnation (the _loop error contract).
            _fp.maybe_fail("runtime.cycle",
                           rank=self.state.rank_info.rank)
        _CYCLES.inc()
        if self.timeline:
            self.timeline.mark_cycle_start()
        t0 = time.perf_counter()
        pending = self.tensor_queue.pop_pending()
        _QUEUE_DEPTH.set(self.tensor_queue.outstanding())
        if not pending and self.state.rank_info.size == 1:
            return
        if self.timeline and pending:
            self.timeline.counter("queue_depth", {
                "pending": len(pending),
                "outstanding": self.tensor_queue.outstanding()})
        if self.stall_inspector is not None:
            # Local watchdog only: this rank's own stuck submissions
            # (e.g. unreachable coordinator).  Cross-rank attribution —
            # "ranks a,b submitted X, ranks c,d did not" — lives on the
            # rank-0 coordinator (controller_net.stall_report /
            # native coordinator), matching the reference's rank-0
            # stall inspector (stall_inspector.h:74-80).  Recorded
            # BEFORE the requests go out, as the inline path does: the
            # recv thread may complete and remove() a tensor while
            # compute_response_list still runs, and a record made
            # after it would keep a completed tensor for ever.
            for req in pending:
                self.stall_inspector.record_uncached_tensor(
                    req.tensor_name, req.request_rank)
        responses, leftovers = self.controller.compute_response_list(
            pending, self._entry_sizes,
            self.state.knobs.fusion_threshold_bytes)
        if leftovers:
            self.tensor_queue.push_back(leftovers)
        if self.stall_inspector is not None:
            self.stall_inspector.check()
        for resp in responses:
            self._perform_operation(resp)
        if pending or responses:
            cycle_dt = time.perf_counter() - t0
            _CYCLE_SECONDS.observe(cycle_dt)
            if _slo.ENABLED:
                # SLO cycle-time SLI (common/slo.py): O(1) append
                # under the tracker's leaf lock, evaluated cold at
                # ~1 Hz.  Disabled cost: this one attribute check.
                tr = _slo.tracker()
                if tr is not None:
                    tr.note_cycle(cycle_dt)

    # ------------------------------------------------------------------
    # execution (PerformOperation analog)
    # ------------------------------------------------------------------
    def _perform_operation(self, resp: Response):
        backend = self.state.backend
        my_rank = self.state.rank_info.rank
        if resp.process_set_ranks and my_rank not in resp.process_set_ranks:
            # A process-set collective this rank is not a member of: the
            # coordinator broadcasts to everyone, non-members simply
            # don't participate in the sub-mesh program.
            return
        _RESPONSES.inc(1, op=resp.response_type.name)
        entries: List[TensorTableEntry] = []
        for i, name in enumerate(resp.tensor_names):
            e = self.tensor_queue.pop_entry(name, resp.process_set_id)
            if e is None and self._joined and resp.response_type in (
                    ResponseType.ALLREDUCE, ResponseType.ADASUM,
                    ResponseType.ALLGATHER, ResponseType.BROADCAST,
                    ResponseType.REDUCESCATTER):
                # Joined rank: substitute a zero tensor so the
                # collective still has all participants.
                shape = tuple(resp.tensor_shapes[i]) \
                    if i < len(resp.tensor_shapes) else ()
                if resp.response_type == ResponseType.ALLGATHER:
                    shape = (0,) + shape[1:]
                zero = torch.zeros(shape,
                                   dtype=torch_dtype(resp.tensor_type),
                                   device=self._device)
                e = TensorTableEntry(tensor_name=name, tensor=zero,
                                     callback=lambda ok, r: None,
                                     process_set_id=resp.process_set_id)
                if zero.is_cuda:
                    e.ready_event = _ready_event(zero.device)
                _JOIN_ZEROS.inc()
            if e is not None:
                entries.append(e)
            if self.stall_inspector is not None:
                self.stall_inspector.remove(name)
            if self.timeline:
                self.timeline.negotiate_end(name)
            tl.end_span((resp.process_set_id, name))

        if resp.response_type == ResponseType.ERROR:
            err = RuntimeError(resp.error_message)
            for e in entries:
                e.callback(False, err)
            return
        if resp.response_type == ResponseType.JOIN:
            for e in entries:
                e.callback(True, resp.last_joined_rank)
            return
        if resp.response_type == ResponseType.BARRIER:
            for e in entries:
                e.callback(True, None)
            return
        if not entries:
            return

        names = [e.tensor_name for e in entries]
        tl_name = names[0]
        ps_ranks = tuple(resp.process_set_ranks)
        sg_t0 = time.perf_counter() if _sg.ENABLED else 0.0
        if self.timeline:
            self.timeline.counter("fused_bytes", {"bytes": int(sum(
                e.tensor.nbytes for e in entries))})
        collective = tl.NO_SPAN
        if tl.recording():
            collective = tl.span(
                "collective", op=resp.response_type.name,
                tensors=len(entries), bytes=sum(
                    e.tensor.nbytes for e in entries
                    if e.tensor is not None))
        try:
            if self.timeline:
                self.timeline.start_activity(
                    tl_name, f"TORCH_{resp.response_type.name}")
            with collective, self._data_stream(entries) as stream:
                results = self._execute(backend, resp, entries, ps_ranks)
                if stream is not None:
                    done = torch.cuda.Event()
                    done.record(stream)
                    for e in entries:
                        e.done_event = done
            if self.timeline:
                self.timeline.end_activity(tl_name)
        except Exception as err:
            if self.timeline:
                self.timeline.end_activity(tl_name)
            for e in entries:
                e.callback(False, err)
            if self.state.rank_info.size > 1 and \
                    not isinstance(err, (ValueError, TypeError)):
                # The data plane failed under the world (a peer died in
                # the collective): the ranks no longer agree on what ran,
                # so every pending handle ends with the error now.
                self._on_fatal(err)
            return

        if _sg.ENABLED:
            # The fused→executed phase slice (the e2e EWMA comes from
            # the latency wrapper above); per-rank publication happens
            # on the cold MR-reply path, never here.
            self.phase_collector.note_exec(
                time.perf_counter() - sg_t0)
        if _slo.ENABLED:
            # SLO throughput SLI: one fused response completes
            # len(entries) collective ops.  Disabled cost: this one
            # attribute check.
            tr = _slo.tracker()
            if tr is not None:
                tr.note_op(len(entries))
        for e, result in zip(entries, results):
            e.callback(True, result)

    @contextlib.contextmanager
    def _data_stream(self, entries: List[TensorTableEntry]):
        """Run the response on this runtime's stream of the entries' CUDA
        device, after their ready events; yields None for CPU tensors."""
        dev = next((e.tensor.device for e in entries
                    if e.tensor is not None and e.tensor.is_cuda), None)
        if dev is None:
            yield None
            return
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            for e in entries:
                if e.ready_event is not None:
                    stream.wait_event(e.ready_event)
                if e.tensor is not None and e.tensor.is_cuda:
                    e.tensor.record_stream(stream)
            yield stream

    @staticmethod
    def _execute(backend, resp: Response,
                 entries: List[TensorTableEntry], ps_ranks):
        """The backend call of one response: its results, one per entry."""
        if resp.response_type in (ResponseType.ALLREDUCE,):
            arrays = [e.tensor for e in entries]
            results = backend.allreduce(
                arrays, resp.reduce_op, resp.prescale_factor,
                resp.postscale_factor, ps_ranks)
        elif resp.response_type == ResponseType.ADASUM:
            arrays = [e.tensor for e in entries]
            results = backend.adasum_allreduce(
                arrays, resp.prescale_factor, resp.postscale_factor,
                ps_ranks)
        elif resp.response_type == ResponseType.ALLGATHER:
            results = backend.allgather(
                [e.tensor for e in entries], resp.tensor_sizes,
                ps_ranks)
        elif resp.response_type == ResponseType.BROADCAST:
            results = backend.broadcast(
                [e.tensor for e in entries], resp.root_rank,
                ps_ranks)
        elif resp.response_type == ResponseType.ALLTOALL:
            # tensor_sizes carries the coordinator-assembled
            # group×group send-split matrix (one alltoall per
            # response — the type is never fused), so the backend
            # skips its own split-exchange collective.
            results = []
            matrix = resp.tensor_sizes or None
            for e in entries:
                out, recv_splits = backend.alltoall(
                    e.tensor, e.splits, ps_ranks,
                    split_matrix=matrix)
                results.append((out, recv_splits))
        elif resp.response_type == ResponseType.REDUCESCATTER:
            results = backend.reducescatter(
                [e.tensor for e in entries], resp.reduce_op,
                ps_ranks)
        else:
            raise RuntimeError(
                f"Unknown response type {resp.response_type}")
        return results
