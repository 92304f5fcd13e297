"""Steady-state replay: negotiation-free execution of converged cycles.

Training loops are overwhelmingly steady-state: after warm-up every
step submits the same tensors in the same order — the property PyTorch
DDP exploits with static-graph bucketing and negotiation skipping
(Li et al., VLDB '20, PAPERS.md).  The response-cache fast path already
detects this (every submission is a CH bit, every response a CB batch)
but still pays one coordinator round-trip per op: the measured tiny-op
floor (BENCH_r05: 0.435 ms median) is that round trip.

This module removes it.  Each rank tracks its own submission stream
against the CB frames it receives.  A *cycle* is the span between two
submissions of the same leading tensor; a cycle is *converged* when
every response in it arrived as a CB batch (pure cache-bit round) and
its ordered (key, signature) sequence and batch split match the
previous cycle.  After ``HOROVOD_REPLAY_WARMUP_CYCLES`` consecutive
converged cycles the rank freezes the fused response schedule and
enters REPLAY: subsequent submissions are matched against the frozen
schedule and executed directly — no CH frame, no CB wait, no wire
traffic at all.

Why rank-local entry is safe: CB/RS frames are broadcast identically
to every rank, and every rank submits the same ordered stream (the
same-graphs contract all of Horovod's negotiation rests on), so all
ranks count the same converged cycles and flip into replay at the same
logical step.  That argument additionally requires the loop to be
*synchronous at the cycle boundary* (every response delivered before
the next step's first submission — true for any loop that waits on
its handles each step, since observation precedes delivery): a
program holding async handles ACROSS the boundary would make each
cycle's convergence verdict a per-rank race.  The tracker therefore
(a) permanently disables itself the first time a clean cycle's
deliveries fail to cover its submissions (the signature of
cross-boundary pipelining, impossible in a boundary-synchronous
loop), and (b) never lets recv-thread timing touch tracking state:
frame-side disruptions (process-set or error traffic; EV/PA) act
through a monotonic op-index floor (``_void_before``) — the frame's
position in the broadcast stream, identical on every rank — rather
than by flagging "the current cycle", which is a different cycle on
different ranks.  Cycle verdicts compare that floor against the
cycle's start index (both content-deterministic), and entry
re-validates the whole stable window against the floor, which is
fully up to date by then because frames are processed in order and
the submitter blocks on the window's final response.
Should engagement ever diverge anyway, the failure is bounded, not
silent: the replaying rank's data-plane op times out (ring exchange
timeout) and the negotiating peer is attributed by the coordinator
stall machinery.  The wire format is untouched and the coordinator
(C++ or Python) needs no changes — during full replay it simply sees
no frames.

Exit conditions (any of these falls back to a normal negotiation
round, results bit-identical either way because replay executes the
very same merged Response objects the CB path built):

* an unseen tensor or a changed signature (new graph / shape change);
* a cache eviction (EV) touching a scheduled bit, or autotuned
  parameter (PA) frames;
* any RS/CB frame while replaying (defensive: a peer negotiated);
* a grouped submission, join, barrier, alltoall, or process-set
  change;
* an armed failpoint (``failpoints.ENABLED``) — fault-injection runs
  must exercise the negotiated path;
* shutdown / a broken control plane.

While an autotune-then-freeze search is live (horovod_tpu/tune), the
tracker additionally HOLDS entry — counted under
``hvd_steady_state_exits{reason="tuning"}`` — and engages only after
the freeze/abort announcement releases it (``set_tuning``); tuning and
replay are phases of one lifecycle, not mutually exclusive modes
(docs/autotune.md).

Known limitation: a rank joining EARLY (uneven data) cannot signal
peers mid-replay — their next replayed collective fails with a
bounded data-plane timeout instead of zero-substituting (see
docs/steady_state_replay.md; same restriction as DDP static_graph +
join).  Simultaneous joins are fine: each rank exits at its own join
submission.

Only ALLREDUCE / ADASUM / BROADCAST cycles are replayable: for those,
cross-rank signature agreement is enforced by negotiation itself
(mismatch is a validated ERROR), so one rank exiting on a signature
change implies every rank exits at the same step.  ALLGATHER and
REDUCESCATTER legally vary dim 0 per rank, which would let one rank
renegotiate while another replays a stale size vector — cycles
containing them never stabilize.

Observability: ``hvd_steady_state_entries`` / ``hvd_steady_state_exits``
(labeled by reason) / ``hvd_steady_state_cycles_replayed`` counters,
plus REPLAY_ENTER / REPLAY_EXIT timeline instants.  Replayed
submissions are recorded with the local stall inspector exactly like
negotiated ones, so a rank wedged mid-batch still attributes.
"""
# hvdlint-module: hot-path (instrumentation must hide behind one attribute check — docs/static_analysis.md)

import logging
import threading
from typing import List, Optional, Tuple

from . import failpoints as _fp
from . import flight_recorder as _fr
from . import metrics
from . import timeline as _tl
from .message import Request, RequestType, Response, ResponseType
from .response_cache import request_signature

logger = logging.getLogger("horovod_tpu_torch.replay")

_ENTRIES = metrics.counter(
    "hvd_steady_state_entries",
    "Times a rank froze a converged cycle and entered replay")
_EXITS = metrics.counter(
    "hvd_steady_state_exits",
    "Replay exits back into negotiation, by reason")
_CYCLES_REPLAYED = metrics.counter(
    "hvd_steady_state_cycles_replayed",
    "Full cycles executed from the frozen schedule (no wire traffic)")

# Request types whose cross-rank signature agreement is enforced by
# negotiation (see module docstring) — the only ones replay may freeze.
REPLAYABLE = {RequestType.ALLREDUCE, RequestType.ADASUM,
              RequestType.BROADCAST}
_TRACKED_RESPONSES = {ResponseType.ALLREDUCE, ResponseType.ADASUM,
                      ResponseType.BROADCAST}

# Failpoint sites whose effect is NOT bypassed by replay: they fire
# on the submitting thread BEFORE replay handling (runtime.submit is
# evaluated at the top of BackgroundRuntime.submit), so a schedule
# armed ONLY at these sites keeps its full effect under a frozen
# schedule and must not pin the negotiated path.  The straggler drills
# depend on this: a failpoint-delayed rank stays slow while replay
# stays engaged (docs/steady_state_replay.md).  Any other armed site
# still pins negotiation — fault schedules normally target the wire
# sites replay bypasses, and silently skipping them would report a
# vacuous pass.
REPLAY_SAFE_SITES = frozenset({"runtime.submit"})

# A cycle that never closes (auto-named tensors — every unnamed eager
# op gets a fresh "<op>.noname.<n>" key, so no leading key ever
# repeats) would otherwise accumulate tracking state forever.  Past
# this many ops without a boundary the tracker voids and re-anchors,
# bounding memory; the cap is far above any real per-step tensor
# count, and the trigger position is in the submission stream, so
# every rank resets at the same point.
MAX_CYCLE_OPS = 4096


class _Batch:
    """One frozen fused execution: the ordered keys this rank submits,
    their signatures, the merged Response to execute, and the cache
    bits backing it (for EV intersection)."""

    __slots__ = ("keys", "sigs", "response", "bits")

    def __init__(self, keys, sigs, response: Response, bits):
        self.keys: Tuple[tuple, ...] = tuple(keys)
        self.sigs: Tuple[tuple, ...] = tuple(sigs)
        self.response = response
        self.bits = frozenset(bits)


class SteadyStateReplay:
    """Per-rank tracker + frozen-schedule executor (one per
    BackgroundRuntime; created only for the networked controller)."""

    def __init__(self, runtime, warmup_cycles: int = 3,
                 enabled: bool = True):
        self.runtime = runtime
        self.warmup = max(1, int(warmup_cycles))
        self.enabled = enabled
        self._lock = threading.RLock()
        # Orders frozen-batch executions by match order even if several
        # submitter threads race (acquired under _lock, held across the
        # data-plane call, released after).
        self._exec_lock = threading.Lock()
        self.active = False
        # --- tracking state (inactive mode) ---
        self._cycle: List[Tuple[tuple, tuple]] = []   # [(key, sig)]
        self._delivered: List[tuple] = []  # [(kind, keys, resp, bits)]
        self._prev_cycle = None            # (keys, sigs, batch_split)
        self._last_delivered = None        # batches of last clean cycle
        self._stable = 0
        # Monotonic op-index counters, aligned 1:1 in a boundary-
        # synchronous loop: every tracked submission is matched by one
        # tracked delivery before the next cycle begins.  Disruptions
        # void convergence through _void_before — an op-index floor
        # below which no cycle may count — rather than by flagging
        # "the current cycle", because WHICH cycle is current when a
        # frame is processed is recv-thread timing, different per
        # rank, while the frame's position in the broadcast stream
        # (and so the op-index floor it sets) is identical everywhere.
        self._subs_seen = 0       # tracked submissions observed
        self._ops_delivered = 0   # tracked-response ops delivered
        self._void_before = 0     # cycles starting below this: void
        self._cycle_start = 0     # _subs_seen at current cycle start
        self._window_start = 0    # cycle_start of the stable streak
        # --- replay state (active mode) ---
        self._schedule: List[_Batch] = []
        self._sched_bits = frozenset()
        self._pos = 0
        self._batch_reqs: List[Request] = []
        self._disabled_reason: Optional[str] = None
        # Autotune-then-freeze hold (horovod_tpu/tune): while a tuning
        # session is searching, knob proposals (PA frames) re-shape
        # fused batches mid-stream, so a frozen schedule would go
        # stale the moment the next proposal lands.  The tracker keeps
        # OBSERVING cycles but refuses entry, counting each suppressed
        # entry under hvd_steady_state_exits{reason="tuning"}; the
        # freeze/abort announcement releases the hold (set_tuning) and
        # replay then engages cleanly on the tuned schedule.  This
        # replaces the old blanket autotune-disables-replay exclusion.
        self._tuning = False
        # Cached replay-safe verdict for the current failpoint rule
        # set (see REPLAY_SAFE_SITES): re-derived only when the
        # failpoint config generation changes, so the hot path never
        # takes the failpoint registry lock.
        self._fp_gen = -1
        self._fp_pins = True

    # ------------------------------------------------------------------
    # submission-side hooks (called from BackgroundRuntime.submit)
    # ------------------------------------------------------------------
    @staticmethod
    def _key(req: Request) -> tuple:
        return (req.process_set_id, req.tensor_name)

    def eligible(self, req: Request) -> bool:
        # Global-world collectives only: process-set members and
        # non-members see DIFFERENT submission streams for the same
        # CB broadcasts, so members would converge while non-members
        # never do — divergent engagement deadlocks the first global
        # tensor after entry.  A ps collective anywhere in the cycle
        # keeps every rank on the negotiated path (non-members via
        # the delivery-side check in on_responses).
        return req.group_id < 0 and req.process_set_id == 0 and \
            not req.process_set_ranks and \
            req.request_type in REPLAYABLE

    def observe_submit(self, req: Request) -> bool:
        """Track one eligible submission (inactive mode).  Returns True
        when this submission is the boundary at which replay engages —
        the caller must then route it through :meth:`replay_submit`."""
        if not self.enabled:
            return False
        key, sig = self._key(req), request_signature(req)
        with self._lock:
            if self.active:       # raced an entry on another thread
                return True
            if self._cycle and key == self._cycle[0][0]:
                self._close_cycle_locked()
                if self._stable >= self.warmup and \
                        self._try_enter_locked():
                    return True
            if len(self._cycle) >= MAX_CYCLE_OPS:
                self._void_before = self._subs_seen
                self._reset_tracking_locked()
            if not self._cycle:
                self._cycle_start = self._subs_seen
            self._cycle.append((key, sig))
            self._subs_seen += 1
            return False

    def replay_submit(self, req: Request, entry) -> bool:
        """Active mode: match ``req`` against the frozen schedule and
        execute the batch when complete.  Returns False when replay
        exited instead — the caller falls through to the normal
        negotiation path with this request untouched."""
        to_exec: Optional[Response] = None
        names: Tuple[str, ...] = ()
        with self._lock:
            if not self.active:
                return False
            if _fp.ENABLED and self._failpoints_pin_locked():
                # Armed failpoints pin the negotiated path: fault
                # schedules target the wire sites replay bypasses.
                # Replay-safe schedules (REPLAY_SAFE_SITES only) keep
                # their effect under replay and don't exit.
                self._exit_locked("failpoint")
                return False
            key, sig = self._key(req), request_signature(req)
            batch = self._schedule[self._pos]
            idx = len(self._batch_reqs)
            if idx >= len(batch.keys) or batch.keys[idx] != key:
                self._exit_locked("unseen_tensor")
                return False
            if batch.sigs[idx] != sig:
                self._exit_locked("signature_change")
                return False
            runtime = self.runtime
            # Entry lands in the table first (the error/flush machinery
            # must be able to fail it); a duplicate name is the same
            # programming error it is on the negotiated path.
            runtime.tensor_queue.add_entry_only(entry)
            if runtime.stall_inspector is not None:
                runtime.stall_inspector.record_uncached_tensor(
                    req.tensor_name, req.request_rank)
            if runtime.timeline:
                # _perform_operation closes one span per name; open it
                # as REPLAY so the trace shows which ops skipped
                # negotiation.
                runtime.timeline.negotiate_start(req.tensor_name,
                                                 "REPLAY")
            _tl.begin_span((req.process_set_id, req.tensor_name),
                           "negotiate", tensor=req.tensor_name,
                           op="REPLAY")
            self._batch_reqs.append(req)
            if len(self._batch_reqs) == len(batch.keys):
                self._batch_reqs = []
                self._pos += 1
                if self._pos >= len(self._schedule):
                    self._pos = 0
                    _CYCLES_REPLAYED.inc()
                to_exec = batch.response
                names = batch.keys
                # Acquired under _lock: executions happen in match
                # order even with racing submitter threads.
                self._exec_lock.acquire()
        if to_exec is not None:
            try:
                self.runtime.replay_execute(to_exec)
            finally:
                self._exec_lock.release()
        return True

    def _failpoints_pin_locked(self) -> bool:
        """True when the armed failpoint schedule targets any site
        replay would bypass (caller holds self._lock and has already
        seen _fp.ENABLED).  The verdict is cached per failpoint config
        generation — re-derived on configure()/reset(), never on the
        per-op path."""
        gen = _fp.CONFIG_GEN
        if gen != self._fp_gen:
            self._fp_gen = gen
            self._fp_pins = any(site not in REPLAY_SAFE_SITES
                                for site in _fp.sites())
        return self._fp_pins

    def note_disruption(self, reason: str):
        """A non-replayable event in the submission stream (group,
        join, barrier, alltoall, process-set change): exits replay if
        active, else resets convergence tracking.  These fire at
        submission-stream positions — content-deterministic under the
        same-graphs contract — so a full reset (fresh anchor at the
        next submission) is identical on every rank."""
        with self._lock:
            if self.active:
                self._exit_locked(reason)
            else:
                self._void_before = self._subs_seen
                self._reset_tracking_locked()

    # ------------------------------------------------------------------
    # controller-side hooks (called from the recv thread)
    # ------------------------------------------------------------------
    def on_responses(self, kind: str, delivered: List[tuple]):
        """``kind`` is "cb" or "rs"; ``delivered`` is a list of
        (response, bits) in broadcast order (bits empty for RS)."""
        with self._lock:
            if self.active:
                # Defensive: during full replay the coordinator is
                # silent; any response frame means some rank negotiated
                # — fall back before executing it.  Alltoall frames
                # get their own exit label: per-step-varying splits
                # are the EXPECTED steady-state-breaking traffic of
                # the sparse/DLRM workload, and lumping them under the
                # generic reason hides whether an exit storm is the
                # embedding exchange (by design) or a genuinely
                # diverged peer.
                reason = "alltoall" if any(
                    r.response_type == ResponseType.ALLTOALL
                    for r, _ in delivered) else "frame_during_replay"
                self._exit_locked(reason)
                return
            if not self.enabled:
                return  # dormant: don't accumulate delivery history
            for resp, bits in delivered:
                tracked = resp.response_type in _TRACKED_RESPONSES \
                    and not resp.error_message \
                    and resp.process_set_id == 0 \
                    and not resp.process_set_ranks
                if not tracked:
                    # Process-set / error / barrier-class traffic:
                    # its position relative to the LOCAL cycle is
                    # recv-thread timing, so flagging "the current
                    # cycle" would void cycle N on one rank and N+1 on
                    # another (divergent convergence counts = wedge).
                    # Raise the op-index floor instead: the frame's
                    # position in the broadcast stream — hence the
                    # floor value — is identical on every rank, and
                    # _close/_try_enter apply it deterministically.
                    self._void_before = max(self._void_before,
                                            self._ops_delivered)
                    continue
                if not self._cycle:
                    # No cycle in progress: a joined rank (receives
                    # every broadcast, never submits, so no boundary
                    # would ever drain this list) or a pipelined loop
                    # (the cover check at its next boundary fails and
                    # disables replay).  Either way, don't accumulate.
                    continue
                keys = tuple((resp.process_set_id, n)
                             for n in resp.tensor_names)
                self._delivered.append((kind, keys, resp, tuple(bits)))
                self._ops_delivered += len(keys)

    def on_evictions(self, bits):
        with self._lock:
            if self.active and self._sched_bits & set(bits):
                self._exit_locked("eviction")
            # Inactive: deliberately a no-op.  The evicted tensor's
            # next submission renegotiates (an RS round), and that RS
            # breaks convergence deterministically via the all-CB
            # check in _close_cycle_locked; acting on the EV frame
            # itself would tie tracking state to recv-thread timing
            # (see on_responses).  A schedule frozen just before the
            # EV is still correct — replay executes stored Responses
            # and never consults the cache, and the bit set only
            # feeds the active-mode exit above.

    def on_params(self):
        """PA frame observed.  Recv-thread timing, so the inactive
        case acts through the op-index floor exactly like the
        non-tracked traffic in on_responses — a full reset here would
        void cycle N on one rank and N+1 on another (this path was
        dead before autotune-then-freeze: PA frames used to imply
        replay was disabled outright, so nothing ever tracked while
        one arrived)."""
        with self._lock:
            if self.active:
                self._exit_locked("params")
            else:
                self._void_before = max(self._void_before,
                                        self._ops_delivered)

    def on_broken(self):
        self.note_disruption("broken")

    # ------------------------------------------------------------------
    # lifecycle / test controls
    # ------------------------------------------------------------------
    def set_tuning(self, active: bool):
        """Hold (True) or release (False) replay entry for the tuning
        lifecycle.  The release arrives as a PA frame — ordered in
        the broadcast stream but PROCESSED at recv-thread timing — so
        it must never reset tracking directly (which cycle is current
        differs per rank); it acts through the op-index floor instead:
        the post-freeze convergence window is required to start at or
        after the release's stream position, identical on every rank,
        and entry under the tuned knobs happens at the same cycle
        boundary everywhere.  The hold itself is armed before any
        traffic (runtime init), where a reset is position-free."""
        with self._lock:
            if bool(active) == self._tuning:
                return
            self._tuning = bool(active)
            if self.active:
                # Entry raced the announcement on another thread; the
                # exit flushes any partial batch back to negotiation.
                self._exit_locked("tuning")
            elif active:
                self._reset_tracking_locked()
            else:
                self._void_before = max(self._void_before,
                                        self._ops_delivered)

    def set_warmup(self, cycles: int):
        """Adopt a tuned replay-warmup knob (takes effect at the next
        convergence streak; announced via PA, so identical on every
        rank at the same stream position)."""
        with self._lock:
            self.warmup = max(1, int(cycles))

    def set_enabled(self, flag: bool):
        """Runtime toggle (bench lanes measure the negotiated floor by
        disabling replay, then re-enable it for the replay floor)."""
        with self._lock:
            self.enabled = bool(flag)
            if flag:
                self._disabled_reason = None
            else:
                if self.active:
                    self._exit_locked("disabled")
                else:
                    self._reset_tracking_locked()

    def stats(self) -> dict:
        with self._lock:
            return {"active": self.active,
                    "stable_cycles": self._stable,
                    "schedule_batches": len(self._schedule),
                    "tuning_hold": self._tuning,
                    "disabled_reason": self._disabled_reason}

    # ------------------------------------------------------------------
    # internals (caller holds self._lock)
    # ------------------------------------------------------------------
    def _close_cycle_locked(self):
        cycle, self._cycle = self._cycle, []
        delivered, self._delivered = self._delivered, []
        start = self._cycle_start
        if not cycle:
            self._stable = 0
            self._prev_cycle = None
            return
        if start < self._void_before:
            # A disruption (note_disruption, or non-tracked broadcast
            # traffic) landed at an op-index inside or after this
            # cycle's start: it cannot count.  The comparison is
            # between two content-deterministic indices, so every rank
            # reaches the same verdict for the same cycle no matter
            # when its recv thread processed the disrupting frame.
            self._stable = 0
            self._prev_cycle = None
            return
        # Converged iff the CB batches delivered since the cycle began
        # cover exactly the cycle's submissions, in order.
        flat = [k for _, keys, _, _ in delivered for k in keys]
        mixed = any(kind != "cb" for kind, _, _, _ in delivered)
        if flat != [k for k, _ in cycle] or mixed:
            self._stable = 0
            self._prev_cycle = None
            if not mixed:
                # A clean all-CB cycle whose deliveries do not cover
                # its submissions means a response was still in flight
                # at the boundary: the program pipelines submissions
                # ACROSS steps (async handles held over the boundary).
                # Whether a given rank wins that race is timing-local,
                # so convergence counting would diverge across ranks —
                # and divergent entry means one rank replays (silent)
                # while a peer negotiates (waiting for it): a wedge.
                # A synchronous-at-the-boundary program can never trip
                # this (the submitter is blocked until delivery, and
                # observation precedes delivery), so the first
                # observation proves the program is structurally
                # unsafe for replay: disable it for good.
                self.enabled = False
                self._disabled_reason = "async_overlap"
                logger.warning(
                    "steady-state replay disabled: submissions overlap"
                    " the cycle boundary (async handles held across"
                    " steps); replay requires boundary-synchronous"
                    " loops")
            return
        shape = (tuple(k for k, _ in cycle),
                 tuple(s for _, s in cycle),
                 tuple(len(keys) for _, keys, _, _ in delivered))
        if shape == self._prev_cycle and self._stable > 0 and \
                self._window_start >= self._void_before:
            self._stable += 1
        else:
            # Streak (re)starts here — including a continuing streak
            # whose window began below the floor (a disruption or
            # tuning release landed mid-streak): restarting at CLOSE
            # time keeps the anchor a pure function of content-
            # deterministic indices, so every rank restarts at the
            # same cycle no matter when its recv thread processed the
            # disrupting frame.
            self._prev_cycle = shape
            self._stable = 1
            self._window_start = start
        self._last_delivered = delivered

    def _try_enter_locked(self) -> bool:
        if self._tuning:
            # A tuning search is live: refuse entry, touching NO
            # tracking state — the release (a PA frame) lands at
            # recv-thread timing, so one rank may evaluate this
            # boundary held while a peer evaluates it released; both
            # must leave identical state behind (the released peer is
            # refused by the floor check below, which the release
            # raised) or their streaks diverge and one rank replays
            # while the other negotiates: a wedge (measured, not
            # hypothetical).  The label fires once per streak (stable
            # passes warmup exactly once while held, since nothing
            # resets it) so dashboards can tell "replay waiting on
            # the tuner" from a genuinely diverged workload.
            if self._stable == self.warmup:
                _EXITS.inc(1, reason="tuning")
                if _fr.ENABLED:
                    _fr.record(_fr.REPLAY,
                               rank=self.runtime.state.rank_info.rank,
                               phase="held", reason="tuning")
            return False
        if _fp.ENABLED and self._failpoints_pin_locked():
            # Armed failpoints pin the negotiated path (fault
            # schedules target the wire sites replay bypasses;
            # replay-safe schedules — REPLAY_SAFE_SITES only — keep
            # their effect under replay and don't pin).  Checked at
            # ENTRY, not only in replay_submit: otherwise a chaos run
            # would enter and immediately exit every warmup-K cycles,
            # inflating the entry/exit counters and spamming
            # REPLAY_ENTER/EXIT timeline instants forever.
            return False
        delivered = getattr(self, "_last_delivered", None)
        if not delivered:
            return False
        if self._window_start < self._void_before:
            # Retroactive validation: a disruption frame processed
            # AFTER some of the streak's cycles closed still voids
            # them here.  The recv thread processes frames in order
            # and the submitter blocks on the streak's final response,
            # so every frame preceding that response — anywhere a
            # disruption could hide — has been applied to
            # _void_before by the time entry is evaluated.  Pure
            # refusal, no state wipe: the NEXT cycle close restarts
            # the streak through the same window-vs-floor comparison
            # (_close_cycle_locked), at the same content-deterministic
            # position on every rank — wiping here would interleave
            # with the recv-timed tuning-hold check above and anchor
            # different ranks at different cycles.
            return False
        # Signatures are taken POSITIONALLY from the converged cycle:
        # _close_cycle_locked proved the delivered keys equal the
        # cycle's keys in order, and a cycle may legally contain the
        # same tensor name twice with different signatures (sequential
        # reuse) — a name-keyed lookup would freeze only the last one.
        sigs = self._prev_cycle[1]
        schedule, pos = [], 0
        for kind, keys, resp, bits in delivered:
            schedule.append(_Batch(
                keys, sigs[pos:pos + len(keys)], resp, bits))
            pos += len(keys)
        self._schedule = schedule
        self._sched_bits = frozenset(
            b for batch in schedule for b in batch.bits)
        self._pos = 0
        self._batch_reqs = []
        self.active = True
        _ENTRIES.inc()
        if _fr.ENABLED:
            _fr.record(_fr.REPLAY,
                       rank=self.runtime.state.rank_info.rank,
                       phase="enter", batches=len(schedule))
        if self.runtime.timeline:
            self.runtime.timeline.instant("REPLAY_ENTER")
        logger.debug("steady-state replay engaged: %d batches, %d "
                     "tensors/cycle", len(schedule),
                     sum(len(b.keys) for b in schedule))
        return True

    def _exit_locked(self, reason: str):
        if not self.active:
            return
        self.active = False
        _EXITS.inc(1, reason=reason)
        if _fr.ENABLED:
            _fr.record(_fr.REPLAY,
                       rank=self.runtime.state.rank_info.rank,
                       phase="exit", reason=reason)
        if self.runtime.timeline:
            self.runtime.timeline.instant("REPLAY_EXIT_" + reason)
        logger.debug("steady-state replay exited: %s", reason)
        # A partially-submitted batch falls back to negotiation: its
        # entries are already in the table, so only the requests need
        # to reach the coordinator.  Every rank exits at the same
        # stream position (same-graphs contract), so peers queue the
        # same requests and the round completes normally.
        reqs, self._batch_reqs = self._batch_reqs, []
        if reqs:
            self.runtime.tensor_queue.queue_requests(reqs)
            self.runtime.wake()
        self._reset_tracking_locked()

    def _reset_tracking_locked(self):
        # Callers sit at content-deterministic stream positions
        # (submission-side disruptions, replay exits, explicit
        # disable), so the fresh anchor at the next submission is the
        # same key on every rank.  Recv-thread-timed events (EV/PA,
        # process-set traffic) must NOT call this — they act through
        # the _void_before op-index floor instead (see on_responses).
        # The monotonic counters are deliberately preserved: the
        # floor semantics depend on op indices never restarting.
        self._cycle = []
        self._delivered = []
        self._prev_cycle = None
        self._last_delivered = None
        self._stable = 0
        self._schedule = []
        self._sched_bits = frozenset()
        self._pos = 0
