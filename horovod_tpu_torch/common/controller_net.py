"""Multi-process controller: coordinator/worker negotiation over TCP.

The port of the reference's coordinator protocol (reference:
controller.h:69-102 protocol spec; mpi_controller.cc / gloo_controller.cc
transport implementations): every rank pushes its ready Requests to the
rank-0 coordinator; the coordinator counts readiness per tensor
(IncrementTensorCount), validates and constructs fused Responses, and
broadcasts one ordered ResponseList to every rank.  Each rank then
executes the identical fused batch, so every process enters the same
``torch.distributed`` collectives in the same order.

Counterpart of :mod:`horovod_tpu.common.controller_net`, copied whole:
negotiation, the response cache, replay, liveness and reconnect, the
relay tree, metrics frames.  Rank 0 hosts the native C++ coordinator
(``horovod_tpu_torch/native``) or the Python ``CoordinatorServer`` by the
JAX package's rule (``_make_server``).  The
rendezvous KV client is the port's ``runner/http_server.py``: with the
launcher's ``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT`` set, rank 0
publishes its bound controller address there and the other ranks read
it.  Rank 0 builds the tuning session (``HOROVOD_TUNE``, ``tune/``) or
the legacy parameter manager (``HOROVOD_AUTOTUNE``) as the reference
does.  The elastic epoch of a lost-rank notice is the one this
process last rendezvoused at (``runner/elastic/worker.py``).

Deltas from the reference:
  * event-driven push instead of a 1 ms gather cycle — ranks send only
    when they have pending work, the coordinator fires a response batch
    as soon as every rank has reported a tensor (lower latency than
    cycle polling, no idle chatter);
  * transport is plain length-prefixed TCP (no MPI/gloo dependency) —
    the launcher provides HOROVOD_CONTROLLER_ADDR.
"""
# hvdlint-module: hot-path (instrumentation must hide behind one attribute check — docs/static_analysis.md)

import json
import logging
import os
import queue
import random
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from . import env as env_mod
from . import failpoints as _fp
from . import flight_recorder as _fr
from . import metrics
from . import profiler as _prof
from . import relay as relay_mod
from . import slo as _slo
from . import straggler as _sg
from .controller import Controller, MessageTable, construct_response
from .fusion import fuse_responses
from .message import (Request, RequestType, Response, ResponseType,
                      dtype_size, pack_bit_batches, pack_bits,
                      pack_request_list, pack_response_list,
                      unpack_bit_batches, unpack_bits,
                      unpack_request_list, unpack_response_list)
from .response_cache import (CACHEABLE, CoordinatorCache,
                             WorkerResponseCache, merge_responses,
                             request_signature, signature_to_request,
                             split_response)

logger = logging.getLogger("horovod_tpu_torch.controller_net")

CONTROLLER_ADDR_ENV = "HOROVOD_CONTROLLER_ADDR"

_MAGIC_REQ = b"RQ"      # worker→coord: full request list
_MAGIC_RESP = b"RS"     # coord→worker: full response list
_MAGIC_HITS = b"CH"     # worker→coord: cache-hit bit list (fast path)
_MAGIC_CACHE = b"CB"    # coord→worker: fused batches of cache bits
_MAGIC_EVICT = b"EV"    # coord→worker: evicted cache bits
_MAGIC_PARAMS = b"PA"   # coord→worker: autotuned runtime parameters
_MAGIC_ABORT = b"AB"    # coord→worker: membership broken, fail fast
_MAGIC_METRICS_REQ = b"MQ"  # coord→worker: send a metrics snapshot
_MAGIC_METRICS_REP = b"MR"  # worker→coord: metrics snapshot (JSON)
_MAGIC_HB = b"HB"       # both ways: liveness heartbeat (empty payload)
_MAGIC_WELCOME = b"WE"  # coord→worker: reconnect handshake answer

# Per-link replay buffers for the reconnecting control channel: each
# side keeps its last N stream frames so a link that drops and resumes
# inside the grace window replays exactly the frames the peer missed
# (TCP ordering makes the frame ordinal an implicit sequence number —
# no wire-format change).  A resume point older than the buffer is
# unrecoverable and promotes the rank to lost.
_LINK_LOG_FRAMES = 512

# Out-of-stream frames: pure signals (HB liveness) and absolute
# snapshots (MQ polls / MR replies) are excluded from the replay
# rings and the stream cursors on BOTH sides — replaying them buys
# nothing, and excluding them is what lets a relay consume a child's
# HBs (one relay HB stands in for the subtree) and aggregate its MR
# replies into one MA frame without desyncing the resume arithmetic.
# Frame bytes on the wire are unchanged; only the cursor accounting
# moved, symmetrically, on both endpoints.
_OOS_DOWN = (_MAGIC_HB, _MAGIC_METRICS_REQ)
_OOS_UP = (_MAGIC_HB, _MAGIC_METRICS_REP)


class _LinkToken:
    """Mux registration for one root link in tree mode: a direct leaf
    (kind="leaf", ident=rank, gen=conn generation) or a relay link
    (kind="relay", ident=relay id, gen=relay generation)."""
    __slots__ = ("kind", "ident", "gen", "clean")

    def __init__(self, kind, ident, gen):
        self.kind = kind
        self.ident = ident
        self.gen = gen
        self.clean = False

    def __repr__(self):
        return "<link %s %s g%d>" % (self.kind, self.ident, self.gen)

_FRAMES_SENT = metrics.counter(
    "hvd_frames_sent_total", "Control-plane frames sent, by kind")
_FRAMES_RECV = metrics.counter(
    "hvd_frames_recv_total", "Control-plane frames received, by kind")
_BYTES_SENT = metrics.counter(
    "hvd_bytes_sent_total", "Control-plane bytes sent (incl. headers)")
_BYTES_RECV = metrics.counter(
    "hvd_bytes_recv_total",
    "Control-plane bytes received (incl. headers)")
_INLINE = metrics.counter(
    "hvd_inline_cache_total",
    "Submitting-thread inline fast-path outcomes (hit = CH frame sent "
    "without waking the background thread)")
_ROUNDS = metrics.counter(
    "hvd_negotiation_rounds_total",
    "Coordinator broadcast rounds, by kind (fast = pure cache-bit CB "
    "frame, full = negotiated RS frame)")
_COORD_TENSORS = metrics.counter(
    "hvd_negotiated_tensors_total",
    "Tensors completed on the coordinator, by path")
_UPLINK_BATCH = metrics.histogram(
    "hvd_uplink_requests_per_frame",
    "Requests/bits coalesced into one uplink frame, by kind (drain-"
    "all-pending coalescing: frame count tracks batch count, not "
    "tensor count)", bounds=metrics.COUNT_BUCKETS)
_HEARTBEATS = metrics.counter(
    "hvd_liveness_heartbeats_total",
    "HB liveness frames sent, by role (suppressed while real traffic "
    "flows, so steady-state training sends none)")
_LIVENESS_TIMEOUTS = metrics.counter(
    "hvd_liveness_timeouts_total",
    "Peers promoted to dead by the liveness machinery, by role and "
    "kind (coordinator: silent rank; worker: silent coordinator)")
_RECONNECTS = metrics.counter(
    "hvd_reconnects_total",
    "Control-channel reconnect outcomes (resumed = session replayed "
    "transparently; failed = worker gave up; refused = coordinator "
    "could not replay; expired = coordinator grace window ran out)")


# The wire-framing primitives live ONCE, in relay.py (this module
# imports relay; the reverse would be a cycle).  The old private names
# stay as aliases — tests and tools import them from here.
_send_frame = relay_mod.send_frame
_recv_frame = relay_mod.recv_frame


class _LinkSilent(Exception):
    """Raised by a bounded recv's idle callback: the peer has been
    silent past the liveness deadline (the link may still be open —
    SIGSTOP, GIL deadlock, half-open socket)."""


def _recv_exact_bounded(sock: socket.socket, n: int, on_idle,
                        on_data=None):
    """`_recv_exact` for a socket with a poll timeout set: every
    timeout expiry calls ``on_idle()`` — which raises to abort the
    wait — so no control-plane recv can block forever.  ``on_data``
    fires on every received chunk so a large frame trickling in slower
    than the liveness timeout still counts as a live peer."""
    buf = b""
    while len(buf) < n:
        try:
            # hvdlint: bounded-by(caller arms a poll settimeout; every
            # expiry raises through on_idle)
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            on_idle()
            continue
        if not chunk:
            return None
        if on_data is not None:
            on_data()
        buf += chunk
    return buf


def _recv_frame_bounded(sock: socket.socket, on_idle, on_data=None
                        ) -> Optional[Tuple[bytes, bytes]]:
    head = _recv_exact_bounded(sock, 6, on_idle, on_data)
    if head is None:
        return None
    magic, ln = head[:2], struct.unpack("<I", head[2:])[0]
    payload = _recv_exact_bounded(sock, ln, on_idle, on_data)
    if payload is None:
        return None
    return magic, payload


def _parse_registration(payload: bytes) -> Tuple[int, dict]:
    """Registration frame payload: 4-byte rank, optionally followed by
    a JSON session blob (reconnecting-channel handshake).  The plain
    4-byte form remains valid — and is all the native coordinator ever
    sees (it reads the first 4 bytes and ignores the rest).  A
    too-short payload (garbage client) parses as an invalid rank
    rather than raising into the accept loop."""
    if len(payload) < 4:
        return -1, {}
    rank = struct.unpack("<i", payload[:4])[0]
    session = {}
    if len(payload) > 4:
        try:
            session = json.loads(payload[4:].decode())
        except (ValueError, UnicodeDecodeError):
            session = {}
    return rank, session


class CoordinatorServer:
    """Rank-0 service: accepts one connection per rank (including a
    loopback connection from rank 0's own worker), matches requests,
    broadcasts fused response lists."""

    def __init__(self, size: int, bind_addr: str = "0.0.0.0",
                 port: int = 0, fusion_threshold: int = 64 << 20,
                 timeline=None, elastic: bool = False,
                 allow_ephemeral_fallback: bool = False,
                 param_manager=None, cache_capacity: int = 1024,
                 stall_warning_time_s: float = 60.0,
                 stall_shutdown_time_s: float = 0.0,
                 metrics_interval_s: float = 0.0,
                 liveness_interval_s: float = 0.0,
                 liveness_timeout_s: float = 0.0,
                 reconnect_grace_s: float = 0.0,
                 registration_timeout_s: float = 30.0,
                 fanout: int = 0,
                 on_rank_lost=None,
                 tune_session=None,
                 on_rank_slow=None):
        self.size = size
        self.fusion_threshold = fusion_threshold
        self.timeline = timeline
        self.elastic = elastic
        self.allow_ephemeral_fallback = allow_ephemeral_fallback
        self._broken = False
        # Autotuner (rank-0 only: fusion planning happens here, so the
        # threshold needs no cross-rank sync — reference
        # parameter_manager.cc semantics, SURVEY §2.1).
        self.param_manager = param_manager
        if param_manager is not None:
            param_manager.fusion_threshold_bytes = fusion_threshold
        # Last PA-frame-synced categorical params version (-1 = stock
        # configuration, nothing announced yet).
        self._synced_params_version = -1
        self._synced_params = None
        # Autotune-then-freeze session (horovod_tpu/tune): scores
        # every round per cycle-class, proposes knobs, freezes.  Its
        # announcements ride the same PA frame + registration-replay
        # machinery as the legacy param_manager; its per-class fusion
        # thresholds are applied at fuse time below.  Priming
        # _synced_params here makes the startup announcement (search
        # active / profile-frozen) reach every rank at registration.
        self.tune_session = tune_session
        if tune_session is not None:
            p = tune_session.take_announcement()
            if p is not None:
                self._synced_params = json.dumps(p).encode()
        self._table = MessageTable()
        self._seen = 0
        self._departed = 0
        self._departed_cond = threading.Condition()
        # (psid, name) -> element count, for fusion byte accounting
        self._elem_cache: Dict[tuple, int] = {}
        # (psid, name) -> grouped-submission id (group-atomic fusion)
        self._group_ids: Dict[tuple, int] = {}
        self._joined: Set[int] = set()
        self._last_joined = -1
        # barrier (psid, name) -> ranks arrived
        self._barriers: Dict[tuple, Set[int]] = {}
        # barrier (psid, name) -> member ranks (for stall attribution)
        self._barrier_members: Dict[tuple, Tuple[int, ...]] = {}
        # --- response-cache fast path (reference controller.cc:81-236) ---
        self._cache = CoordinatorCache(cache_capacity)
        # (psid, name) -> True while every contribution this round came
        # from a live cache bit (a full request degrades the round)
        self._bit_only: Dict[tuple, bool] = {}
        self._pending_evictions: List[int] = []
        self.stats = {"full_rounds": 0, "fast_rounds": 0,
                      "fast_tensors": 0, "negotiated_tensors": 0}
        # --- coordinator-side stall attribution (reference
        #     stall_inspector.h:74-80: rank 0 names which ranks are
        #     missing a tensor) ---
        self._first_seen: Dict[tuple, float] = {}
        self._stall_warning_s = stall_warning_time_s
        self._stall_shutdown_s = stall_shutdown_time_s
        self._stall_logged: Dict[tuple, float] = {}
        self._conns: Dict[int, socket.socket] = {}
        # Formation gate: NOTHING may be negotiated (and so no frame
        # broadcast) until every rank of this incarnation has
        # connected — a response completed among early connectors
        # would never reach a late one (measured: subgroup-first
        # traffic wedged/desynced ranks that missed the first RS,
        # tests/test_stress_protocol.py).  Uplink frames arriving
        # before formation buffer here and drain, in arrival order,
        # when the last rank registers.
        self._formed = size <= 1
        self._pre_formed: List[tuple] = []  # (kind, rank, payload)
        self._started_at = time.monotonic()  # formation-stall clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # --- self-healing control plane (docs/failure_recovery.md) ---
        # Liveness: bounded-time detection of wedged-but-connected
        # ranks via HB heartbeats + a sweep, with no dependence on a
        # collective being in flight.  Reconnect: a dead socket parks
        # the rank in limbo for a grace window; a resume replays the
        # frames it missed from the per-rank out-log.
        self.liveness_interval_s = liveness_interval_s
        self.liveness_timeout_s = liveness_timeout_s or \
            2.0 * liveness_interval_s
        self.reconnect_grace_s = reconnect_grace_s
        self.registration_timeout_s = registration_timeout_s
        self._on_rank_lost_hook = on_rank_lost
        self._last_heard: Dict[int, float] = {}
        self._departure_counted: Set[int] = set()
        # Per-rank stream lock: frame processing + the _in_count
        # cursor advance are atomic under it, and the resume handshake
        # takes it to wait out an in-flight frame — so a frame is
        # either fully processed (counted, not replayed) or discarded
        # un-counted (replayed by the worker).  Never both.
        self._stream_locks: Dict[int, threading.Lock] = {}
        self._sessions: Dict[int, str] = {}
        self._conn_gen: Dict[int, int] = {}   # supersession guard
        self._limbo: Dict[int, float] = {}    # rank -> disconnect time
        self._lost: Set[int] = set()          # final (idempotence)
        self._out_log: Dict[int, deque] = {}  # rank -> (ord, magic, pl)
        self._out_seq: Dict[int, int] = {}    # downlink frames sent
        self._in_count: Dict[int, int] = {}   # uplink frames processed
        self._last_broadcast_t = time.monotonic()
        # --- relay-tree fan-out (common/relay.py, HOROVOD_COORD_FANOUT)
        # Per-rank stream state above stays HERE even for ranks served
        # through a relay: relays are stateless forwarders, so every
        # re-home resumes against the root's out-logs and cursors.
        self._plan = relay_mod.plan_tree(size, fanout) \
            if fanout > 0 else None
        self._tree = self._plan is not None
        self._rank_via: Dict[int, int] = {}    # rank -> root-side relay
        self._via_epoch: Dict[int, int] = {}   # rank -> child-conn epoch
        self._via_suspect: Dict[int, tuple] = {}  # rank -> (t, gen)
        self._relay_conns: Dict[int, socket.socket] = {}
        self._relay_gen: Dict[int, int] = {}
        self._relay_depth: Dict[int, int] = {}
        self._relay_metrics: Dict[int, dict] = {}
        # Lazy deadline heap: the liveness sweep visits only links
        # whose deadline lapsed, O(due) per tick instead of O(world)
        # (relay.DeadlineHeap; pinned by tests/test_relay_tree.py).
        self._lheap = relay_mod.DeadlineHeap()
        # Plain-int probe counters (tools/chaos_soak scale probe reads
        # them; ints, not registry metrics, so the hot path pays only
        # the increments).
        self.uplink_frames = 0
        self.bcast_ns = 0
        self.bcast_sends = 0
        # --- live straggler observatory (common/straggler.py): fold
        #     the CH/RQ arrival order — today's discard — into
        #     per-rank lag EWMAs, adopt the MR/MA-carried worker phase
        #     summaries so attribution keeps working during replay,
        #     and refresh the hvd_straggler_score gauges on a small
        #     loop.  None when disarmed: the frame dispatch hot path
        #     then pays exactly one attribute check.  Constructed
        #     BEFORE any serving thread starts (frames may dispatch
        #     the moment the accept loop runs).
        self._straggler = _sg.StragglerScorer(
            size, on_slow=on_rank_slow) if _sg.ENABLED else None
        self._straggler_thread = None
        self._mux = None
        if self._tree:
            # Selector/batched recv loop: ONE thread drains every root
            # link (O(fanout) relay links + direct leaves) instead of
            # a thread per rank.  Flat star (fanout=0) keeps the
            # thread-per-link path byte-identically.
            self._mux = relay_mod.FrameMux(
                self._mux_frame, self._mux_close,
                name="hvd-coord-mux", on_data=self._mux_data)
            self._mux.start()
            logger.info("relay-tree coordinator: %s",
                        self._plan.to_meta())
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._srv.bind((bind_addr, port))
        except OSError:
            if not self.allow_ephemeral_fallback:
                # Without a rendezvous store to publish the real port,
                # an ephemeral fallback would leave workers hanging on
                # the dead env-contract port — fail crisply instead.
                raise
            # The launcher-chosen port got taken in the meantime; fall
            # back to an ephemeral port.  The actual address is
            # published through the rendezvous KV store, which workers
            # prefer over the env contract.
            logger.warning("controller port %d unavailable; using an "
                           "ephemeral port", port)
            self._srv.bind((bind_addr, 0))
        self._srv.listen(size + 4)
        self.port = self._srv.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="hvd-coord-accept", daemon=True)
        self._threads: List[threading.Thread] = []
        self._accept_thread.start()
        self._stall_thread = None
        if stall_warning_time_s > 0:
            self._stall_thread = threading.Thread(
                target=self._stall_loop, name="hvd-coord-stall",
                daemon=True)
            self._stall_thread.start()
        # The sweep must also run for grace-only configurations
        # (liveness off, reconnects on): limbo expiry lives in the
        # sweep, and without it a permanently dead rank would park in
        # limbo forever.
        self._liveness_thread = None
        if liveness_interval_s > 0 or reconnect_grace_s > 0:
            self._liveness_thread = threading.Thread(
                target=self._liveness_loop, name="hvd-coord-liveness",
                daemon=True)
            self._liveness_thread.start()
        # --- cross-rank metrics aggregation (MQ/MR frames): collect
        #     per-rank registry snapshots and expose the merged view,
        #     the metrics analog of the rank-0 stall report ---
        self._rank_metrics: Dict[int, dict] = {}
        self._metrics_interval_s = metrics_interval_s
        self._metrics_thread = None
        if metrics_interval_s > 0:
            self._metrics_thread = threading.Thread(
                target=self._metrics_loop, name="hvd-coord-metrics",
                daemon=True)
            self._metrics_thread.start()
        if self._straggler is not None:
            self._straggler_thread = threading.Thread(
                target=self._straggler_loop,
                name="hvd-coord-straggler", daemon=True)
            self._straggler_thread.start()

    def _accept_loop(self):
        self._srv.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # First frame identifies the rank.  Bound the wait so a
            # connected-but-silent client can't stall registration of
            # the remaining ranks (HOROVOD_REGISTRATION_TIMEOUT).
            conn.settimeout(self.registration_timeout_s)
            try:
                frame = _recv_frame(conn)
            except (socket.timeout, OSError):
                conn.close()
                continue
            if frame is None:
                conn.close()
                continue
            if frame[0] != _MAGIC_REQ:
                # frame-parity: the only first frame a link may send
                # is an RQ registration.  Anything else is a garbage /
                # misdirected client — drop the connection, never
                # guess a rank out of arbitrary bytes.
                logger.warning("refusing connection whose first frame "
                               "is %r (want RQ registration)",
                               frame[0])
                conn.close()
                continue
            rank, sess = _parse_registration(frame[1])
            if relay_mod.is_relay_reg(rank):
                self._register_relay(
                    relay_mod.relay_id_from_reg(rank), sess, conn)
            elif rank < 0 or rank >= self.size:
                logger.warning("refusing registration with invalid "
                               "rank %d", rank)
                try:
                    conn.close()
                except OSError:
                    pass
            elif sess.get("resume"):
                self._try_resume(rank, sess, conn)
            else:
                self._register_fresh(rank, sess, conn)

    def _register_relay(self, rid: int, sess: dict,
                        conn: socket.socket):
        """A relay link attached (tree mode): it serves every leaf
        whose RG registration it forwards; it carries no stream state
        of its own (stateless fail-stop forwarder)."""
        if not self._tree:
            logger.warning("refusing relay %d registration: "
                           "HOROVOD_COORD_FANOUT is off", rid)
            try:
                conn.close()
            except OSError:
                pass
            return
        with self._lock:
            old = self._relay_conns.get(rid)
            self._relay_conns[rid] = conn
            self._relay_gen[rid] = gen = self._relay_gen.get(rid, 0) + 1
            self._relay_depth[rid] = max(1, int(sess.get(
                "depth_below", 1)))
            key = ("relay", rid)
            self._last_heard[key] = time.monotonic()
            if self.liveness_interval_s > 0:
                self._lheap.schedule(
                    key, self._last_heard[key] +
                    env_mod.depth_aware_liveness_timeout(
                        self.liveness_timeout_s,
                        self._relay_depth[rid]))
        if old is not None and old is not conn:
            try:
                old.close()
            except OSError:
                pass
        # hvdlint: bounded-by(mux-served link: the selector loop polls
        # at 0.2s and liveness sweeps cover silent relays)
        conn.settimeout(None)
        logger.info("relay %d link registered (depth_below=%d)", rid,
                    self._relay_depth[rid])
        if _fr.ENABLED:
            _fr.record(_fr.RELAY_ATTACH, rank=0, role="coord",
                       relay=rid, depth=self._relay_depth[rid],
                       cyc=gen)
        self._mux.add(_LinkToken("relay", rid, gen), conn)

    def _install_conn_locked(self, rank: int, conn: socket.socket) -> int:
        """Install ``conn`` as rank's live link (superseding any stale
        one) and return its link generation — rank-loop exits compare
        generations so a replaced link's death can't demote a resumed
        rank (caller holds self._lock)."""
        old = self._conns.get(rank)
        if old is not None and old is not conn:
            try:
                old.close()
            except OSError:
                pass
        self._conns[rank] = conn
        # A direct link supersedes any relay attachment (re-home to
        # the root after a relay loss).
        self._rank_via.pop(rank, None)
        self._via_epoch.pop(rank, None)
        self._via_suspect.pop(rank, None)
        self._conn_gen[rank] = self._conn_gen.get(rank, 0) + 1
        self._stream_locks.setdefault(rank, threading.Lock())
        self._last_heard[rank] = time.monotonic()
        if self.liveness_interval_s > 0:
            self._lheap.schedule(rank, self._last_heard[rank] +
                                 self.liveness_timeout_s)
        if self._tree:
            # Mux-served link: select() gates recv, no poll timeout.
            # hvdlint: bounded-by(selector loop polls at 0.2s)
            conn.settimeout(None)
        elif self.liveness_interval_s > 0:
            # Bounded registered-link recv: the rank loop polls at a
            # fraction of the liveness timeout instead of blocking in
            # recv forever (the pre-liveness settimeout(None) hole).
            conn.settimeout(self._sweep_period())
        else:
            # hvdlint: bounded-by(liveness off is the documented
            # legacy opt-out: the stall inspector is the only clock;
            # HOROVOD_LIVENESS_INTERVAL>0 bounds this link)
            conn.settimeout(None)
        return self._conn_gen[rank]

    def _register_fresh(self, rank: int, sess: dict,
                        conn: socket.socket):
        if _fr.ENABLED:
            _fr.record(_fr.REGISTER, rank=0, role="coord", peer=rank,
                       sess=(sess.get("session") or "")[:8])
        with self._lock:
            gen = self._install_conn_locked(rank, conn)
            self._sessions[rank] = sess.get("session", "")
            self._limbo.pop(rank, None)
            # A fresh session starts a fresh frame stream.
            self._out_seq[rank] = 0
            self._in_count[rank] = 0
            if self.reconnect_grace_s > 0:
                self._out_log[rank] = deque(maxlen=_LINK_LOG_FRAMES)
            # Late joiners (elastic re-rendezvous) must start from
            # the currently announced parameters, and they see the
            # PA frame before any response frame — the same stream
            # position every other worker saw it at.
            if self._synced_params is not None:
                self._send_to_rank_locked(rank, _MAGIC_PARAMS,
                                          self._synced_params)
            self._maybe_form_locked()
        self._note_fresh_life(rank)
        self._serve_link(rank, conn, gen)

    def _attached_ranks_locked(self) -> Set[int]:
        """Leaf ranks currently attached — directly or via a relay
        (caller holds self._lock)."""
        ranks = set(self._conns.keys())
        ranks.update(self._rank_via.keys())
        return ranks

    def _maybe_form_locked(self):
        if not self._formed and \
                len(self._attached_ranks_locked()) >= self.size:
            self._formed = True
            pre, self._pre_formed = self._pre_formed, []
            for kind, r, payload in pre:
                self._dispatch_uplink_locked(kind, r, payload)

    def _note_fresh_life(self, rank: int):
        with self._departed_cond:
            # A fresh session is a new rank life: it gets its own
            # seen/departed pair (a restarted process re-registering
            # mid-incarnation must keep the drain arithmetic balanced).
            self._departure_counted.discard(rank)
            self._seen += 1
            self._departed_cond.notify_all()

    def _serve_link(self, rank: int, conn: socket.socket, gen: int):
        if self._tree:
            self._mux.add(_LinkToken("leaf", rank, gen), conn)
        else:
            self._spawn_rank_loop(rank, conn, gen)

    # ------------------------------------------------------------------
    # tree mode: the selector/batched recv loop (one thread, all links)
    # ------------------------------------------------------------------
    def _mux_data(self, token: "_LinkToken"):
        # Chunk-level liveness refresh: a large frame trickling in
        # slower than the deadline still counts as a live peer (the
        # thread-mode on_data analog).
        key = token.ident if token.kind == "leaf" \
            else ("relay", token.ident)
        self._last_heard[key] = time.monotonic()

    def _mux_frame(self, token: "_LinkToken", magic: bytes,
                   payload: bytes):
        if self._stop.is_set():
            return False
        if token.kind == "relay":
            return self._relay_frame(token, magic, payload)
        return self._direct_frame(token, magic, payload)

    def _direct_frame(self, token: "_LinkToken", magic: bytes,
                      payload: bytes):
        """One frame from a DIRECT leaf link in tree mode — the exact
        semantics of the flat-star rank loop body."""
        rank, gen = token.ident, token.gen
        if self._conn_gen.get(rank, 0) != gen:
            return False  # superseded; on_close is a no-op via gen
        self._last_heard[rank] = time.monotonic()
        if magic in _OOS_UP:
            _FRAMES_RECV.inc(1, kind=magic.decode("ascii", "replace"))
            if _fr.ENABLED and magic == _MAGIC_HB:
                _fr.record(_fr.HB_RX, rank=0, role="coord", peer=rank)
            if magic == _MAGIC_METRICS_REP:
                self._handle_metrics_snapshot(rank, payload)
            return True
        self.uplink_frames += 1
        if _fr.ENABLED:
            _fr.record(_fr.FRAME_RX, rank=0, role="coord", peer=rank,
                       frame=magic.decode("ascii", "replace"),
                       nbytes=len(payload),
                       seq=self._in_count.get(rank, 0) + 1, cyc=gen)
        if _fp.ENABLED:
            try:
                if _fp.maybe_fail("coord.frame_recv",
                                  rank=rank) == "drop":
                    lock = self._stream_locks.get(rank)
                    if lock is not None:
                        with lock:
                            if self._conn_gen.get(rank, 0) == gen:
                                self._in_count[rank] = \
                                    self._in_count.get(rank, 0) + 1
                    return True
            except _fp.FailpointError:
                return False  # injected error kills this link
        _FRAMES_RECV.inc(1, kind=magic.decode("ascii", "replace"))
        _BYTES_RECV.inc(len(payload) + 6)
        stream_lock = self._stream_locks.get(rank)
        if stream_lock is None:
            return False
        with stream_lock:
            if self._conn_gen.get(rank, 0) != gen:
                return False
            try:
                if magic == _MAGIC_HITS:
                    self._handle_cache_hits(rank, unpack_bits(payload))
                    return True
                requests, shutdown = unpack_request_list(payload)
                if shutdown:
                    token.clean = True
                    return False
                self._handle_requests(rank, requests)
                return True
            finally:
                self._in_count[rank] = self._in_count.get(rank, 0) + 1

    def _relay_frame(self, token: "_LinkToken", magic: bytes,
                     payload: bytes):
        rid, gen = token.ident, token.gen
        if self._relay_gen.get(rid, 0) != gen:
            return False
        self._last_heard[("relay", rid)] = time.monotonic()
        if magic == _MAGIC_HB:
            _FRAMES_RECV.inc(1, kind="HB")
            if _fr.ENABLED:
                _fr.record(_fr.HB_RX, rank=0, role="coord", relay=rid)
            return True
        if magic == relay_mod.MAGIC_METRICS_AGG:
            self._handle_metrics_aggregate(rid, payload)
            return True
        if magic == relay_mod.MAGIC_RELAY_LOST:
            self._handle_relay_lost(rid, payload)
            return True
        if magic == relay_mod.MAGIC_RELAY_BATCH:
            self.uplink_frames += 1
            _FRAMES_RECV.inc(1, kind="RB")
            _BYTES_RECV.inc(len(payload) + 6)
            try:
                items = relay_mod.unpack_rb_items(payload)
            except (struct.error, IndexError):
                logger.error("corrupt RB frame from relay %d; "
                             "dropping the link", rid)
                return False
            for origin, epoch, imagic, ipayload in items:
                self._relay_item(rid, origin, epoch, imagic, ipayload)
            return True
        logger.warning("unexpected %s frame on relay link %d",
                       magic.decode("ascii", "replace"), rid)
        return True

    def _relay_item(self, rid: int, origin: int, epoch: int,
                    magic: bytes, payload: bytes):
        """One leaf uplink item forwarded through a relay.  Stream
        items (CH/RQ) are processed under the leaf's stream lock with
        an attachment check — (relay id, child epoch) must match the
        rank's current attachment, so frames in flight from a
        superseded child socket are discarded UN-counted and the
        leaf's resume replay re-delivers them exactly once."""
        if magic == relay_mod.MAGIC_REGISTER:
            rank, sess = _parse_registration(payload)
            if rank != origin:
                logger.warning("relay %d forwarded a registration for "
                               "rank %d tagged origin %d; ignoring",
                               rid, rank, origin)
                return
            if sess.get("resume"):
                self._try_resume_remote(rank, sess, rid, epoch)
            else:
                self._register_fresh_remote(rank, sess, rid, epoch)
            return
        if magic in _OOS_UP:
            # Relays normally consume HB/MR; handle stragglers anyway.
            if magic == _MAGIC_METRICS_REP:
                self._handle_metrics_snapshot(origin, payload)
            return
        if _fr.ENABLED:
            _fr.record(_fr.FRAME_RX, rank=0, role="coord",
                       peer=origin, via=rid,
                       frame=magic.decode("ascii", "replace"),
                       nbytes=len(payload),
                       seq=self._in_count.get(origin, 0) + 1,
                       cyc=epoch)
        if _fp.ENABLED:
            try:
                if _fp.maybe_fail("coord.frame_recv",
                                  rank=origin) == "drop":
                    lock = self._stream_locks.get(origin)
                    if lock is not None:
                        with lock:
                            if self._rank_via.get(origin) == rid and \
                                    self._via_epoch.get(origin) == epoch:
                                self._in_count[origin] = \
                                    self._in_count.get(origin, 0) + 1
                    return
            except _fp.FailpointError:
                logger.warning("failpoint coord.frame_recv: injected "
                               "error on relayed frame; dropping it")
                return
        stream_lock = self._stream_locks.get(origin)
        if stream_lock is None:
            return  # never registered; nothing to do
        with stream_lock:
            if self._rank_via.get(origin) != rid or \
                    self._via_epoch.get(origin) != epoch:
                return  # superseded attachment; un-counted
            try:
                if magic == _MAGIC_HITS:
                    self._handle_cache_hits(origin,
                                            unpack_bits(payload))
                    return
                requests, shutdown = unpack_request_list(payload)
                if shutdown:
                    self._remote_clean_departure(origin)
                    return
                self._handle_requests(origin, requests)
            finally:
                self._in_count[origin] = \
                    self._in_count.get(origin, 0) + 1

    def _remote_clean_departure(self, rank: int):
        """Shutdown frame from a relay-attached rank — the mirror of
        the rank loop's clean exit (caller holds the stream lock; the
        server lock nests inside it everywhere)."""
        with self._lock:
            self._detach_rank_locked(rank)
        self._count_departed(rank)
        if not self._stop.is_set():
            self._promote_lost(rank, clean=True)

    def _detach_rank_locked(self, rank: int):
        old = self._conns.pop(rank, None)
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        self._rank_via.pop(rank, None)
        self._via_epoch.pop(rank, None)
        self._via_suspect.pop(rank, None)

    def _register_fresh_remote(self, rank: int, sess: dict, rid: int,
                               epoch: int):
        """Fresh leaf registration forwarded through a relay: the
        mirror of _register_fresh with the relay link as transport.
        The targeted WE ack opens the relay's broadcast gate for this
        child — broadcasts the root sent before this point were never
        logged for the rank, so the relay must not deliver them."""
        with self._lock:
            if self._relay_conns.get(rid) is None:
                return
            self._detach_rank_locked(rank)
            self._conn_gen[rank] = self._conn_gen.get(rank, 0) + 1
            self._rank_via[rank] = rid
            self._via_epoch[rank] = epoch
            self._stream_locks.setdefault(rank, threading.Lock())
            self._last_heard[rank] = time.monotonic()
            self._sessions[rank] = sess.get("session", "")
            self._limbo.pop(rank, None)
            # Relay-attached ranks report metrics through their
            # relay's MA aggregate; a frozen direct snapshot left
            # behind would double count them in every future merge.
            self._rank_metrics.pop(rank, None)
            self._out_seq[rank] = 0
            self._in_count[rank] = 0
            if self.reconnect_grace_s > 0:
                self._out_log[rank] = deque(maxlen=_LINK_LOG_FRAMES)
            self._send_targeted_locked(
                rank, _MAGIC_WELCOME,
                json.dumps({"resume": False, "recv_count": 0}).encode(),
                log=False)
            if self._synced_params is not None:
                self._send_targeted_locked(rank, _MAGIC_PARAMS,
                                           self._synced_params)
            self._maybe_form_locked()
        self._note_fresh_life(rank)

    def _try_resume_remote(self, rank: int, sess: dict, rid: int,
                           epoch: int):
        """Resume handshake arriving through a relay (a leaf
        re-homing after its previous link — possibly a whole relay —
        died).  Same three-phase structure as _try_resume; WE + the
        downlink replay travel RD-wrapped so the relay routes them to
        exactly this child (and opens its broadcast gate)."""
        with self._lock:
            recv_count = int(sess.get("recv_count", 0))
            out_seq = self._out_seq.get(rank, 0)
            log = self._out_log.get(rank)
            rconn = self._relay_conns.get(rid)
            ok = (self.reconnect_grace_s > 0 and
                  rank not in self._lost and
                  rconn is not None and
                  sess.get("session") and
                  sess.get("session") == self._sessions.get(rank) and
                  log is not None and
                  0 <= recv_count <= out_seq and
                  out_seq - recv_count <= len(log))
            if not ok:
                logger.warning(
                    "refusing relayed resume for rank %d via relay %d "
                    "(session %s, recv_count %d/%d)", rank, rid,
                    (sess.get("session") or "?")[:8], recv_count,
                    out_seq)
                _RECONNECTS.inc(1, outcome="refused")
                if _fr.ENABLED:
                    _fr.record(_fr.RESUME, rank=0, role="coord",
                               peer=rank, outcome="refused", via=rid,
                               seq=recv_count)
                if rconn is not None:
                    try:
                        _send_frame(rconn, relay_mod.MAGIC_RELAY_DOWN,
                                    relay_mod.pack_rd(
                                        rank, _MAGIC_WELCOME,
                                        json.dumps({"resume": False}
                                                   ).encode()))
                    except OSError:
                        pass
                return
            # Phase 1: supersede the old attachment (direct conn OR a
            # previous relay/epoch); hold the rank in limbo so
            # broadcasts keep logging until the backlog is replayed.
            old = self._conns.pop(rank, None)
            self._rank_via.pop(rank, None)
            self._via_epoch.pop(rank, None)
            self._via_suspect.pop(rank, None)
            self._conn_gen[rank] = gen = \
                self._conn_gen.get(rank, 0) + 1
            self._limbo[rank] = time.monotonic()
            stream_lock = self._stream_locks.setdefault(
                rank, threading.Lock())
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        # Phase 2: wait out an in-flight frame on the old transport so
        # the uplink cursor is stable before we quote it.
        with stream_lock:
            in_count = self._in_count.get(rank, 0)
        # Phase 3: attach via the relay and replay the missed downlink.
        with self._lock:
            rconn = self._relay_conns.get(rid)
            if self._conn_gen.get(rank, 0) != gen or \
                    rank in self._lost or rconn is None or \
                    self._out_seq.get(rank, 0) - recv_count > len(log):
                logger.warning("relayed resume for rank %d aborted "
                               "mid-handshake", rank)
                _RECONNECTS.inc(1, outcome="refused")
                return
            self._rank_via[rank] = rid
            self._via_epoch[rank] = epoch
            self._last_heard[rank] = time.monotonic()
            self._limbo.pop(rank, None)
            # See _register_fresh_remote: metrics now ride the relay's
            # MA aggregate; drop any frozen direct snapshot.
            self._rank_metrics.pop(rank, None)
            try:
                _send_frame(rconn, relay_mod.MAGIC_RELAY_DOWN,
                            relay_mod.pack_rd(
                                rank, _MAGIC_WELCOME,
                                json.dumps({"resume": True,
                                            "recv_count": in_count}
                                           ).encode()))
                for ordinal, magic, payload in log:
                    if ordinal > recv_count:
                        _send_frame(rconn, relay_mod.MAGIC_RELAY_DOWN,
                                    relay_mod.pack_rd(rank, magic,
                                                      payload))
            except OSError:
                # The relay link died mid-handshake: back to limbo;
                # the leaf retries (and will climb its ancestor chain).
                self._rank_via.pop(rank, None)
                self._via_epoch.pop(rank, None)
                self._enter_limbo_locked(rank)
                return
        logger.info("rank %d re-homed via relay %d (replayed %d "
                    "downlink frames)", rank, rid,
                    self._out_seq.get(rank, 0) - recv_count)
        _RECONNECTS.inc(1, outcome="resumed")
        if _fr.ENABLED:
            _fr.record(_fr.RESUME, rank=0, role="coord", peer=rank,
                       outcome="resumed", via=rid, cyc=epoch,
                       replayed=self._out_seq.get(rank, 0) - recv_count)

    def _send_targeted_locked(self, rank: int, magic: bytes,
                              payload: bytes, log: bool = True):
        """One downlink frame to one specific rank, over whatever
        transport it is attached by — direct send, or RD-wrapped via
        its relay (caller holds self._lock)."""
        if log:
            self._log_out_locked(rank, magic, payload)
        conn = self._conns.get(rank)
        if conn is not None:
            try:
                _send_frame(conn, magic, payload)
                return True
            except OSError:
                if self.reconnect_grace_s > 0 and \
                        rank not in self._lost:
                    self._enter_limbo_locked(rank)
                else:
                    self._conns.pop(rank, None)
                return False
        rid = self._rank_via.get(rank)
        rconn = self._relay_conns.get(rid) if rid is not None else None
        if rconn is None:
            return False
        try:
            _send_frame(rconn, relay_mod.MAGIC_RELAY_DOWN,
                        relay_mod.pack_rd(rank, magic, payload))
            return True
        except OSError:
            return False  # the mux reaps the dead relay link

    def _subtree_slack(self) -> float:
        """Detection allowance for leaves behind a troubled interior
        node: before they can re-home they must first notice the
        silence themselves, bounded by their own depth-aware deadline
        (they may be deeper than the link the root observed)."""
        levels = self._plan.levels if self._plan is not None else 1
        return env_mod.depth_aware_liveness_timeout(
            self.liveness_timeout_s, levels)

    def _relay_link_down(self, rid: int, gen: int,
                         reason: Optional[str] = None):
        """A relay link died (EOF at the mux, or the liveness sweep).
        Its whole subtree enters limbo — the leaves behind it may be
        perfectly healthy and re-home within the grace window; only
        grace expiry promotes them (through the existing elastic
        eviction path).  The limbo clock carries detection slack: a
        WEDGED relay is seen by the root before its leaves can see
        the silence themselves.  With reconnects off, the subtree is
        promoted immediately (legacy fail-fast)."""
        with self._lock:
            if self._relay_gen.get(rid, 0) != gen:
                return
            self._relay_gen[rid] = gen + 1  # supersede in-flight frames
            conn = self._relay_conns.pop(rid, None)
            self._relay_metrics.pop(rid, None)
            subtree = sorted(r for r, v in self._rank_via.items()
                             if v == rid)
            stopped = self._stop.is_set()
            limbo = not stopped and self.reconnect_grace_s > 0
            slack = self._subtree_slack()
            for r in subtree:
                self._rank_via.pop(r, None)
                self._via_epoch.pop(r, None)
                if limbo and r not in self._lost:
                    self._enter_limbo_locked(r)
                    self._limbo[r] = time.monotonic() + slack
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        if stopped:
            return
        if _fr.ENABLED:
            _fr.record(_fr.RELAY_DOWN, rank=0, role="coord",
                       relay=rid, reason=reason or "connection lost",
                       subtree=list(subtree), cyc=gen)
        if subtree:
            logger.warning(
                "relay %d link down (%s): %s", rid,
                reason or "connection lost",
                ("holding %d ranks in limbo for %.1fs grace"
                 % (len(subtree), self.reconnect_grace_s)) if limbo
                else "promoting %d ranks to lost" % len(subtree))
        if limbo:
            return
        for r in subtree:
            self._count_departed(r)
            self._promote_lost(r, clean=False,
                               reason=reason or "relay link lost")

    def _handle_relay_lost(self, rid: int, payload: bytes):
        """RL notice: a relay reports children lost.  kind="silent"
        means the child ITSELF went quiet past the per-hop deadline
        (the wedged-rank case — promote, like the root's own liveness
        on direct links); kind="disconnect" is a dead child socket —
        grace window first, the leaf may simply re-home.  Entries
        carry the child-connection epoch when the reporter was the
        leaf's direct parent; epoch-less entries mean the trouble was
        INTERIOR (a sub-relay under the reporter died or went silent —
        the leaves behind it may be perfectly healthy and will
        self-detect), so they only arm a suspicion clock with
        detection slack: a leaf whose re-home already raced ahead is
        never yanked back, and one that resumes within slack + grace
        is never promoted at all."""
        try:
            notice = json.loads(payload.decode())
            entries = [(int(r), None if e is None else int(e))
                       for r, e in notice.get("ranks", [])]
            kind = notice.get("kind", "disconnect")
            reason = notice.get("reason", "")
        except (ValueError, TypeError, UnicodeDecodeError):
            logger.warning("undecodable RL notice from relay %d", rid)
            return
        if _fr.ENABLED:
            _fr.record(_fr.RELAY_LOST, rank=0, role="coord", relay=rid,
                       lost_kind=kind, reason=reason,
                       ranks=[r for r, _ in entries])
        promote = []
        now = time.monotonic()
        with self._lock:
            for rank, epoch in entries:
                if rank in self._lost:
                    continue
                if self._rank_via.get(rank) != rid:
                    continue  # re-homed elsewhere already
                if epoch is not None and \
                        self._via_epoch.get(rank) != epoch:
                    continue  # stale notice about a superseded socket
                if epoch is None:
                    # Interior trouble: the reporter cannot prove
                    # which leaves are actually affected.  Don't
                    # detach — arm a suspicion deadline (detection
                    # slack + grace) keyed to the attachment
                    # generation; a resume bumps the generation and
                    # clears it.
                    self._via_suspect[rank] = \
                        (now + self._subtree_slack() +
                         self.reconnect_grace_s,
                         self._conn_gen.get(rank, 0))
                elif kind == "silent":
                    # The LEAF itself went quiet on its direct parent:
                    # the wedged-rank case, same verdict as the root's
                    # own liveness on a direct link.
                    self._rank_via.pop(rank, None)
                    self._via_epoch.pop(rank, None)
                    promote.append(rank)
                elif self.reconnect_grace_s > 0:
                    self._rank_via.pop(rank, None)
                    self._via_epoch.pop(rank, None)
                    self._enter_limbo_locked(rank)
                else:
                    self._rank_via.pop(rank, None)
                    self._via_epoch.pop(rank, None)
                    promote.append(rank)
        for rank in promote:
            self._count_departed(rank)
            self._promote_lost(
                rank, clean=False,
                reason="relay %d reported %s (%s)" % (rid, kind,
                                                      reason))

    def _handle_metrics_aggregate(self, rid: int, payload: bytes):
        try:
            agg = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            logger.warning("undecodable MA frame from relay %d", rid)
            return
        with self._lock:
            self._relay_metrics[rid] = {
                "ranks": [int(r) for r in agg.get("ranks", [])],
                "snapshot": agg.get("snapshot") or {}}

    def _mux_close(self, token: "_LinkToken"):
        if token.kind == "relay":
            self._relay_link_down(token.ident, token.gen)
        else:
            self._rank_link_down(token.ident, token.gen, token.clean,
                                 silent=False)

    def _try_resume(self, rank: int, sess: dict, conn: socket.socket):
        """Reconnect handshake: same session inside the grace window →
        replace the link, tell the worker how many of its uplink
        frames we processed (WE frame), and replay the downlink frames
        it missed.  Anything else is refused — the worker fails over
        to the broken-membership path."""
        with self._lock:
            recv_count = int(sess.get("recv_count", 0))
            out_seq = self._out_seq.get(rank, 0)
            log = self._out_log.get(rank)
            ok = (self.reconnect_grace_s > 0 and
                  rank not in self._lost and
                  sess.get("session") and
                  sess.get("session") == self._sessions.get(rank) and
                  log is not None and
                  0 <= recv_count <= out_seq and
                  out_seq - recv_count <= len(log))
            if not ok:
                logger.warning(
                    "refusing control-channel resume for rank %d "
                    "(session %s, recv_count %d/%d, grace %s)", rank,
                    (sess.get("session") or "?")[:8], recv_count,
                    out_seq, self.reconnect_grace_s)
                _RECONNECTS.inc(1, outcome="refused")
                if _fr.ENABLED:
                    _fr.record(_fr.RESUME, rank=0, role="coord",
                               peer=rank, outcome="refused",
                               seq=recv_count)
                try:
                    _send_frame(conn, _MAGIC_WELCOME,
                                json.dumps({"resume": False}).encode())
                    conn.close()
                except OSError:
                    pass
                return
            # Phase 1 (under the lock): supersede the old link — bump
            # the generation so the old rank loop discards anything it
            # has not fully processed, and close its socket.  The rank
            # stays OUT of _conns for now: broadcasts must keep
            # accumulating in the out-log until the backlog below has
            # been replayed, or the stream would reorder.  A prior
            # relay attachment is superseded the same way (re-home
            # from a dead relay to the root).
            old = self._conns.pop(rank, None)
            self._rank_via.pop(rank, None)
            self._via_epoch.pop(rank, None)
            self._via_suspect.pop(rank, None)
            self._conn_gen[rank] = gen = \
                self._conn_gen.get(rank, 0) + 1
            # Stay in limbo (fresh timestamp) until phase 3: limbo
            # membership is what keeps broadcasts flowing into the
            # out-log during the handshake window.
            self._limbo[rank] = time.monotonic()
            stream_lock = self._stream_locks.setdefault(
                rank, threading.Lock())
        if old is not None and old is not conn:
            try:
                old.close()
            except OSError:
                pass
        # Phase 2 (stream lock, no server lock): wait out a frame the
        # old rank loop may have in flight — once it finishes (and
        # counts) or gets discarded at its gen check (un-counted, so
        # the worker's replay re-delivers it), the uplink cursor is
        # stable and the handshake can quote it.
        with stream_lock:
            in_count = self._in_count.get(rank, 0)
        # Phase 3 (server lock again): install the new conn and send
        # WE + the missed backlog atomically w.r.t. new broadcasts.
        with self._lock:
            if self._conn_gen.get(rank, 0) != gen or \
                    rank in self._lost or \
                    self._out_seq.get(rank, 0) - recv_count > len(log):
                # Superseded by a newer resume, promoted to lost, or
                # the handshake window pushed the resume point out of
                # the replay ring — refuse; the worker fails over.
                logger.warning("control-channel resume for rank %d "
                               "aborted mid-handshake", rank)
                _RECONNECTS.inc(1, outcome="refused")
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._install_conn_locked(rank, conn)
            self._limbo.pop(rank, None)
            try:
                _send_frame(conn, _MAGIC_WELCOME, json.dumps({
                    "resume": True,
                    "recv_count": in_count,
                }).encode())
                for ordinal, magic, payload in log:
                    if ordinal > recv_count:
                        _send_frame(conn, magic, payload)
            except OSError:
                # The fresh link died mid-handshake: back to limbo;
                # the worker will retry within the grace window.
                self._enter_limbo_locked(rank)
                return
            gen = self._conn_gen[rank]
        logger.info("rank %d control channel resumed (replayed %d "
                    "downlink frames)", rank, out_seq - recv_count)
        _RECONNECTS.inc(1, outcome="resumed")
        if _fr.ENABLED:
            _fr.record(_fr.RESUME, rank=0, role="coord", peer=rank,
                       outcome="resumed", cyc=gen,
                       replayed=out_seq - recv_count)
        self._serve_link(rank, conn, gen)

    def _spawn_rank_loop(self, rank: int, conn: socket.socket,
                         gen: Optional[int] = None):
        if gen is None:
            gen = self._conn_gen.get(rank, 0)
        t = threading.Thread(target=self._rank_loop,
                             args=(rank, conn, gen),
                             name=f"hvd-coord-rank{rank}", daemon=True)
        t.start()
        self._threads.append(t)

    def _sweep_period(self) -> float:
        base = self.liveness_interval_s / 2.0 if \
            self.liveness_interval_s > 0 else self.reconnect_grace_s / 4.0
        return max(min(base, 1.0), 0.05)

    def _rank_loop(self, rank: int, conn: socket.socket, gen: int = 0):
        clean = False
        silent = False

        def on_idle():
            # Poll-timeout expiry on the registered link: give up once
            # the peer has been silent past the liveness deadline (a
            # wedged rank holds its socket open — only the HB cadence
            # can expose it).
            if self._stop.is_set() or \
                    self._conn_gen.get(rank, 0) != gen:
                raise _LinkSilent("superseded")
            if time.monotonic() - self._last_heard.get(rank, 0.0) \
                    > self.liveness_timeout_s:
                raise _LinkSilent(
                    "rank %d silent for > %.1fs" %
                    (rank, self.liveness_timeout_s))

        def on_data():
            self._last_heard[rank] = time.monotonic()

        bounded = self.liveness_interval_s > 0
        try:
            while not self._stop.is_set():
                try:
                    if bounded:
                        frame = _recv_frame_bounded(conn, on_idle,
                                                    on_data)
                    else:
                        frame = _recv_frame(conn)
                except OSError:
                    frame = None
                except _LinkSilent as e:
                    if str(e) != "superseded":
                        logger.warning("liveness: %s; promoting to "
                                       "lost", e)
                        silent = True
                    return
                if frame is None:
                    return
                magic, payload = frame
                self._last_heard[rank] = time.monotonic()
                if magic in _OOS_UP:
                    # Out-of-stream: HB is a pure liveness signal, MR
                    # an absolute snapshot — neither enters the stream
                    # cursor (symmetric with the worker's up-log).
                    _FRAMES_RECV.inc(1, kind=magic.decode(
                        "ascii", "replace"))
                    if _fr.ENABLED and magic == _MAGIC_HB:
                        _fr.record(_fr.HB_RX, rank=0, role="coord",
                                   peer=rank)
                    if magic == _MAGIC_METRICS_REP:
                        self._handle_metrics_snapshot(rank, payload)
                    continue
                self.uplink_frames += 1
                if _fr.ENABLED:
                    _fr.record(_fr.FRAME_RX, rank=0, role="coord",
                               peer=rank,
                               frame=magic.decode("ascii", "replace"),
                               nbytes=len(payload),
                               seq=self._in_count.get(rank, 0) + 1,
                               cyc=gen)
                # Failpoint site: uplink frame arrival on the
                # coordinator.  drop() discards the frame (the sender's
                # tensor goes incomplete — the stall machinery must
                # attribute and fail it); error() kills this rank loop,
                # which the coordinator treats as the rank departing.
                if _fp.ENABLED and \
                        _fp.maybe_fail("coord.frame_recv",
                                       rank=rank) == "drop":
                    # An injected drop still counts as processed (the
                    # frame was lost, not deferred) — under the stream
                    # lock like the real handling below.
                    lock = self._stream_locks.get(rank)
                    if lock is not None:
                        with lock:
                            if self._conn_gen.get(rank, 0) != gen:
                                return
                            self._in_count[rank] = \
                                self._in_count.get(rank, 0) + 1
                    continue
                _FRAMES_RECV.inc(1, kind=magic.decode("ascii",
                                                      "replace"))
                _BYTES_RECV.inc(len(payload) + 6)
                # Frame handling + the stream-cursor advance are one
                # atomic unit under the per-rank stream lock: the
                # resume handshake takes the same lock to quote a
                # stable _in_count, and the generation check makes a
                # superseded loop DISCARD its in-hand frame un-counted
                # (the worker's uplink replay re-delivers it) — a
                # frame is processed exactly once, by exactly one
                # link generation.
                stream_lock = self._stream_locks.get(rank)
                if stream_lock is None:
                    return
                with stream_lock:
                    if self._conn_gen.get(rank, 0) != gen:
                        return  # superseded mid-stream
                    try:
                        if magic == _MAGIC_HITS:
                            self._handle_cache_hits(
                                rank, unpack_bits(payload))
                            continue
                        requests, shutdown = \
                            unpack_request_list(payload)
                        if shutdown:
                            clean = True
                            return
                        self._handle_requests(rank, requests)
                    finally:
                        # Stream cursor for the reconnect handshake:
                        # a frame counts once fully handled, so a
                        # resume replays exactly the unprocessed tail.
                        self._in_count[rank] = \
                            self._in_count.get(rank, 0) + 1
        finally:
            self._rank_link_down(rank, gen, clean, silent)

    def _rank_link_down(self, rank: int, gen: int, clean: bool,
                        silent: bool):
        """A rank loop exited.  Decide: superseded link (ignore), clean
        departure, transient disconnect (limbo + grace window), or
        final loss."""
        with self._lock:
            if self._conn_gen.get(rank, 0) != gen:
                return  # a resumed link took over; nothing departed
            stopped = self._stop.is_set()
            limbo = (not stopped and not clean and not silent and
                     rank not in self._lost and
                     self.reconnect_grace_s > 0)
            if limbo:
                # Socket death with reconnects enabled: hold the rank
                # in limbo — a transient TCP drop comes back within
                # the grace window and nobody else ever knows.  Its
                # departure is deferred to resume-or-expire.
                self._enter_limbo_locked(rank)
        if limbo:
            return
        self._count_departed(rank)
        if not stopped:
            self._promote_lost(rank, clean,
                               reason="liveness timeout" if silent
                               else None)

    def _promote_lost(self, rank: int, clean: bool,
                      reason: Optional[str] = None) -> bool:
        """Final, idempotent rank-loss transition: every detector
        (rank-loop exit, liveness sweep, grace expiry) funnels here;
        only the first caller runs the broken-membership machinery."""
        with self._lock:
            if rank in self._lost:
                return False
            self._lost.add(rank)
            self._limbo.pop(rank, None)
            self._rank_via.pop(rank, None)
            self._via_epoch.pop(rank, None)
            self._via_suspect.pop(rank, None)
            conn = self._conns.get(rank)
        if reason == "liveness timeout":
            _LIVENESS_TIMEOUTS.inc(1, role="coordinator")
        if conn is not None:
            try:
                conn.close()  # unblocks a rank loop stuck in recv
            except OSError:
                pass
        if _fr.ENABLED:
            _fr.record(_fr.PROMOTE, rank=0, role="coord", peer=rank,
                       clean=clean, reason=reason or "connection lost")
        self._on_rank_lost(rank, clean, reason)
        if _fr.ENABLED and not clean:
            # Dump AFTER the dead-rank notice fan-out: the ring keeps
            # recording, so deferring costs no evidence, while a file
            # write before _on_rank_lost would sit inside the very
            # detect window the MTTR drills bound.
            _fr.trigger_dump("promotion")
        return True

    def _count_departed(self, rank: int):
        """At most ONE departure per rank life: several detectors can
        observe the same death (rank-loop exit, grace expiry after a
        send-failure limbo, the sweep) and an over-count would let the
        drain tear the coordinator down under still-attached ranks."""
        with self._departed_cond:
            if rank in self._departure_counted:
                return
            self._departure_counted.add(rank)
            self._departed += 1
            self._departed_cond.notify_all()

    def _enter_limbo_locked(self, rank: int):
        if rank in self._limbo or rank in self._lost:
            return
        self._conns.pop(rank, None)
        self._limbo[rank] = time.monotonic()
        if _fr.ENABLED:
            _fr.record(_fr.LIMBO, rank=0, role="coord", peer=rank,
                       grace_s=self.reconnect_grace_s)
        logger.info("rank %d control link dropped; holding in limbo "
                    "for %.1fs grace", rank, self.reconnect_grace_s)

    # ------------------------------------------------------------------
    # liveness sweep
    # ------------------------------------------------------------------
    def _link_deadline_locked(self, key):
        """Current true liveness deadline for a heap key — a direct
        rank (int) or a relay link (("relay", rid) — depth-aware, so a
        deep subtree's forwarding latency never false-promotes it).
        None = the link is no longer tracked (caller holds
        self._lock)."""
        heard = self._last_heard.get(key)
        if heard is None:
            return None
        if isinstance(key, tuple):
            rid = key[1]
            if rid not in self._relay_conns:
                return None
            return heard + env_mod.depth_aware_liveness_timeout(
                self.liveness_timeout_s, self._relay_depth.get(rid, 1))
        if key not in self._conns:
            return None  # relay-attached ranks are watched per hop
        return heard + self.liveness_timeout_s

    def _liveness_loop(self):
        """Coordinator half of bounded-time liveness: broadcast HB
        when the downlink has been idle (so workers can bound their
        own recv waits), promote silent ranks and expired limbo ranks
        to lost, and bound the formation wait by the start timeout.
        The silent scan rides the lazy deadline heap — each tick
        visits only links whose recorded deadline lapsed, O(due)
        instead of O(world) per interval."""
        period = self._sweep_period()
        hb_armed = self.liveness_interval_s > 0
        while not self._stop.wait(period):
            now = time.monotonic()
            with self._lock:
                silent = []
                silent_relays = []
                if hb_armed:
                    if now - self._last_broadcast_t >= \
                            self.liveness_interval_s:
                        self._broadcast_frame_locked(_MAGIC_HB, b"")
                        _HEARTBEATS.inc(1, role="coordinator")
                    for key in self._lheap.due(
                            now, self._link_deadline_locked):
                        if isinstance(key, tuple):
                            silent_relays.append(
                                (key[1],
                                 self._relay_gen.get(key[1], 0)))
                        else:
                            silent.append(key)
                expired = [r for r, t in self._limbo.items()
                           if now - t > self.reconnect_grace_s]
                # Suspicion clocks (interior relay trouble reported
                # without per-socket proof): a resume bumps the
                # attachment generation and clears the suspicion;
                # deadline expiry without one promotes.
                suspect_expired = []
                for r, (deadline, gen) in \
                        list(self._via_suspect.items()):
                    if self._conn_gen.get(r, 0) != gen:
                        self._via_suspect.pop(r, None)
                    elif now > deadline:
                        self._via_suspect.pop(r, None)
                        self._rank_via.pop(r, None)
                        self._via_epoch.pop(r, None)
                        suspect_expired.append(r)
            for rid, gen in silent_relays:
                self._relay_link_down(rid, gen,
                                      reason="liveness timeout")
            for rank in suspect_expired:
                if self._promote_lost(rank, clean=False,
                                      reason="subtree suspicion "
                                             "expired"):
                    self._count_departed(rank)
            for rank in silent:
                if self._promote_lost(rank, clean=False,
                                      reason="liveness timeout"):
                    logger.warning(
                        "liveness: rank %d silent for > %.1fs; "
                        "promoted to lost", rank,
                        self.liveness_timeout_s)
            for rank in expired:
                if self._promote_lost(rank, clean=False,
                                      reason="reconnect grace "
                                             "expired"):
                    logger.warning(
                        "rank %d did not reconnect within the %.1fs "
                        "grace window; promoted to lost", rank,
                        self.reconnect_grace_s)
                    _RECONNECTS.inc(1, outcome="expired")
                    # Usually its rank loop already exited into limbo
                    # without counting a departure; when limbo was
                    # entered from a send failure the loop is still
                    # alive and will try to count again — the per-rank
                    # dedup makes either order count exactly once.
                    self._count_departed(rank)
            # Formation deadline: pre-formation there may be no stall
            # machinery armed at all — bound the wait for stragglers
            # by the start timeout so a job missing a rank fails
            # crisply instead of hanging.
            if not self._formed and \
                    now - self._started_at > env_mod.start_timeout():
                self._fail_formation_locked_entry()

    def _fail_formation_locked_entry(self):
        with self._lock:
            if self._formed:
                return
            missing = sorted(set(range(self.size)) -
                             self._attached_ranks_locked())
            # Log once even with nothing buffered: an idle formation
            # hang past the deadline must leave a trace (the sweep
            # re-evaluates every period).
            if ("__formation_deadline__",) not in self._stall_logged:
                self._stall_logged[("__formation_deadline__",)] = 1.0
                logger.error(
                    "formation deadline: ranks %s never connected "
                    "within the %.0fs start timeout", missing,
                    env_mod.start_timeout())
            pre, self._pre_formed = self._pre_formed, []
            errs = [Response(
                response_type=ResponseType.ERROR,
                tensor_names=[req.tensor_name],
                process_set_id=req.process_set_id,
                error_message=(
                    "ranks %s never connected within the %.0fs start "
                    "timeout" % (missing, env_mod.start_timeout())))
                for kind, _, payload in pre if kind == "rq"
                for req in payload]
            if errs:
                self._broadcast_locked(errs)

    def departure_counts(self):
        """(ever_connected, departed) rank-connection counters."""
        with self._departed_cond:
            return self._seen, self._departed

    # ------------------------------------------------------------------
    # cross-rank metrics aggregation
    # ------------------------------------------------------------------
    def _metrics_loop(self):
        while not self._stop.wait(self._metrics_interval_s):
            self.request_metrics()

    def request_metrics(self):
        """Broadcast one MQ poll; every worker (including rank 0's
        loopback client) answers with an MR snapshot frame."""
        with self._lock:
            self._broadcast_frame_locked(_MAGIC_METRICS_REQ, b"")

    def _handle_metrics_snapshot(self, rank: int, payload: bytes):
        try:
            snap = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            logger.warning("undecodable metrics snapshot from rank %d",
                           rank)
            return
        with self._lock:
            self._rank_metrics[rank] = snap

    def merged_metrics(self) -> Optional[dict]:
        """Sum of the latest per-rank snapshots (None until the first
        MR/MA frame lands).  ``ranks`` names the contributors, so a
        scraper can tell a partial merge from a full one.  In tree
        mode, relays pre-aggregate their subtree's MR replies into one
        MA frame each, so this merge is O(fanout) snapshots at the
        root instead of O(world)."""
        with self._lock:
            snaps = dict(self._rank_metrics)
            aggs = dict(self._relay_metrics)
        if not snaps and not aggs:
            return None
        parts = [snaps[r] for r in sorted(snaps)]
        ranks = set(snaps)
        for rid in sorted(aggs):
            parts.append(aggs[rid].get("snapshot") or {})
            ranks.update(aggs[rid].get("ranks", []))
        # Known transient: for up to one poll interval after a leaf
        # re-homes from a live relay to a direct root link, its
        # contribution may appear both in the relay's last MA
        # aggregate and as a fresh direct MR (aggregates are merged
        # sums — a single rank cannot be subtracted out).  The next
        # MQ poll re-converges; the reverse transition is cleaned
        # eagerly in the remote attach paths.
        merged = metrics.merge_snapshots(parts)
        merged["ranks"] = sorted(ranks)
        return merged

    # ------------------------------------------------------------------
    # live straggler observatory (common/straggler.py)
    # ------------------------------------------------------------------
    _STRAGGLER_REFRESH_S = 0.5

    def _straggler_loop(self):
        """Fold the MR/MA-carried per-rank phase summaries into the
        scorer and refresh scores/flags.  Runs at a fixed small
        cadence — the work is O(world) dict math, and the refresh must
        keep going during steady-state replay, when no negotiation
        arrival ever lands.  When the metrics-aggregation loop is NOT
        armed, this loop issues the MQ polls itself (every other
        tick): the observatory is self-sufficient, not parasitic on
        HOROVOD_METRICS_AGG_SECONDS."""
        sg = self._straggler
        tick = 0
        while not self._stop.wait(self._STRAGGLER_REFRESH_S):
            tick += 1
            if self._metrics_interval_s <= 0 and tick % 2 == 0:
                self.request_metrics()
            with self._lock:
                # Snapshot dicts are replaced wholesale on update
                # (never mutated in place), so holding references
                # outside the lock is safe.
                aggs = [a.get("snapshot") or {}
                        for a in self._relay_metrics.values()]
                snaps = list(self._rank_metrics.values())
            per_rank = {}
            for snap in aggs:        # relay aggregates first ...
                per_rank.update(_sg.phases_from_snapshot(snap))
            for snap in snaps:       # ... direct MR replies overlay
                per_rank.update(_sg.phases_from_snapshot(snap))
            if per_rank:
                # hvdlint: hot-ok(cold loop thread; it exists only
                # when the scorer does)
                sg.note_worker_phases(per_rank)
            sg.refresh()

    def straggler_top(self):
        """(rank, score) of the top rank currently FLAGGED slow —
        i.e. past the threshold/hysteresis gate — or None (also None
        when the observatory is disarmed).  The stall machinery
        consumes a slow-vs-dead VERDICT here, not a raw score: a
        sub-threshold residual EWMA must never steer an operator away
        from the wedged-rank diagnosis.  Raw scores stay visible in
        /status."""
        sg = self._straggler
        if sg is None:
            return None
        top = sg.top()
        if top is None or top[0] not in sg.flagged():
            return None
        return top

    def profile_digests(self) -> Dict[int, List[dict]]:
        """Per-rank top-K hot-frame digests recovered from the latest
        MR/MA snapshots (common/profiler.py rank-labeled gauges) —
        computed on demand from already-held state, cold paths only
        (/status, stall warnings, drill verdicts).  Empty when no rank
        runs with HOROVOD_PROFILE=1."""
        with self._lock:
            aggs = [a.get("snapshot") or {}
                    for a in self._relay_metrics.values()]
            snaps = list(self._rank_metrics.values())
        out: Dict[int, List[dict]] = {}
        for snap in aggs:        # relay aggregates first ...
            out.update(_prof.digest_from_snapshot(snap))
        for snap in snaps:       # ... direct MR replies overlay
            out.update(_prof.digest_from_snapshot(snap))
        return out

    def profile_root_cause(self, rank: int) -> Optional[str]:
        """One root-cause clause for ``rank`` ("failpoints:maybe_fail
        (submit lane, 72% of samples)") from its digest, or None when
        no digest has arrived — the stall inspector and the drill
        verdict attach this to their warning text."""
        text = _prof.describe_digest(self.profile_digests().get(rank))
        return text or None

    def slo_readings(self) -> Dict[int, dict]:
        """Per-rank SLO SLI/burn readings recovered from the latest
        MR/MA snapshots (common/slo.py rank-labeled gauges)."""
        with self._lock:
            aggs = [a.get("snapshot") or {}
                    for a in self._relay_metrics.values()]
            snaps = list(self._rank_metrics.values())
        out: Dict[int, dict] = {}
        for snap in aggs:
            out.update(_slo.slo_from_snapshot(snap))
        for snap in snaps:
            out.update(_slo.slo_from_snapshot(snap))
        return out

    def status(self) -> dict:
        """The /status plane's cluster view (JSON-ready): per-rank
        liveness + straggler state, negotiation counters, and queue
        shape — the live "which rank is slow RIGHT NOW" answer next
        to the post-hoc /metrics and /blackbox planes."""
        now = time.monotonic()
        with self._lock:
            ranks = {}
            for r in range(self.size):
                if r in self._lost:
                    st = "lost"
                elif r in self._limbo:
                    st = "limbo"
                elif r in self._conns or r in self._rank_via:
                    st = "alive"
                    heard = self._last_heard.get(r)
                    if self.liveness_interval_s > 0 and \
                            heard is not None and \
                            now - heard > self.liveness_timeout_s:
                        # Connected but silent past the deadline: the
                        # SIGSTOP/GIL-deadlock shape, pre-promotion.
                        st = "wedged"
                else:
                    st = "unknown"
                d = {"state": st}
                heard = self._last_heard.get(r)
                if heard is not None:
                    d["last_heard_age_s"] = round(now - heard, 3)
                rid = self._rank_via.get(r)
                if rid is not None:
                    d["via_relay"] = rid
                ranks[str(r)] = d
            out = {
                "size": self.size,
                "formed": self._formed,
                "broken": self._broken,
                "pending_tensors": len(self._table.entries),
                "pending_barriers": len(self._barriers),
                "negotiation": dict(self.stats),
            }
        sg = self._straggler
        if sg is not None:
            snap = sg.snapshot()
            out["straggler"] = snap
            for r_s, d in ranks.items():
                score = snap["scores"].get(r_s)
                if score is not None:
                    d["score"] = score
                    d["slow"] = int(r_s) in snap["flagged"]
        digests = self.profile_digests()
        if digests:
            # Why-is-it-slow: per-rank digests (k-ordered) plus a
            # one-line hot_frame on each rank row so hvdtop can show
            # the dominant frame without a second request.
            out["profile"] = {str(r): entries
                              for r, entries in digests.items()}
            for r_s, d in ranks.items():
                entries = digests.get(int(r_s))
                if entries:
                    d["hot_frame"] = "%s [%s]" % (
                        entries[0]["frame"], entries[0]["lane"])
        slo_map = self.slo_readings()
        if slo_map:
            out["slo"] = {str(r): v for r, v in slo_map.items()}
        out["ranks"] = ranks
        return out

    def _on_rank_lost(self, rank: int, clean: bool,
                      reason: Optional[str] = None):
        """A rank departed mid-run.  In elastic mode, pending
        negotiations can never complete: fail them on every surviving
        rank so blocked synchronize() calls raise HorovodInternalError
        and unwind to the elastic retry loop (the analog of the
        reference's collective errors on peer failure,
        common/exceptions.py:18 semantics)."""
        if self._on_rank_lost_hook is not None:
            # Out-of-band notification (rank 0 publishes it to the
            # elastic rendezvous KV so the driver can evict the host
            # of a wedged-but-alive worker process).
            try:
                self._on_rank_lost_hook(rank, clean, reason)
            except Exception:
                logger.warning("rank-lost hook failed", exc_info=True)
        if self._straggler is not None:
            # Same eviction contract as the metrics snapshot below: a
            # lost rank's frozen lag/wait EWMAs (and slow flag) must
            # stop contributing, or it could read as "top straggler"
            # forever — the dead-as-slow misdiagnosis.
            self._straggler.drop_rank(rank)
        with self._lock:
            # A departed rank must stop contributing to the merged
            # metrics view: its frozen last snapshot would otherwise be
            # summed into every future merge, and the ``ranks``
            # contributor list would keep advertising a dead process.
            self._rank_metrics.pop(rank, None)
            if self.tune_session is not None and \
                    self.tune_session.active:
                # A rank died MID-SEARCH: abort to default knobs in
                # one atomic PA — a proposal half-applied across the
                # surviving ranks would poison the post-recovery
                # world's same-schedule contract.  Survivors (elastic)
                # or the teardown path (static) all see the same final
                # default-knob payload.
                self.tune_session.abort("rank_lost")
                self._drain_tune_locked()
        if not self.elastic:
            return
        with self._lock:
            self._conns.pop(rank, None)
            self._broken = True
            # Keys are (psid, name); the ERROR responses must carry
            # BOTH — workers pop their tensor-table entries by
            # (name, psid), so an error missing the psid never reaches
            # a non-global set's blocked submitter.  Pre-formation
            # buffered requests fail too: their submitters are blocked
            # just the same.
            pending = list(self._table.entries.keys()) + \
                list(self._barriers.keys()) + \
                [(req.process_set_id, req.tensor_name)
                 for kind, _, payload in self._pre_formed
                 if kind == "rq" for req in payload]
            self._pre_formed.clear()
            self._table.entries.clear()
            self._barriers.clear()
            self._barrier_members.clear()
            self._first_seen.clear()
            self._bit_only.clear()
            if self._straggler is not None:
                # Every in-flight negotiation just failed: its partial
                # arrival sets are not lag samples.
                self._straggler.reset_pending()
            msg = (f"rank {rank} left the job "
                   f"({'clean' if clean else reason or 'connection lost'}); "
                   "membership changed")
            logger.info("elastic coordinator: %s", msg)
            responses = [Response(
                response_type=ResponseType.ERROR, tensor_names=[name],
                process_set_id=psid,
                error_message=msg) for psid, name in pending]
            if responses:
                self._broadcast_locked(responses)
            # Abort broadcast: a worker with NO pending eager
            # negotiation (e.g. blocked inside a TF in-graph
            # collective, or compute-bound) must still learn the
            # membership broke NOW — while this coordinator is alive —
            # so it can unwind and disconnect its jax client before
            # rank 0 takes the coordination service down (leader loss
            # under an attached client is process-fatal).
            self._broadcast_frame_locked(_MAGIC_ABORT, msg.encode())

    def _broadcast_locked(self, responses: List[Response]):
        self._broadcast_frame_locked(_MAGIC_RESP,
                                     pack_response_list(responses))

    @staticmethod
    def _required_for(req: Request) -> int:
        return len(req.process_set_ranks) if req.process_set_ranks else 0

    def _joined_count_for(self, req: Request) -> int:
        if req.process_set_ranks:
            return len(self._joined & set(req.process_set_ranks))
        return len(self._joined)

    def _scan_complete(self) -> List[Tuple[str, List[Request]]]:
        """Re-scan the message table for tensors completed by a rank
        joining (the reference fires pending tensors when join
        participation changes, controller.cc:254-308)."""
        ready: List[Tuple[tuple, List[Request]]] = []
        for key in list(self._table.entries.keys()):
            msgs = self._table.entries[key]
            if not msgs:
                continue
            required = self._required_for(msgs[0]) or self.size
            if len(msgs) + self._joined_count_for(msgs[0]) >= required:
                self._table.pop(key)
                self._first_seen.pop(key, None)
                ready.append((key, msgs))
        return ready

    def _handle_requests(self, rank: int, requests: List[Request]):
        with self._lock:
            # _broken outranks the formation gate: after an elastic
            # rank loss during formation the gate can never open, and
            # buffering would hide the failure from the submitter
            # forever — _process's broken branch errors it instead.
            if not self._formed and not self._broken:
                self._pre_formed.append(("rq", rank, requests))
                return
            self._dispatch_uplink_locked("rq", rank, requests)

    def _handle_cache_hits(self, rank: int, bits: List[int]):
        """Fast-path uplink: each bit is a full request the worker
        elided because its cached signature still matches (reference:
        CacheCoordinator::sync)."""
        with self._lock:
            if not self._formed and not self._broken:
                # Unreachable with a fresh cache (no bit precedes the
                # first RS, which the gate itself blocks) — buffered
                # for defense in depth.
                self._pre_formed.append(("ch", rank, bits))
                return
            self._dispatch_uplink_locked("ch", rank, bits)

    def _dispatch_uplink_locked(self, kind: str, rank: int, payload):
        """Route one uplink frame ("rq" request list / "ch" bit list)
        into _process; shared by the live path and the formation-gate
        drain (caller holds self._lock)."""
        if kind == "rq":
            items = [(req, False) for req in payload]
        else:
            items = self._resolve_hits(rank, payload)
        if items:
            self._process(rank, items)

    def _resolve_hits(self, rank: int, bits: List[int]
                      ) -> List[Tuple[Request, bool]]:
        """Resolve CH bits into requests (caller holds self._lock)."""
        items: List[Tuple[Request, bool]] = []
        for bit in bits:
            resolved = self._cache.resolve_bit(bit)
            if resolved is None:
                # Only possible if >TOMBSTONE_CAP evictions raced one
                # in-flight frame — effectively unreachable; the
                # sender's tensor would hang, so fail loudly.
                logger.error(
                    "unresolvable cache bit %d from rank %d; "
                    "protocol desync", bit, rank)
                self._broadcast_locked([Response(
                    response_type=ResponseType.ERROR,
                    tensor_names=[f"__cache_bit_{bit}"],
                    error_message="response-cache protocol desync")])
                continue
            live, key, sig, sizes, gid = resolved
            name = key[1]  # cache keys are (psid, name)
            first_dim = None
            if sig[7] == int(RequestType.ALLGATHER) and sizes:
                # tensor_sizes are in GROUP order: index by the
                # rank's position in the process set when one is
                # given; a rank outside the set gets NO override
                # (mirrors the native coordinator).
                psr = sig[8]
                if psr:
                    idx = psr.index(rank) if rank in psr else -1
                else:
                    idx = rank
                if 0 <= idx < len(sizes):
                    first_dim = sizes[idx]
            req = signature_to_request(sig, rank, name, first_dim)
            req.group_id = gid
            # A tombstoned bit still counts as a contribution, but
            # forces the full (renegotiation) path.
            items.append((req, live))
        return items

    def _process(self, rank: int, items: List[Tuple[Request, bool]]):
        """Accumulate; fire fused broadcasts with everything that became
        ready (single-threaded per coordinator via the lock: ordering of
        broadcast frames is the global execution order).  Caller holds
        self._lock."""
        if self._broken:
            # Membership already changed this epoch: every new
            # request fails fast so submitters unwind promptly.
            self._broadcast_locked([Response(
                response_type=ResponseType.ERROR,
                tensor_names=[req.tensor_name],
                process_set_id=req.process_set_id,
                error_message="membership changed; collective "
                              "cannot complete")
                for req, _ in items])
            return
        # Every per-tensor dict below is keyed by (process_set_id,
        # name): the same name may be live on two process sets at once
        # (reference analog: per-set controllers in process_set.h).
        # Straggler attribution rides the arrival order this loop
        # already observes (and used to discard): one timestamp per
        # uplink frame is plenty — cross-rank order is what matters,
        # intra-frame order is meaningless.
        sg = self._straggler
        sg_now = time.monotonic() if sg is not None else 0.0
        ready: List[Tuple[tuple, Optional[List[Request]], Optional[Response]]] = []
        for req, from_cache in items:
            name = req.tensor_name
            key = MessageTable.key(req)
            n = 1
            for d in req.tensor_shape:
                n *= d
            self._elem_cache[key] = n
            self._group_ids[key] = req.group_id
            if req.request_type == RequestType.JOIN:
                self._joined.add(rank)
                self._last_joined = rank
                if len(self._joined) == self.size:
                    ready.append((key, None, Response(
                        response_type=ResponseType.JOIN,
                        tensor_names=["join"],
                        last_joined_rank=self._last_joined)))
                    self._joined.clear()
                else:
                    # Tensors waiting only on the joined rank are
                    # now complete (zeros substituted).  Force the
                    # full-negotiation path: a cached response would
                    # carry the joined rank's old contribution (e.g.
                    # nonzero allgather row counts) whereas
                    # construct_response records zeros for it.
                    for ckey, msgs in self._scan_complete():
                        self._bit_only[ckey] = False
                        if sg is not None:
                            # Join-forced completion: the arrival set
                            # is missing the joined rank — not a fair
                            # lag sample.  Drop, don't attribute.
                            sg.note_abandon(ckey)
                        ready.append((ckey, msgs, None))
                continue
            if req.request_type == RequestType.BARRIER:
                required = self._required_for(req) or self.size
                arrived = self._barriers.setdefault(key, set())
                arrived.add(rank)
                # Barriers live outside the message table, so they need
                # their own stall clock: a rank dying at a barrier must
                # surface through attribution + shutdown like any other
                # collective, not hang the arrived ranks forever.
                self._first_seen.setdefault(key, time.monotonic())
                self._barrier_members[key] = req.process_set_ranks
                if len(arrived) >= required:
                    del self._barriers[key]
                    self._barrier_members.pop(key, None)
                    self._first_seen.pop(key, None)
                    ready.append((key, None, Response(
                        response_type=ResponseType.BARRIER,
                        tensor_names=[name],
                        process_set_id=req.process_set_id,
                        process_set_ranks=req.process_set_ranks)))
                continue
            if not from_cache:
                self._bit_only[key] = False
                if self._cache.has(key):
                    # Signature changed on some rank (or it evicted
                    # locally): renegotiate from scratch so the cached
                    # response can never serve a stale shape/dtype
                    # (reference: INVALID → eviction,
                    # response_cache.cc:49-87).
                    bit = self._cache.evict_name(key)
                    if bit is not None:
                        self._pending_evictions.append(bit)
            else:
                self._bit_only.setdefault(key, True)
            required = self._required_for(req) or self.size
            self._first_seen.setdefault(key, time.monotonic())
            if sg is not None:
                sg.note_arrival(key, rank, sg_now)
            complete = self._table.increment(
                req, required,
                joined_count=self._joined_count_for(req))
            if self.timeline:
                self.timeline.negotiate_rank_ready(name, rank)
            if complete:
                msgs = self._table.pop(key)
                self._first_seen.pop(key, None)
                if sg is not None:
                    sg.note_complete(key)
                ready.append((key, msgs, None))
        if not ready:
            self._flush_evictions_locked()
            return

        # Partition completed tensors: pure-bit rounds ride the compact
        # CB frame; anything else is (re)negotiated and re-cached.  A
        # grouped submission must not straddle the two frames (group
        # atomicity): if any member renegotiates, every member of that
        # group is demoted to the full path this round.
        full_groups: Set[int] = set()
        for key, msgs, direct in ready:
            if direct is None and not (
                    self._bit_only.get(key, False) and
                    self._cache.has(key)):
                gid = self._group_ids.get(key, -1)
                if gid >= 0:
                    full_groups.add(gid)
        hit_responses: List[Response] = []
        full_responses: List[Response] = []
        sig_by_key: Dict[tuple, tuple] = {}
        for key, msgs, direct in ready:
            if direct is not None:
                full_responses.append(direct)
                continue
            bit_only = self._bit_only.pop(key, False)
            self._stall_logged.pop(key, None)
            ent = self._cache.get(key)
            # While any rank is joined, cached responses are stale for
            # it (renegotiation substitutes zeros for joined ranks) —
            # bypass the fast path entirely.
            if bit_only and ent is not None and not self._joined and \
                    self._group_ids.get(key, -1) not in full_groups:
                hit_responses.append(ent[1])
                self.stats["fast_tensors"] += 1
                _COORD_TENSORS.inc(1, path="fast")
                continue
            resp = construct_response(msgs[0].tensor_name, msgs,
                                      self.size, self._joined)
            sig_by_key[key] = request_signature(msgs[0])
            full_responses.append(resp)
            self.stats["negotiated_tensors"] += 1
            _COORD_TENSORS.inc(1, path="negotiated")
            self._cache.clear_tombstones_for(key)

        nbytes = 0
        sess = self.tune_session
        # Cycle-class of this round: any ALLTOALL response makes it
        # sparse (the DLRM embedding exchange — per-step splits, never
        # cacheable, so alltoall can only appear among the negotiated
        # responses); everything else is dense.  The tuning session
        # scores and searches the two classes independently, and the
        # fusion threshold each fuse below uses is the CLASS's live
        # proposal (hit batches are cacheable-only, hence dense).
        sparse_round = any(
            r.response_type == ResponseType.ALLTOALL
            for r in full_responses)
        if hit_responses:
            fused_hits = fuse_responses(
                hit_responses, self._elem_cache,
                sess.fusion_threshold_for(False) if sess is not None
                else self.fusion_threshold,
                self._group_ids)
            batches = [[self._cache.get((fr.process_set_id, n))[0]
                        for n in fr.tensor_names]
                       for fr in fused_hits]
            payload = pack_bit_batches(batches)
            self._broadcast_frame_locked(_MAGIC_CACHE, payload)
            self.stats["fast_rounds"] += 1
            _ROUNDS.inc(1, kind="fast")
            nbytes += sum(self._elem_cache.get((fr.process_set_id, n),
                                               0) *
                          dtype_size(fr.tensor_type)
                          for fr in fused_hits for n in fr.tensor_names)
        if full_responses:
            fused = fuse_responses(full_responses, self._elem_cache,
                                   sess.fusion_threshold_for(sparse_round)
                                   if sess is not None
                                   else self.fusion_threshold,
                                   self._group_ids)
            if self._cache.enabled:
                self._assign_cache_bits(fused, sig_by_key)
            self._flush_evictions_locked()
            self._broadcast_locked(fused)
            self.stats["full_rounds"] += 1
            _ROUNDS.inc(1, kind="full")
            nbytes += sum(self._elem_cache.get((fr.process_set_id, n),
                                               0) *
                          dtype_size(fr.tensor_type)
                          for fr in fused for n in fr.tensor_names)
        else:
            self._flush_evictions_locked()
        if sess is not None:
            sess.observe_round(nbytes, sparse=sparse_round)
            self._drain_tune_locked()
        if self.param_manager is not None:
            if self.param_manager.active:
                self.param_manager.record_step(nbytes)
                self.fusion_threshold = \
                    self.param_manager.fusion_threshold_bytes
            if self.param_manager.params_version != \
                    self._synced_params_version:
                self._sync_tuned_params_locked()

    def _drain_tune_locked(self):
        """Broadcast any queued tuning announcement (knob proposal,
        freeze, abort) as a PA frame under the server lock, and keep
        it as the registration-replay payload so late joiners and
        resumed sessions see the current knob state.  Broadcasting
        under the lock positions the frame identically in every
        worker's response stream — all ranks flip knobs at the same
        cycle boundary."""
        payload = self.tune_session.take_announcement()
        if payload is None:
            return
        data = json.dumps(payload).encode()
        self._synced_params = data
        self._broadcast_frame_locked(_MAGIC_PARAMS, data)

    def _sync_tuned_params_locked(self):
        """Announce the autotuner's categorical knobs to every worker
        via a PA frame (the reference broadcasts tuned params through
        the controller, controller.cc:39-53).  Broadcast under the
        server lock positions the frame identically in every worker's
        response stream, so all ranks flip between the same two fused
        batches."""
        pm = self.param_manager
        params = pm.categorical_params
        self._synced_params_version = pm.params_version
        cache_on = bool(params["cache"])
        if cache_on != self._cache.enabled:
            self._pending_evictions.extend(
                self._cache.set_enabled(cache_on))
            self._flush_evictions_locked()
        payload = json.dumps({
            "hierarchical": bool(params["hierarchical"]),
            "cache": cache_on,
            "fusion": int(self.fusion_threshold),
            # Lifecycle bit for the replay tracker: the legacy
            # autotuner's convergence releases the replay hold exactly
            # like a tune-session freeze — replay gates on "tuning
            # still active", not on the blanket autotune knob.
            "tuning_active": bool(pm.active),
        }).encode()
        self._synced_params = payload
        self._broadcast_frame_locked(_MAGIC_PARAMS, payload)

    def _assign_cache_bits(self, fused: List[Response],
                           sig_by_key: Dict[tuple, tuple]):
        """Seed the cache from freshly negotiated responses and stamp
        the coordinator-assigned bits onto the wire."""
        pending = set(self._table.entries.keys())
        for resp in fused:
            if resp.response_type not in CACHEABLE or resp.error_message:
                continue
            parts = split_response(resp, self.size)
            bits = []
            for i, name in enumerate(resp.tensor_names):
                key = (resp.process_set_id, name)
                sig = sig_by_key.get(key)
                if sig is None:
                    bits.append(-1)
                    continue
                bit, evicted = self._cache.insert(
                    key, parts[i], sig, self._group_ids.get(key, -1),
                    pending)
                bits.append(bit)
                self._pending_evictions.extend(evicted)
            resp.cache_bits = bits

    def _flush_evictions_locked(self):
        if self._pending_evictions:
            self._broadcast_frame_locked(
                _MAGIC_EVICT, pack_bits(self._pending_evictions))
            self._pending_evictions = []

    def _broadcast_frame_locked(self, magic: bytes, payload: bytes):
        # Failpoint site: coordinator broadcast fan-out.  drop()
        # suppresses one whole downlink frame — every rank misses it,
        # the negotiation wedges, and the stall shutdown must fail the
        # collective rather than hang the job.  error() degrades to
        # the same drop semantics: a raise here would propagate into
        # whichever caller holds the lock (rank loops, the stall and
        # metrics threads) and permanently kill the very machinery
        # that bounds the fault.
        if _fp.ENABLED:
            try:
                if _fp.maybe_fail("coord.broadcast") == "drop":
                    return
            except _fp.FailpointError:
                logger.warning("failpoint coord.broadcast: injected "
                               "error; dropping the frame")
                return
        self._last_broadcast_t = time.monotonic()
        t0 = time.perf_counter_ns()
        sent = 0
        if self._tree:
            # Relay tree: ONE send per root link — O(fanout) relay
            # links plus the direct leaves (rank 0's loopback and any
            # re-homed stragglers); relays fan the frame down.  The
            # out-log still records per RANK (relays are stateless),
            # so any leaf can resume against the root after its relay
            # dies.
            if self.reconnect_grace_s > 0:
                for r in set(self._conns) | set(self._rank_via) | \
                        set(self._limbo):
                    self._log_out_locked(r, magic, payload)
            dead = []
            for r, conn in self._conns.items():
                try:
                    _send_frame(conn, magic, payload)
                    sent += 1
                except OSError:
                    dead.append(r)
            for r in dead:
                if self.reconnect_grace_s > 0 and \
                        r not in self._lost:
                    self._enter_limbo_locked(r)
                else:
                    self._conns.pop(r, None)
            for rid, conn in self._relay_conns.items():
                try:
                    _send_frame(conn, magic, payload)
                    sent += 1
                except OSError:
                    pass  # the mux reaps the dead relay link
        elif self.reconnect_grace_s > 0:
            # Limbo ranks have no live socket but stay in the fan-out:
            # the frame enters their out-log, so a resume inside the
            # grace window replays it and the rank never falls out of
            # lockstep.
            for r in list(self._conns.keys()) + \
                    list(self._limbo.keys()):
                if self._send_to_rank_locked(r, magic, payload):
                    sent += 1
        else:
            # Reconnects off: the original direct fan-out (this is the
            # hottest coordinator path — no per-rank indirection).
            dead = []
            for r, conn in self._conns.items():
                try:
                    _send_frame(conn, magic, payload)
                    sent += 1
                except OSError:
                    dead.append(r)
            for r in dead:
                self._conns.pop(r, None)
        self.bcast_ns += time.perf_counter_ns() - t0
        self.bcast_sends += sent
        if _fr.ENABLED:
            _fr.record(_fr.FRAME_TX, rank=0, role="coord",
                       frame=magic.decode("ascii", "replace"),
                       nbytes=len(payload), fanout=sent)
        if sent:
            # Coordinator fan-out is the dominant control-plane send
            # volume on rank 0 — account it next to the worker-side
            # counters (same registry, same process).
            _FRAMES_SENT.inc(sent, kind=magic.decode("ascii", "replace"))
            _BYTES_SENT.inc(sent * (len(payload) + 6))

    def _send_to_rank_locked(self, rank: int, magic: bytes,
                             payload: bytes) -> bool:
        """One downlink frame to one rank: out-log bookkeeping and the
        send in lockstep (caller holds self._lock).  A send failure
        with reconnects enabled parks the rank in limbo instead of
        dropping it."""
        self._log_out_locked(rank, magic, payload)
        conn = self._conns.get(rank)
        if conn is None:
            return False
        try:
            _send_frame(conn, magic, payload)
            return True
        except OSError:
            if self.reconnect_grace_s > 0 and rank not in self._lost:
                self._enter_limbo_locked(rank)
            else:
                self._conns.pop(rank, None)
            return False

    def _log_out_locked(self, rank: int, magic: bytes, payload: bytes):
        if self.reconnect_grace_s <= 0 or magic in _OOS_DOWN:
            return
        log = self._out_log.get(rank)
        if log is None:
            return
        self._out_seq[rank] = self._out_seq.get(rank, 0) + 1
        log.append((self._out_seq[rank], magic, payload))

    # ------------------------------------------------------------------
    # stall attribution (reference stall_inspector.{h,cc}: rank-0 names
    # which ranks submitted a tensor and which did not)
    # ------------------------------------------------------------------
    def _check_formation_stall(self):
        """Pre-formation requests never enter the message table, so
        the per-tensor stall report is blind to a rank that crashes
        before connecting — attribute THAT stall here, and past the
        shutdown threshold fail the buffered collectives (the failure
        class the stall machinery exists for)."""
        with self._lock:
            if self._formed or not self._pre_formed:
                return
            age = time.monotonic() - self._started_at
            if age < self._stall_warning_s:
                return
            attached = self._attached_ranks_locked()
            missing = sorted(set(range(self.size)) - attached)
            last = self._stall_logged.get(("__formation__",), 0.0)
            if age - last >= self._stall_warning_s or last == 0:
                self._stall_logged[("__formation__",)] = age
                logger.warning(
                    "STALL: waiting for ranks %s to connect for %.0fs "
                    "(%d/%d registered, %d requests buffered)",
                    missing, age, len(attached), self.size,
                    len(self._pre_formed))
            if 0 < self._stall_shutdown_s <= age:
                pre, self._pre_formed = self._pre_formed, []
                errs = [Response(
                    response_type=ResponseType.ERROR,
                    tensor_names=[req.tensor_name],
                    process_set_id=req.process_set_id,
                    error_message=(
                        "ranks %s never connected within %.0fs"
                        % (missing, self._stall_shutdown_s)))
                    for kind, _, payload in pre if kind == "rq"
                    for req in payload]
                if errs:
                    self._broadcast_locked(errs)

    def stall_report(self) -> List[Tuple[str, List[int], List[int], float]]:
        """(tensor, submitted_ranks, missing_ranks, age_s) for every
        tensor — including pending barriers — stuck longer than the
        warning threshold."""
        now = time.monotonic()
        out = []
        with self._lock:
            for key, msgs in self._table.entries.items():
                if not msgs:
                    continue
                ts = self._first_seen.get(key)
                if ts is None or now - ts < self._stall_warning_s:
                    continue
                submitted = sorted({m.request_rank for m in msgs})
                members = msgs[0].process_set_ranks or range(self.size)
                missing = sorted(set(members) - set(submitted)
                                 - self._joined)
                out.append((key, submitted, missing, now - ts))
            for key, arrived in self._barriers.items():
                ts = self._first_seen.get(key)
                if ts is None or now - ts < self._stall_warning_s:
                    continue
                members = self._barrier_members.get(key) or \
                    range(self.size)
                missing = sorted(set(members) - arrived - self._joined)
                out.append((key, sorted(arrived), missing, now - ts))
        return out

    def _stall_loop(self):
        interval = max(min(self._stall_warning_s / 2.0, 10.0), 0.25)
        while not self._stop.wait(interval):
            self._check_formation_stall()
            for key, submitted, missing, age in self.stall_report():
                name = key[1]
                last = self._stall_logged.get(key, 0.0)
                if age - last < self._stall_warning_s and last > 0:
                    continue
                self._stall_logged[key] = age
                # Flight-recorder attribution: the warning names what
                # the implicated tensor last DID (frame/replay/submit
                # events), not just which ranks are missing.
                recent = _fr.recent_for_tensors([name]) \
                    if _fr.ENABLED else []
                # Straggler attribution: "everyone blocked on rank 3"
                # (the top straggler IS among the missing — slow, not
                # dead; the pre-emptive-migration case) reads very
                # differently from "no straggler signal" (suspect a
                # wedged rank or the coordinator's own links).
                top = self.straggler_top()
                if top is not None and top[0] in missing:
                    sg_note = (" Missing ranks appear blocked behind "
                               "straggler rank %d (score %.1f): slow,"
                               " not dead." % top)
                    # Root cause when the profiler digests carry one:
                    # name the frame the implicated rank is stuck in
                    # (common/profiler.py), turning "rank 3 is slow"
                    # into "rank 3 is slow in shard_io:fsync".
                    cause = self.profile_root_cause(top[0])
                    if cause:
                        sg_note += (" Rank %d dominant frame: %s."
                                    % (top[0], cause))
                elif top is not None:
                    sg_note = (" Top straggler rank %d (score %.1f) "
                               "is not among the missing ranks; "
                               "suspect a wedged rank or link "
                               "instead." % top)
                else:
                    sg_note = ""
                logger.warning(
                    "STALL: tensor %s — ranks %s submitted, ranks %s "
                    "have not, for %.0fs. One or more ranks may be "
                    "running a different graph or have hung.%s%s",
                    name, submitted, missing, age, sg_note,
                    (" Last recorder events: %s" % recent)
                    if recent else "")
                if _fr.ENABLED:
                    _fr.record(_fr.STALL, rank=0, role="coord",
                               tensor=name, submitted=submitted,
                               missing=missing, age_s=round(age, 3),
                               straggler=list(top) if top else None)
                if _prof.ENABLED:
                    # Why-is-it-slow: freeze the profiler window at
                    # the moment the coordinator surfaced the stall.
                    _prof.trigger_capture(
                        "stall", "tensor %s missing %s" % (
                            name, missing))
                if 0 < self._stall_shutdown_s <= age:
                    logger.error(
                        "stalled tensor %s exceeded shutdown threshold "
                        "(%.0fs); failing the collective", name,
                        self._stall_shutdown_s)
                    if _fr.ENABLED:
                        _fr.trigger_dump("stall_shutdown")
                    with self._lock:
                        msgs = self._table.pop(key)
                        if self._straggler is not None:
                            self._straggler.note_abandon(key)
                        # Barriers stall too (tracked outside the
                        # message table); fail the arrived ranks the
                        # same way.
                        stalled_barrier = \
                            self._barriers.pop(key, None) is not None
                        self._barrier_members.pop(key, None)
                        self._first_seen.pop(key, None)
                        self._bit_only.pop(key, None)
                        if msgs or stalled_barrier:
                            self._broadcast_locked([Response(
                                response_type=ResponseType.ERROR,
                                tensor_names=[name],
                                process_set_id=key[0],
                                error_message=(
                                    f"collective {name} stalled: ranks "
                                    f"{missing} never submitted it "
                                    f"within {self._stall_shutdown_s:.0f}"
                                    "s"))])

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values()) + \
                list(self._relay_conns.values())
            self._conns.clear()
            self._relay_conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        if self._mux is not None:
            self._mux.stop()


class NetworkController(Controller):
    """Per-rank controller client.  Rank 0 additionally hosts the
    CoordinatorServer (mirroring the reference where rank 0 is both a
    worker and the coordinator, controller.cc:69-449)."""

    def __init__(self, state):
        super().__init__(state)
        self.server: Optional[CoordinatorServer] = None
        self._closing = False
        self._broken_err: Optional[Exception] = None
        # Worker-side response cache (fast-path uplink/downlink); the
        # coordinator owns bit assignment, we just follow the RS frames.
        self.cache = WorkerResponseCache(state.knobs.cache_capacity)
        self._sent_sigs: Dict[tuple, tuple] = {}  # (psid, name) -> sig
        # Bounded cache-seed diagnostics (read on desync only).
        from collections import deque
        self._seed_log = deque(maxlen=64)
        self.stats = {"rq_frames": 0, "ch_frames": 0, "rs_frames": 0,
                      "cb_frames": 0, "ev_frames": 0, "pa_frames": 0,
                      "mr_frames": 0,
                      "bytes_sent": 0, "bytes_recv": 0}
        # PA params stashed until the batches received before them have
        # executed (applied at the next compute_response_list entry).
        self._pending_params: Optional[dict] = None
        # Runtime hook for tuned worker knobs (cycle time, coalescing,
        # replay warmup/hold): _apply_params forwards the decoded PA
        # payload so the runtime flips its knobs at the frame's
        # position in the response stream.
        self._params_hook = None
        # True while an MR (metrics snapshot) reply thread is in
        # flight; written only by the recv thread.
        self._mr_sending = False
        # Straggler-observatory phase collector (wired by the runtime;
        # its EWMAs are folded into rank-labeled gauges right before
        # each MR reply so the per-rank summaries ride the existing
        # metrics frames).
        self._phase_collector = None
        self._replay_observer = None
        # --- self-healing control plane (docs/failure_recovery.md) ---
        # _selfheal is THE hot-path gate: None when both liveness and
        # reconnect are disabled, so the steady-state submit path pays
        # exactly one attribute check (the failpoints.ENABLED
        # precedent, asserted by tests/test_liveness.py).
        knobs = state.knobs
        self._liveness_interval_s = knobs.liveness_interval_s
        # Relay tree (HOROVOD_COORD_FANOUT, common/relay.py): this
        # rank's parent may be a relay; re-homing walks the ancestor
        # chain toward the root.  The coordinator-silence deadline is
        # depth-aware — each relay hop adds forwarding latency (and
        # one possible failover) between the root's heartbeat and us.
        self._fanout = getattr(knobs, "coord_fanout", 0)
        self._plan = relay_mod.plan_tree(self.size, self._fanout) \
            if self._fanout > 0 else None
        self._hops = self._plan.leaf_hops(self.rank) \
            if (self._plan is not None and self.rank != 0) else 0
        self._liveness_timeout_s = env_mod.depth_aware_liveness_timeout(
            knobs.liveness_timeout_s, self._hops)
        self._grace_s = knobs.reconnect_grace_s
        self._hosted_relays: List = []
        self._selfheal = True if (self._liveness_interval_s > 0 or
                                  self._grace_s > 0) else None
        self._session_id = "%016x" % random.getrandbits(64)
        self._up_log: deque = deque(maxlen=_LINK_LOG_FRAMES)
        self._up_count = 0          # uplink frames sent this session
        self._recv_count = 0        # downlink frames processed
        self._last_recv_t = time.monotonic()
        self._last_uplink_t = time.monotonic()
        self._wedged = False        # harness SIGSTOP analog
        self._half_open = False     # harness peer-vanishes analog
        self._hb_stop = threading.Event()
        self._hb_thread = None
        addr = env_mod.env_str_opt(CONTROLLER_ADDR_ENV)
        if self.rank == 0:
            port = 0
            if addr and ":" in addr:
                port = int(addr.rsplit(":", 1)[1])
            param_manager = None
            tune_session = None
            if state.knobs.tune:
                # Autotune-then-freeze (horovod_tpu/tune): a valid
                # profile at HOROVOD_TUNE_PROFILE means the search
                # already ran — build a pre-frozen session (per-class
                # thresholds from the artifact, startup announcement
                # says tuning_active=false) so restarts and elastic
                # resizes skip the re-search.  Takes precedence over
                # the legacy HOROVOD_AUTOTUNE path.
                from ..tune.session import TuningSession
                # The SAME parsed artifact Knobs.from_env adopted —
                # never a second read of the file, which could race a
                # concurrent freeze replacing it and hand the session
                # different knobs than the ones already applied.
                prof = getattr(state.knobs, "tune_profile_obj", None)
                if prof is not None:
                    tune_session = TuningSession.from_profile(
                        state.knobs, self.size, prof,
                        profile_path=state.knobs.tune_profile)
                else:
                    tune_session = TuningSession(
                        state.knobs, self.size,
                        profile_path=state.knobs.tune_profile)
                state.tune_session = tune_session
            elif state.knobs.autotune:
                from .parameter_manager import ParameterManager
                param_manager = ParameterManager(
                    warmup_samples=state.knobs.autotune_warmup_samples,
                    steps_per_sample=state.knobs.autotune_steps_per_sample,
                    bayes_opt_max_samples=(
                        state.knobs.autotune_bayes_opt_max_samples),
                    gp_noise=state.knobs.autotune_gaussian_process_noise,
                    initial_fusion_bytes=(
                        state.knobs.fusion_threshold_bytes),
                    initial_cycle_ms=state.knobs.cycle_time_ms,
                    # Explicit env settings pin the categorical dims.
                    fixed_hierarchical=state.knobs.hierarchical_allreduce,
                    fixed_cache=(False if state.knobs.cache_capacity == 0
                                 else None),
                    log_path=state.knobs.autotune_log)
                state.parameter_manager = param_manager
            self.server = self._make_server(state, port, param_manager,
                                            tune_session)
            self._publish_actual_addr(addr, self.server.port)
            host = "127.0.0.1"
            self._addr = (host, self.server.port)
            self._host_relays(state, addr)
        else:
            resolved = self._resolve_addr(addr)
            if not resolved:
                raise RuntimeError(
                    f"{CONTROLLER_ADDR_ENV} must be set for multi-process "
                    "runs (the launcher sets it automatically).")
            host, port = resolved.rsplit(":", 1)
            self._addr = (host, int(port))
            self._host_relays(state, resolved)
        self._addr_chain = self._build_addr_chain()
        self._sock = self._connect()
        self._recv_buf: "queue.Queue" = queue.Queue()
        self._on_receive = None
        self._on_response = None
        self._send_lock = threading.Lock()
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name="hvd-ctrl-recv", daemon=True)
        self._recv_thread.start()
        if self._liveness_interval_s > 0:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name="hvd-ctrl-heartbeat",
                daemon=True)
            self._hb_thread.start()

    def set_receive_callback(self, fn):
        """Called (from the recv thread) whenever a frame is queued —
        the runtime wires its wake event here so response pickup is
        event-driven instead of a poll."""
        self._on_receive = fn

    def set_phase_collector(self, collector):
        """Runtime hook (common/straggler.py): the per-runtime phase
        collector whose EWMAs each MR reply publishes under this
        rank's label."""
        self._phase_collector = collector

    def set_replay_observer(self, observer):
        """Steady-state replay hook (common/replay.py): the recv thread
        reports response/eviction/param frames so the tracker can
        detect converged cycles and exit replay on invalidation.
        Observation happens BEFORE delivery, so by the time a blocked
        submitter wakes the tracker has already recorded its response."""
        self._replay_observer = observer

    def set_response_callback(self, fn):
        """Direct dispatch: the recv thread executes each response by
        calling ``fn(response)`` the moment its frame is decoded,
        instead of queuing for the background thread.  On a 1-core
        host every thread handoff is a context switch, so cutting the
        recv->queue->background hop removes a fixed ~0.1-0.2 ms from
        per-op latency (the reference instead pays its fixed cycle
        sleep, operations.cc:587).  Ordering is inherited from the
        coordinator's broadcast order because the recv loop is the
        single, sequential consumer of the socket.  PA markers apply
        in-stream between executed batches for free."""
        self._on_response = fn

    def _make_server(self, state, port, param_manager,
                     tune_session=None):
        """Prefer the native C++ coordinator (horovod_tpu_torch/native);
        fall back to the Python CoordinatorServer.  The Python server is
        also used when a timeline is active (negotiation spans are
        recorded coordinator-side), when cross-rank metrics
        aggregation is requested (MQ/MR frames), and while the
        autotuner runs (the
        parameter manager scores real per-round byte counts in-line and
        announces categorical knobs via PA frames — higher-fidelity
        than the native counter-polling path it replaces)."""
        allow_ephemeral = self._rendezvous_client() is not None
        stall_warn = 0.0 if state.knobs.stall_check_disable else \
            state.knobs.stall_warning_time_s
        # When the user EXPLICITLY set HOROVOD_TPU_NATIVE to a truthy
        # value, a missing/broken native build is an error, not a
        # silent fallback — otherwise native-path tests pass vacuously
        # against the Python coordinator.
        strict_native = env_mod.env_bool("HOROVOD_TPU_NATIVE")
        if strict_native and param_manager is not None:
            raise RuntimeError(
                "HOROVOD_TPU_NATIVE=1 is incompatible with "
                "HOROVOD_AUTOTUNE=1: the autotuner requires the Python "
                "coordinator (in-line scoring + PA parameter frames). "
                "Unset one of the two.")
        if strict_native and tune_session is not None:
            raise RuntimeError(
                "HOROVOD_TPU_NATIVE=1 is incompatible with "
                "HOROVOD_TUNE=1: autotune-then-freeze requires the "
                "Python coordinator (per-class round scoring + PA knob "
                "frames).  Run the frozen knobs through plain env "
                "variables instead, or unset one of the two.")
        metrics_interval = state.knobs.metrics_agg_interval_s
        if strict_native and metrics_interval > 0:
            raise RuntimeError(
                "HOROVOD_TPU_NATIVE=1 is incompatible with "
                "HOROVOD_METRICS_AGG_SECONDS>0: cross-rank metrics "
                "aggregation requires the Python coordinator (MQ/MR "
                "frames).  Unset one of the two.")
        # Armed failpoints pin the Python coordinator: the native C++
        # coordinator carries no injection sites, and a fault schedule
        # that silently skipped its coord.*/worker.* rules would report
        # a vacuous pass.  Strict-native + failpoints is a config error.
        if strict_native and _fp.ENABLED:
            raise RuntimeError(
                "HOROVOD_TPU_NATIVE=1 is incompatible with "
                "HOROVOD_FAILPOINTS: fault injection requires the "
                "Python coordinator.  Unset one of the two.")
        # The self-healing control plane (HB liveness, reconnect grace)
        # is Python-coordinator-only: the native server treats any
        # non-CH/RQ frame as a departed rank, so heartbeats would kill
        # every link.  Same gating rule as the other Python-only
        # features above (documented in docs/failure_recovery.md).
        selfheal = state.knobs.liveness_interval_s > 0 or \
            state.knobs.reconnect_grace_s > 0
        if strict_native and selfheal:
            raise RuntimeError(
                "HOROVOD_TPU_NATIVE=1 is incompatible with "
                "HOROVOD_LIVENESS_INTERVAL/HOROVOD_RECONNECT_GRACE: "
                "the self-healing control plane requires the Python "
                "coordinator (HB/WE frames).  Unset one of the two.")
        # The relay tree is Python-coordinator-only too: the native
        # server has no RB/RD/RL relay frames, so a relay registering
        # against it would kill the link.  Same gating rule as the
        # other Python-only features above.
        tree = getattr(state.knobs, "coord_fanout", 0) > 0
        if strict_native and tree:
            raise RuntimeError(
                "HOROVOD_TPU_NATIVE=1 is incompatible with "
                "HOROVOD_COORD_FANOUT>0: the relay-tree control plane "
                "requires the Python coordinator (relay frames).  "
                "Unset one of the two.")
        # The straggler observatory is Python-coordinator-only too:
        # arrival attribution lives in the Python _process loop and
        # the worker phase summaries ride MR frames the native server
        # does not speak.  Same gating rule as the features above.
        if strict_native and _sg.ENABLED:
            raise RuntimeError(
                "HOROVOD_TPU_NATIVE=1 is incompatible with "
                "HOROVOD_STRAGGLER=1: the straggler observatory "
                "requires the Python coordinator (CH/RQ arrival "
                "attribution + MR phase frames).  Unset one of the "
                "two.")
        if state.timeline is None and param_manager is None and \
                tune_session is None and \
                metrics_interval <= 0 and not _fp.ENABLED and \
                not selfheal and not tree and not _sg.ENABLED:
            try:
                from ..native import NativeCoordinatorServer, available
                if strict_native and not available():
                    raise RuntimeError(
                        "HOROVOD_TPU_NATIVE is set but the native "
                        "coordinator could not be built/loaded")
                if available():
                    return NativeCoordinatorServer(
                        self.size, port=port,
                        fusion_threshold=(
                            state.knobs.fusion_threshold_bytes),
                        elastic=state.knobs.elastic,
                        allow_ephemeral_fallback=allow_ephemeral,
                        cache_capacity=state.knobs.cache_capacity,
                        stall_warning_time_s=stall_warn,
                        stall_shutdown_time_s=(
                            state.knobs.stall_shutdown_time_s))
            except OSError:
                raise   # bind failure: same semantics as Python server
            except Exception:
                if strict_native:
                    raise
                logger.warning("native coordinator unavailable; using "
                               "the Python coordinator", exc_info=True)
        if _slo.ENABLED:
            # Rank 0 hosts the coordinator: its SLO burn alerts become
            # the job-level KV notice the elastic driver folds into
            # ElasticPolicy.Signals (None client → no hook, local
            # alerting still works).
            _slo.set_burn_hook(self._make_slo_publisher())
        return CoordinatorServer(
            self.size, port=port,
            fusion_threshold=state.knobs.fusion_threshold_bytes,
            timeline=state.timeline,
            elastic=state.knobs.elastic,
            allow_ephemeral_fallback=allow_ephemeral,
            param_manager=param_manager,
            cache_capacity=state.knobs.cache_capacity,
            stall_warning_time_s=stall_warn,
            stall_shutdown_time_s=state.knobs.stall_shutdown_time_s,
            metrics_interval_s=metrics_interval,
            liveness_interval_s=state.knobs.liveness_interval_s,
            liveness_timeout_s=state.knobs.liveness_timeout_s,
            reconnect_grace_s=state.knobs.reconnect_grace_s,
            registration_timeout_s=state.knobs.registration_timeout_s,
            fanout=getattr(state.knobs, "coord_fanout", 0),
            on_rank_lost=self._make_rank_lost_publisher(state),
            tune_session=tune_session,
            on_rank_slow=self._make_rank_slow_publisher())

    def _make_rank_lost_publisher(self, state):
        """Rank-0 hook: publish non-clean rank-lost promotions to the
        elastic rendezvous KV so the driver can evict the host of a
        wedged-but-alive worker process (its monitor would otherwise
        wait forever for an exit code)."""
        if not state.knobs.elastic:
            return None
        client = self._rendezvous_client()
        if client is None:
            return None

        def publish(rank, reason, _client=client):
            try:
                from ..runner.elastic.worker import current_epoch
                epoch = current_epoch()
            except Exception:
                epoch = 0
            try:
                # Per-rank key: two ranks lost in the same driver poll
                # interval must not overwrite each other's notice.
                _client.put("elastic", "lost-%d" % rank, json.dumps({
                    "rank": rank,
                    "reason": reason or "connection lost",
                    "epoch": epoch,
                }).encode())
            except OSError:
                logger.warning("could not publish the lost-rank "
                               "notice to the rendezvous KV",
                               exc_info=True)

        def hook(rank, clean, reason):
            if clean:
                return
            # Publish OFF the calling thread: the hook runs from frame
            # dispatch (in tree mode the single mux recv thread; in
            # flat mode a rank loop) and a slow/partitioned rendezvous
            # would otherwise block control-plane processing for the
            # client's full HTTP timeout.
            threading.Thread(target=publish, args=(rank, reason),
                             name="hvd-lost-publish", daemon=True
                             ).start()

        return hook

    def _make_rank_slow_publisher(self):
        """Rank-0 hook: publish straggler-threshold crossings to the
        rendezvous KV under ``elastic/slow/<rank>`` — the consumable
        signal for verdict-driven pre-emptive migration (the slow-rank
        mirror of the ``elastic/lost-<rank>``
        promotion notice).  Wired here; the elastic driver does not
        act on it yet."""
        client = self._rendezvous_client()
        if client is None:
            return None

        def publish(rank, score, _client=client):
            try:
                _client.put("elastic", "slow-%d" % rank, json.dumps({
                    "rank": rank,
                    "score": round(score, 3),
                    "wall": time.time(),
                }).encode())
            except OSError:
                logger.warning("could not publish the slow-rank "
                               "notice to the rendezvous KV",
                               exc_info=True)

        def hook(rank, score):
            # Off the scorer's refresh loop: a slow/partitioned
            # rendezvous must not stall score refreshes for the
            # client's full HTTP timeout.
            threading.Thread(target=publish, args=(rank, score),
                             name="hvd-slow-publish", daemon=True
                             ).start()

        return hook

    def _make_slo_publisher(self):
        """Rank-0 hook: publish this job's SLO reading to the
        rendezvous KV under ``elastic/slo`` whenever the plane
        evaluates a burn alert — the load-trend signal
        ``runner/elastic/driver.py`` folds into
        ``ElasticPolicy.Signals`` (cycle_time_s / steps_per_s;
        consumed read-only until an SLO-driven controller lands).  One key, not per-rank: the SLIs are a
        job-level reading taken on the coordinator."""
        client = self._rendezvous_client()
        if client is None:
            return None

        def publish(alert, _client=client):
            reading = _slo.signals_reading()
            try:
                _client.put("elastic", "slo", json.dumps({
                    "sli": alert.get("sli"),
                    "burn_short": alert.get("burn_short"),
                    "burn_long": alert.get("burn_long"),
                    "steps_per_s": reading.get("steps_per_s"),
                    "cycle_time_s": reading.get("cycle_time_s"),
                    "wall": time.time(),
                }).encode())
            except OSError:
                logger.warning("could not publish the SLO notice to "
                               "the rendezvous KV", exc_info=True)

        def hook(alert):
            # Off the evaluator loop, same as the slow-rank publisher.
            threading.Thread(target=publish, args=(alert,),
                             name="hvd-slo-publish", daemon=True
                             ).start()

        return hook

    @staticmethod
    def _rendezvous_client():
        from ..runner.http_server import RendezvousClient
        addr = env_mod.env_str_opt(env_mod.HOROVOD_RENDEZVOUS_ADDR)
        port = env_mod.env_str_opt(env_mod.HOROVOD_RENDEZVOUS_PORT)
        if not addr or not port:
            return None
        return RendezvousClient(addr, int(port))

    def _ctrl_scope(self) -> str:
        # Per-epoch scope so elastic re-inits don't read a stale addr.
        epoch = env_mod.env_str(CONTROLLER_ADDR_ENV, "")
        return f"controller.{epoch}"

    def _publish_actual_addr(self, env_addr, actual_port):
        """Rank 0: publish the actually-bound controller address to the
        rendezvous KV store (guards against the launcher-chosen port
        being taken by the time rank 0 binds it)."""
        client = self._rendezvous_client()
        if client is None:
            return
        host = env_addr.rsplit(":", 1)[0] if env_addr else "127.0.0.1"
        try:
            client.put(self._ctrl_scope(), "addr",
                       f"{host}:{actual_port}".encode())
        except OSError:
            logger.warning("could not publish controller addr to "
                           "rendezvous", exc_info=True)

    def _resolve_addr(self, env_addr):
        """Workers: prefer the rendezvous-published address; fall back
        to the env contract (used when no rendezvous server exists)."""
        client = self._rendezvous_client()
        if client is not None:
            timeout_s = env_mod.start_timeout()
            try:
                raw = client.wait_get(self._ctrl_scope(), "addr",
                                      timeout=timeout_s)
                return raw.decode()
            except (OSError, TimeoutError):
                logger.warning("rendezvous controller-addr lookup "
                               "failed; using env value")
        return env_addr

    def _host_relays(self, state, env_addr):
        """Launcher runs: designated host ranks start their relays
        in-process and publish the addresses through the rendezvous
        KV.  Skipped entirely when HOROVOD_RELAY_ADDRS is set (a
        harness/launcher owns the relays) or when there is no KV to
        publish through (leaves then fall back to direct root links —
        degraded but correct)."""
        if self._plan is None or relay_mod.relay_addr_map():
            return
        mine = self._plan.relays_hosted_by(self.rank)
        if not mine:
            return
        client = self._rendezvous_client()
        if client is None:
            logger.warning(
                "HOROVOD_COORD_FANOUT=%d requested but neither "
                "HOROVOD_RELAY_ADDRS nor a rendezvous KV is "
                "available to place relays; every rank will link "
                "directly to rank 0 (flat star)", self._fanout)
            return
        # Publish relays at THIS worker's address, not the
        # coordinator's: on a multi-host launch the hosting rank lives
        # on its own machine (the launcher's hostname contract names
        # it); env_addr's host is only right for rank 0 — and for
        # single-host runs, where everything shares it.
        host = env_mod.env_str_opt(env_mod.HOROVOD_HOSTNAME)
        if not host:
            host = env_addr.rsplit(":", 1)[0] if env_addr \
                else "127.0.0.1"
        root_addr = "%s:%d" % self._addr if self.rank == 0 \
            else (env_addr or "")
        local: Dict[int, str] = {}
        knobs = self.state.knobs
        for rid in mine:  # highest level first: parents before kids
            chain = []
            for anc in self._plan.relay_ancestors(rid):
                if anc in local:
                    chain.append(local[anc])
                    continue
                try:
                    chain.append(client.wait_get(
                        self._ctrl_scope(), "relay.%d" % anc,
                        timeout=env_mod.start_timeout()).decode())
                except (OSError, TimeoutError):
                    logger.warning("relay %d: ancestor %d address "
                                   "never appeared; climbing past it",
                                   rid, anc)
            if root_addr:
                chain.append(root_addr)
            try:
                rs = relay_mod.RelayServer(
                    rid, chain, bind_addr="0.0.0.0",
                    liveness_interval_s=knobs.liveness_interval_s,
                    liveness_timeout_s=knobs.liveness_timeout_s,
                    registration_timeout_s=(
                        knobs.registration_timeout_s),
                    depth_below=self._plan.relays[rid].depth_below)
            except (OSError, ConnectionError):
                logger.warning("could not start relay %d; its leaves "
                               "will fall back to ancestors",
                               rid, exc_info=True)
                continue
            addr = "%s:%d" % (host, rs.port)
            local[rid] = addr
            self._hosted_relays.append(rs)
            try:
                client.put(self._ctrl_scope(), "relay.%d" % rid,
                           addr.encode())
            except OSError:
                logger.warning("could not publish relay %d address",
                               rid, exc_info=True)

    def _build_addr_chain(self) -> List[Tuple[str, int]]:
        """This rank's connection targets, nearest parent first, the
        root always last: [relay, grandparent relay, ..., root].
        Re-homing escalates through it (docs/failure_recovery.md)."""
        chain: List[Tuple[str, int]] = []
        if self._plan is not None and self.rank != 0:
            amap = relay_mod.relay_addr_map()
            client = None if amap else self._rendezvous_client()
            for rid in self._plan.ancestors_of_leaf(self.rank):
                addr = amap.get(rid)
                if addr is None and client is not None:
                    try:
                        addr = client.wait_get(
                            self._ctrl_scope(), "relay.%d" % rid,
                            timeout=env_mod.start_timeout()).decode()
                    except (OSError, TimeoutError):
                        addr = None
                if addr and ":" in addr:
                    h, p = addr.rsplit(":", 1)
                    chain.append((h, int(p)))
                else:
                    logger.warning("no address for relay %d; rank %d "
                                   "will skip that hop", rid,
                                   self.rank)
        chain.append(self._addr)
        return chain

    def _registration_payload(self, resume: bool) -> bytes:
        """Rank id, plus the session blob when the self-healing channel
        is on.  The native coordinator reads only the first 4 bytes, so
        the extended form stays wire-compatible."""
        head = struct.pack("<i", self.rank)
        if self._selfheal is None:
            return head
        return head + json.dumps({
            "session": self._session_id,
            "resume": resume,
            "recv_count": self._recv_count,
        }).encode()

    def _poll_period_s(self) -> float:
        return max(min(self._liveness_timeout_s / 4.0, 1.0), 0.05)

    def _arm_sock(self, s: socket.socket):
        """Recv deadline: with liveness on, the recv loop polls at a
        fraction of the liveness timeout (the pre-liveness
        settimeout(None) blocked forever on a wedged coordinator)."""
        if self._liveness_interval_s > 0:
            s.settimeout(self._poll_period_s())
        else:
            # hvdlint: bounded-by(liveness off is the documented
            # legacy opt-out: a wedged coordinator is then caught only
            # by the stall inspector; HOROVOD_LIVENESS_INTERVAL>0
            # arms the poll timeout above)
            s.settimeout(None)

    def _connect(self) -> socket.socket:
        # The start timeout bounds the wait for the coordinator (or
        # this rank's relay) to come up (launcher --start-timeout;
        # reference launch.py start_timeout contract).  With a relay
        # tree, the assigned relay is preferred for a patience window
        # before escalating toward the root — an immediate root
        # fallback at startup would quietly flatten the topology.
        timeout_s = env_mod.start_timeout()
        start = time.monotonic()
        deadline = start + timeout_s
        # Wall-clock patience for the assigned relay (NOT an attempt
        # count: connection-refused fails in microseconds, and relay
        # bring-up on another host can legitimately take a while —
        # serial RelayServer starts gated on KV address waits).
        patience_s = min(max(timeout_s / 4.0, 5.0), 30.0) \
            if len(self._addr_chain) > 1 else 0.0
        last_err = None
        while time.monotonic() < deadline:
            reach = 1 if time.monotonic() - start < patience_s \
                else len(self._addr_chain)
            for addr in self._addr_chain[:reach]:
                try:
                    s = socket.create_connection(addr, timeout=5.0)
                    s.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
                    self._arm_sock(s)
                    _send_frame(
                        s, _MAGIC_REQ,
                        self._registration_payload(resume=False))
                    self._last_recv_t = time.monotonic()
                    return s
                except OSError as e:
                    last_err = e
            time.sleep(0.2)
        raise ConnectionError(
            f"could not reach coordinator via {self._addr_chain}: "
            f"{last_err}")

    def _reconnect(self) -> bool:
        """The control socket died mid-incarnation: retry with
        jittered exponential backoff inside the grace window, resume
        the session (coordinator replays the downlink we missed, we
        replay the uplink it never processed), and hand the new socket
        back to the recv loop.  With a relay tree, retries *re-home*:
        the first attempts go to the assigned relay (a blip heals in
        place), then escalate up the ancestor chain — grandparent
        relay, finally the root, which holds every rank's session
        state (relays are stateless, so the resume is identical at any
        hop).  Returns False when the window expires or the
        coordinator refuses the resume — the caller then runs the
        legacy broken-membership path."""
        deadline = time.monotonic() + self._grace_s
        try:
            self._sock.close()
        except OSError:
            pass
        attempt = 0
        chain = self._addr_chain
        target_idx = 0
        # Hops that accepted TCP but never answered the WE handshake
        # are wedged (SIGSTOP'd relay: its accept thread lives, its
        # forwarding is frozen) — skip them for the rest of this
        # episode instead of burning the grace window on them again.
        wedged_hops = set()
        while not self._closing:
            attempt += 1
            backoff = min(0.05 * (2 ** (attempt - 1)), 1.0)
            backoff *= 0.5 + random.random()  # jitter: avoid stampede
            if time.monotonic() + backoff >= deadline:
                break
            time.sleep(backoff)
            # Escalate one hop every other failed attempt; the last
            # chain entry is always the root.
            target_idx = min((attempt - 1) // 2, len(chain) - 1)
            while target_idx in wedged_hops and \
                    target_idx < len(chain) - 1:
                target_idx += 1
            try:
                s = socket.create_connection(chain[target_idx],
                                             timeout=2.0)
            except OSError:
                continue
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # The WE answer from a healthy path arrives in
                # milliseconds; cap the wait well below the grace
                # window so one unresponsive (wedged) hop leaves
                # enough budget to climb to an ancestor.
                s.settimeout(max(0.25, min(
                    2.0, self._grace_s / 3.0,
                    deadline - time.monotonic())))
                _send_frame(s, _MAGIC_REQ,
                            self._registration_payload(resume=True))
                try:
                    frame = _recv_frame(s)
                except socket.timeout:
                    # Branding the hop wedged is deliberately eager: a
                    # false positive (the hop was healthy but the root
                    # was backlogged replaying a thundering herd of
                    # resumes) only costs climbing to an ancestor —
                    # sessions live on the root, so a resume succeeds
                    # identically at ANY hop, and the root itself is
                    # never skippable.
                    if target_idx < len(chain) - 1:
                        wedged_hops.add(target_idx)
                        logger.warning(
                            "resume via hop %d accepted but never "
                            "answered; climbing the ancestor chain",
                            target_idx)
                    s.close()
                    continue
                if frame is None or frame[0] != _MAGIC_WELCOME:
                    s.close()
                    continue
                info = json.loads(frame[1].decode())
                if not info.get("resume"):
                    # The coordinator cannot resume this session (out
                    # of its replay window, or the rank was already
                    # promoted to lost) — fail over, don't retry.
                    s.close()
                    logger.warning("control-channel resume refused by "
                                   "the coordinator")
                    _RECONNECTS.inc(1, outcome="failed")
                    return False
                acked = int(info.get("recv_count", 0))
                with self._send_lock:
                    if not (0 <= acked <= self._up_count and
                            self._up_count - acked <= len(self._up_log)):
                        s.close()
                        _RECONNECTS.inc(1, outcome="failed")
                        return False
                    for ordinal, magic, payload in self._up_log:
                        if ordinal > acked:
                            _send_frame(s, magic, payload)
                    self._arm_sock(s)
                    self._sock = s
                self._last_recv_t = time.monotonic()
                logger.info(
                    "control channel resumed after %d attempt(s) via "
                    "%s (replayed %d uplink frames)", attempt,
                    "parent" if target_idx == 0 else
                    ("ancestor %d" % target_idx),
                    self._up_count - acked)
                _RECONNECTS.inc(1, outcome="resumed")
                if _fr.ENABLED:
                    _fr.record(_fr.RESUME, rank=self.rank,
                               role="worker", outcome="resumed",
                               hop=target_idx, attempts=attempt,
                               replayed=self._up_count - acked,
                               sess=self._session_id[:8])
                if len(chain) > 1:
                    relay_mod._REHOMES.inc(
                        1, outcome="resumed_parent" if target_idx == 0
                        else "resumed_ancestor")
                    if _fr.ENABLED:
                        _fr.record(_fr.REHOME, rank=self.rank,
                                   role="worker", hop=target_idx,
                                   outcome="resumed")
                return True
            except (OSError, ValueError):
                try:
                    s.close()
                except OSError:
                    pass
                continue
        if not self._closing:
            logger.warning("control channel could not be re-established "
                           "within the %.1fs grace window", self._grace_s)
            _RECONNECTS.inc(1, outcome="failed")
            if _fr.ENABLED:
                _fr.record(_fr.RESUME, rank=self.rank, role="worker",
                           outcome="failed", attempts=attempt,
                           sess=self._session_id[:8])
            if len(chain) > 1:
                relay_mod._REHOMES.inc(1, outcome="failed")
        return False

    # ------------------------------------------------------------------
    # worker-side liveness (HB heartbeats)
    # ------------------------------------------------------------------
    def _hb_loop(self):
        """Heartbeat timer: an HB frame rides the uplink whenever no
        real traffic has flowed for a liveness interval (piggyback
        suppression — steady-state training sends zero HBs).  Also the
        evaluation point for the net.* / worker.wedge failpoints,
        which model exactly the silent failures liveness exists to
        catch."""
        period = max(self._liveness_interval_s / 2.0, 0.05)
        suppressed = False  # flight-recorder state flip, not per-tick
        while not self._hb_stop.wait(period):
            if self._closing:
                return
            if _fp.ENABLED:
                # worker.wedge: partition(Ns) wedges this rank like a
                # SIGSTOP — heartbeats stop, downlink processing stops
                # (the recv loop checks the same window), the socket
                # stays open.  Only coordinator liveness can see it.
                if _fp.maybe_fail("worker.wedge",
                                  rank=self.rank) == "drop":
                    continue
                # net.half_open: the peer vanishes without FIN — stop
                # all sends permanently, keep the socket.
                if _fp.maybe_fail("net.half_open",
                                  rank=self.rank) == "drop":
                    self._half_open = True
                # net.conn_drop: a transient TCP drop — sever the live
                # socket; the reconnect path must heal it.
                if _fp.maybe_fail("net.conn_drop",
                                  rank=self.rank) == "drop":
                    self.debug_sever()
                    continue
            if self._wedged or self._half_open:
                continue
            if time.monotonic() - self._last_uplink_t < \
                    self._liveness_interval_s:
                # Real traffic is flowing; HB suppressed.  Record the
                # state FLIP only (never per tick): a postmortem can
                # tell "quiet because piggybacked" from "quiet because
                # dead" without the ring filling with suppressions.
                if _fr.ENABLED and not suppressed:
                    _fr.record(_fr.HB_TX, rank=self.rank,
                               role="worker", suppressed=True)
                suppressed = True
                continue
            suppressed = False
            if _fp.ENABLED and _fp.maybe_fail(
                    "net.heartbeat_drop", rank=self.rank) == "drop":
                continue
            try:
                with self._send_lock:
                    self._send_frame_counted_locked(
                        _MAGIC_HB, b"", "hb_frames", "HB")
                _HEARTBEATS.inc(1, role="worker")
            except OSError:
                pass  # the recv loop owns link-death handling

    # Harness hooks (tools/chaos_soak.py, tests/test_liveness.py):
    # deterministic in-process analogs of SIGSTOP and a TCP RST.
    def debug_wedge(self, on: bool = True):
        """Freeze this rank's control plane without closing anything:
        no heartbeats, no downlink processing — what SIGSTOP looks
        like from the coordinator's side."""
        self._wedged = on

    def debug_half_open(self, on: bool = True):
        """Peer-drops-without-FIN analog: sends stop, reads stop, the
        socket object stays open so the coordinator gets no EOF."""
        self._half_open = on

    def debug_sever(self):
        """Abruptly close the live control socket (transient network
        drop); with reconnect enabled the channel must self-heal.
        shutdown() first: close() alone does not release the kernel's
        file reference while a thread is blocked inside recv, so no
        FIN would reach the peer until that thread woke."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def set_broken_callback(self, fn):
        """Called once (from the recv thread) when the control-plane
        connection dies mid-incarnation, so the runtime can fail fast
        instead of waiting for the next submission to notice."""
        self._on_broken = fn

    def _set_broken(self, err):
        self._broken_err = err
        if _fr.ENABLED:
            _fr.record(_fr.FATAL, rank=self.rank, role="worker",
                       error=str(err)[:200],
                       sess=self._session_id[:8])
            _fr.trigger_dump("fatal")
        if self._replay_observer is not None:
            self._replay_observer.on_broken()
        cb = getattr(self, "_on_broken", None)
        if cb is not None:
            try:
                cb(err)
            except Exception:
                logger.warning("broken-callback failed", exc_info=True)

    def _on_recv_idle(self):
        if self._closing:
            raise _LinkSilent("closing")
        if self._wedged or self._half_open:
            return  # a wedged rank detects nothing (SIGSTOP analog)
        if time.monotonic() - self._last_recv_t > \
                self._liveness_timeout_s:
            raise _LinkSilent(
                "coordinator silent for > %.1fs"
                % self._liveness_timeout_s)

    def _note_recv_data(self):
        self._last_recv_t = time.monotonic()

    def _recv_loop(self):
        bounded = self._liveness_interval_s > 0
        while True:
            silent = False
            try:
                if bounded:
                    frame = _recv_frame_bounded(self._sock,
                                                self._on_recv_idle,
                                                self._note_recv_data)
                else:
                    frame = _recv_frame(self._sock)
            except OSError:
                frame = None
            except _LinkSilent as e:
                frame = None
                if not self._closing:
                    silent = True
                    logger.warning("liveness: %s", e)
                    _LIVENESS_TIMEOUTS.inc(1, role="worker")
            if frame is None:
                if self._closing:
                    return
                # Transient-fault tolerance: try to resume the session
                # inside the grace window before declaring the world
                # broken.  A silent coordinator may just be a half-open
                # socket on our side — a successful resume proves it.
                if self._grace_s > 0 and self._reconnect():
                    continue
                if self._closing:
                    return  # teardown raced the reconnect window
                from .exceptions import HorovodInternalError
                self._set_broken(HorovodInternalError(
                    "coordinator liveness timeout (no control-plane "
                    "traffic for %.1fs)" % self._liveness_timeout_s
                    if silent else
                    "connection to the coordinator was lost "
                    "(membership changed or rank 0 exited)"))
                return
            magic, payload = frame
            while (self._wedged or self._half_open) and \
                    not self._closing:
                time.sleep(0.02)  # SIGSTOP analog: hold the frame
            if _fp.ENABLED:
                # worker.wedge=partition(Ns): downlink processing
                # pauses for the window, like the harness flag above.
                while not self._closing and _fp.maybe_fail(
                        "worker.wedge", rank=self.rank) == "drop":
                    time.sleep(0.02)
            self._last_recv_t = time.monotonic()
            if magic == _MAGIC_WELCOME:
                continue  # handshake-only frame; not part of the stream
            if magic == _MAGIC_HB:
                _FRAMES_RECV.inc(1, kind="HB")
                if _fr.ENABLED:
                    _fr.record(_fr.HB_RX, rank=self.rank,
                               role="worker")
                continue  # out-of-stream liveness signal
            if magic == _MAGIC_METRICS_REQ:
                # Out-of-stream metrics poll: absolute snapshots need
                # no replay, and keeping MQ/MR outside the stream
                # cursors is what lets relays aggregate them.
                _FRAMES_RECV.inc(1, kind="MQ")
                self._spawn_metrics_reply()
                continue
            self._recv_count += 1
            # Failpoint site: downlink frame arrival on a worker.
            # drop() loses one response/cache frame for THIS rank only
            # — it falls out of lockstep with its peers, the shape of
            # desync the coordinator's attribution must survive.
            # error() models a corrupt/dead downlink and must route
            # through the broken-connection path: letting it kill this
            # recv thread bare would leave blocked synchronize()
            # callers hanging with no one to fail them.
            if _fp.ENABLED:
                try:
                    if _fp.maybe_fail("worker.frame_recv",
                                      rank=self.rank) == "drop":
                        continue
                except _fp.FailpointError as e:
                    from .exceptions import HorovodInternalError
                    self._set_broken(HorovodInternalError(str(e)))
                    return
            self.stats["bytes_recv"] += len(payload) + 6
            _BYTES_RECV.inc(len(payload) + 6)
            _FRAMES_RECV.inc(1, kind=magic.decode("ascii", "replace"))
            if _fr.ENABLED:
                _fr.record(_fr.FRAME_RX, rank=self.rank, role="worker",
                           frame=magic.decode("ascii", "replace"),
                           nbytes=len(payload) + 6,
                           seq=self._recv_count,
                           sess=self._session_id[:8])
            if magic == _MAGIC_CACHE:
                self.stats["cb_frames"] += 1
                batches = unpack_bit_batches(payload)
                responses = self._reconstruct_cached(batches)
                if responses is None:
                    return  # desync; _broken_err set
                if self._replay_observer is not None:
                    self._replay_observer.on_responses(
                        "cb", list(zip(responses, batches)))
                self._deliver(responses)
                continue
            if magic == _MAGIC_EVICT:
                self.stats["ev_frames"] += 1
                bits = unpack_bits(payload)
                self.cache.evict_bits(bits)
                if self._replay_observer is not None:
                    self._replay_observer.on_evictions(bits)
                continue
            if magic == _MAGIC_ABORT:
                from .exceptions import HorovodInternalError
                self._set_broken(HorovodInternalError(
                    payload.decode(errors="replace")))
                return
            if magic == _MAGIC_PARAMS:
                self.stats["pa_frames"] += 1
                params = json.loads(payload.decode())
                if self._replay_observer is not None:
                    self._replay_observer.on_params()
                if self._on_response is not None:
                    # Direct dispatch executes batches in-stream, so
                    # by the time the PA frame is decoded every batch
                    # received before it has already run — apply
                    # immediately; every worker flips knobs at the
                    # same logical point.
                    self._apply_params(params)
                else:
                    # Queued as an in-stream marker: the runtime
                    # applies it exactly between the batches it
                    # arrived between (hierarchical on/off changes the
                    # compiled collective program — a half-flipped
                    # world would hang).
                    self._recv_buf.put(("PA", params))
                    if self._on_receive is not None:
                        self._on_receive()
                continue
            if magic == _MAGIC_RESP:
                self.stats["rs_frames"] += 1
                responses, _ = unpack_response_list(payload)
                self._seed_cache(responses)
                if self._replay_observer is not None:
                    self._replay_observer.on_responses(
                        "rs", [(r, ()) for r in responses])
                self._deliver(responses)
                continue
            # frame-parity: an unknown kind used to fall through into
            # unpack_response_list, where a garbage payload killed the
            # recv loop with a struct.error.  Log and drop instead —
            # the stream cursor already counted it, so resume replay
            # stays aligned with the coordinator's out-log.
            logger.warning("rank %d: ignoring unknown downlink frame "
                           "kind %r (%d bytes)", self.rank, magic,
                           len(payload))

    def _send_frame_counted_locked(self, magic: bytes, payload: bytes,
                                   stat_key: str, kind: str):
        """One uplink frame + its stats-dict and registry accounting in
        lockstep (caller holds self._send_lock) — the single place the
        frame-header byte math lives on the send side."""
        # Failpoint site: worker uplink.  drop() swallows the RQ/CH
        # frame before the socket — the coordinator never learns this
        # rank is ready, so the tensor must surface through rank-0
        # stall attribution, not a hang.
        if _fp.ENABLED and \
                _fp.maybe_fail("worker.frame_send",
                               rank=self.rank) == "drop":
            return
        if self._selfheal is not None:
            self._uplink_send_selfheal(magic, payload)
        else:
            _send_frame(self._sock, magic, payload)
        self.stats[stat_key] = self.stats.get(stat_key, 0) + 1
        self.stats["bytes_sent"] += len(payload) + 6
        _FRAMES_SENT.inc(1, kind=kind)
        _BYTES_SENT.inc(len(payload) + 6)
        if _fr.ENABLED:
            _fr.record(_fr.FRAME_TX, rank=self.rank, role="worker",
                       frame=kind, nbytes=len(payload) + 6,
                       seq=self._up_count if magic not in _OOS_UP
                       else None, sess=self._session_id[:8])

    def _uplink_send_selfheal(self, magic: bytes, payload: bytes):
        """Uplink send with the self-healing channel on: stamp the
        heartbeat-suppression clock, log the frame for resume replay,
        and — with reconnects enabled — absorb a dead-socket send (the
        frame is in the up-log; the handshake replays it, so a
        transient drop is invisible to the submitting thread)."""
        self._last_uplink_t = time.monotonic()
        if self._grace_s > 0 and magic not in _OOS_UP:
            self._up_count += 1
            self._up_log.append((self._up_count, magic, payload))
            try:
                _send_frame(self._sock, magic, payload)
            except OSError:
                logger.debug("uplink send hit a dead socket; frame "
                             "queued for resume replay")
        else:
            # Out-of-stream (HB/MR) frames are never logged/replayed:
            # a lost heartbeat is re-sent next interval, a lost
            # snapshot is re-covered by the next poll.
            _send_frame(self._sock, magic, payload)

    def _spawn_metrics_reply(self):
        """MR replies ride their own short-lived thread: the recv
        thread must NEVER block on _send_lock — a recv thread waiting
        on a send while both TCP buffers are full closes a distributed
        deadlock cycle with the coordinator's broadcast lock (coord
        holds its lock writing to us, our submit thread holds
        _send_lock writing to the coord, the coord's rank loop waits
        on its lock, we'd wait here).  At most one reply in flight; a
        poll arriving while the previous reply is still blocked is
        dropped — snapshots are absolute, the next poll re-covers it.
        The flag is advisory (set here, cleared by the reply thread):
        the worst race outcome is one dropped poll."""
        if self._mr_sending:
            return
        self._mr_sending = True

        def run():
            try:
                self._send_metrics_snapshot()
            finally:
                self._mr_sending = False

        threading.Thread(target=run, name="hvd-metrics-reply",
                         daemon=True).start()

    def _send_metrics_snapshot(self):
        """MQ poll answer: ship this process's registry snapshot to
        the coordinator."""
        if _sg.ENABLED and self._phase_collector is not None:
            # Fold this rank's phase EWMAs into its rank-labeled
            # gauges so THIS reply carries them: the per-rank
            # summaries ride the existing MR frame (and survive relay
            # MA pre-aggregation, because each rank only writes its
            # own label) — zero new wire kinds, zero extra frames,
            # and attribution keeps working during replay.
            self._phase_collector.publish(self.rank)
        if _prof.ENABLED:
            # Same contract for the sampling profiler's top-K hot
            # frame digest (common/profiler.py): rank-labeled gauges
            # on the existing MR frame, so rank 0 can name the frame
            # a slow rank is stuck in without any new wire kind.
            _prof.publish_digest(self.rank)
        if _slo.ENABLED:
            # And the SLO plane's windowed SLIs + burn rates
            # (common/slo.py).
            _slo.publish(self.rank)
        try:
            payload = json.dumps(metrics.snapshot()).encode()
        except (TypeError, ValueError):
            logger.warning("metrics snapshot not serializable",
                           exc_info=True)
            return
        try:
            with self._send_lock:
                self._send_frame_counted_locked(
                    _MAGIC_METRICS_REP, payload, "mr_frames", "MR")
        except OSError:
            pass  # connection teardown races the poll; never fatal

    def _deliver(self, responses: List[Response]):
        if self._on_response is not None:
            for resp in responses:
                self._on_response(resp)
            return
        self._recv_buf.put(responses)
        if self._on_receive is not None:
            self._on_receive()

    def _seed_cache(self, responses: List[Response]):
        """Store per-tensor slices of newly negotiated responses under
        the coordinator-assigned bits.  Entries for tensors this rank
        never submitted (process-set non-members, joined ranks) carry no
        signature: they resolve CB bits but never produce hits."""
        if not self.cache.enabled:
            return
        for resp in responses:
            if resp.response_type not in CACHEABLE or not resp.cache_bits:
                self._seed_log.append(
                    ("skip", resp.tensor_names, resp.process_set_id,
                     list(resp.cache_bits or ())))
                continue
            parts = split_response(resp, self.size)
            for i, name in enumerate(resp.tensor_names):
                bit = resp.cache_bits[i] if i < len(resp.cache_bits) else -1
                if bit < 0:
                    self._seed_log.append(("nobit", name,
                                           resp.process_set_id))
                    continue
                key = (resp.process_set_id, name)
                self._seed_log.append(("seed", bit, key))
                self.cache.insert(key, bit, parts[i],
                                  self._sent_sigs.get(key))

    def _reconstruct_cached(self, batches: List[List[int]]
                            ) -> Optional[List[Response]]:
        """CB frame: rebuild the fused responses from the local cache.
        By protocol a CB batch only fires when every member rank
        contributed via bit, which implies every rank (member or not)
        still holds the entries — an unknown bit is a hard desync."""
        responses = []
        for batch in batches:
            parts = [self.cache.response_for_bit(b) for b in batch]
            if any(p is None for p in parts):
                from .exceptions import HorovodInternalError
                missing = [b for b, p in zip(batch, parts) if p is None]
                self._set_broken(HorovodInternalError(
                    "response-cache desync: coordinator referenced "
                    "cache bit(s) %s this rank does not hold (batch "
                    "%s; held: %s; frames: %s; seeds: %s)" % (
                        missing, batch, self.cache.debug_bits(),
                        {k: v for k, v in self.stats.items()
                         if k.endswith("_frames")},
                        list(self._seed_log)[-12:])))
                return None
            responses.append(merge_responses(parts))
        return responses

    def try_inline_cache_hit(self, request) -> bool:
        """Submitting-thread fast path (reference cycle analog:
        operations.cc:587-645 cache-hit short circuit): on a
        response-cache hit, the caller thread sends the CH frame
        itself and returns — the background thread never wakes for
        this op, and with direct dispatch the response executes on the
        recv thread, so a steady-state eager op costs ONE context
        switch (recv -> waiting caller) instead of four.  Returns
        False on a miss (caller falls back to the negotiation queue).
        """
        if self._broken_err is not None:
            raise self._broken_err
        if not self.cache.enabled:
            return False
        # count_miss=False: a missed request falls back to the cycle,
        # whose own lookup counts the same logical miss.
        bit = self.cache.lookup_bit(request, count_miss=False)
        if bit is None:
            _INLINE.inc(1, result="miss")
            return False
        _INLINE.inc(1, result="hit")
        try:
            with self._send_lock:
                self._send_frame_counted_locked(
                    _MAGIC_HITS, pack_bits([bit]), "ch_frames", "CH")
        except OSError as e:
            from .exceptions import HorovodInternalError
            raise HorovodInternalError(
                f"could not reach the coordinator: {e}") from e
        return True

    def compute_response_list(self, pending, entry_sizes, threshold_bytes):
        if self._broken_err is not None:
            raise self._broken_err
        if pending:
            hit_bits: List[int] = []
            full: List[Request] = []
            # Group atomicity: a grouped submission travels in ONE
            # frame per rank (runtime.submit_group + pop_pending), so
            # demoting the WHOLE group to full requests whenever any
            # member misses the cache keeps all members' completion
            # counts in lockstep on the coordinator — members can
            # never finish in different rounds (one in a CB batch,
            # another in a later RS frame).
            lookups = [self.cache.lookup_bit(req)
                       if self.cache.enabled else None
                       for req in pending]
            demoted_gids = {req.group_id
                            for req, bit in zip(pending, lookups)
                            if bit is None and req.group_id >= 0}
            for req, bit in zip(pending, lookups):
                if bit is not None and (req.group_id < 0 or
                                        req.group_id not in demoted_gids):
                    hit_bits.append(bit)
                else:
                    full.append(req)
                    self._sent_sigs[(req.process_set_id,
                                     req.tensor_name)] = \
                        request_signature(req)
            try:
                with self._send_lock:
                    if hit_bits:
                        _UPLINK_BATCH.observe(len(hit_bits), kind="CH")
                        self._send_frame_counted_locked(
                            _MAGIC_HITS, pack_bits(hit_bits),
                            "ch_frames", "CH")
                    if full:
                        _UPLINK_BATCH.observe(len(full), kind="RQ")
                        self._send_frame_counted_locked(
                            _MAGIC_REQ, pack_request_list(full),
                            "rq_frames", "RQ")
            except OSError as e:
                from .exceptions import HorovodInternalError
                raise HorovodInternalError(
                    f"could not reach the coordinator: {e}") from e
        if self._pending_params is not None:
            # Everything returned before the PA marker has executed by
            # now (the runtime performs responses before calling back).
            self._apply_params(self._pending_params)
            self._pending_params = None
        responses: List[Response] = []
        try:
            # Non-blocking drain: the recv thread wakes the runtime's
            # cycle event on arrival (set_receive_callback), so there
            # is no poll-interval latency floor here.
            item = self._recv_buf.get_nowait()
            while True:
                if isinstance(item, tuple) and item[0] == "PA":
                    if responses:
                        # Batches before the marker must execute first.
                        self._pending_params = item[1]
                        break
                    self._apply_params(item[1])
                else:
                    responses.extend(item)
                item = self._recv_buf.get_nowait()
        except queue.Empty:
            pass
        return responses, []

    def set_params_hook(self, fn):
        """Runtime callback for tuned worker knobs: called with every
        decoded PA payload, at the frame's in-stream position (see
        _apply_params)."""
        self._params_hook = fn

    def _apply_params(self, params: dict):
        """Adopt autotuned parameters announced by the coordinator
        (reference: Controller::SynchronizeParameters)."""
        if "hierarchical" in params:
            self.state.knobs.hierarchical_allreduce = \
                bool(params["hierarchical"])
        if self._params_hook is not None:
            # Tuned worker knobs (cycle time, coalescing, replay
            # warmup) + the tuning_active lifecycle bit that holds or
            # releases steady-state replay.
            self._params_hook(params)

    def shutdown(self):
        self._closing = True
        self._hb_stop.set()
        try:
            with self._send_lock:
                _send_frame(self._sock, _MAGIC_REQ,
                            pack_request_list([], shutdown=True))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self.server is not None:
            self._drain_server()
            self.server.stop()
        # Hosted relays stop LAST: peer ranks' shutdown frames may
        # still be riding them while the coordinator drains.
        for rs in self._hosted_relays:
            try:
                rs.shutdown()
            except Exception:
                logger.warning("relay shutdown failed", exc_info=True)
        self._hosted_relays = []

    # Grace window: if the set of ever-connected ranks is stagnant and
    # all of them departed, remaining ranks crashed before connecting —
    # no point waiting out the full timeout.
    _DRAIN_STAGNATION_S = 5.0

    def _drain_server(self):
        """Keep serving until every rank departed, so ranks still
        initializing (or draining) can reach the coordinator (the
        reference's background thread likewise serves until all ranks
        shut down, operations.cc:539-585).  Elastic resets use a short
        cap: peers fail over via the broken-membership path anyway."""
        timeout = 5.0 if self.state.knobs.elastic else \
            env_mod.start_timeout()
        deadline = time.monotonic() + timeout
        prev_seen = -1
        stagnant_since = time.monotonic()
        while time.monotonic() < deadline:
            seen, departed = self.server.departure_counts()
            if departed >= self.size:
                return
            now = time.monotonic()
            if seen != prev_seen:
                prev_seen = seen
                stagnant_since = now
            elif departed >= seen and \
                    now - stagnant_since > self._DRAIN_STAGNATION_S:
                logger.warning(
                    "stopping coordinator: %d/%d ranks never "
                    "connected", self.size - seen, self.size)
                return
            time.sleep(0.1)
        logger.warning("stopping coordinator with ranks still attached "
                       "(waited %.0fs)", timeout)
