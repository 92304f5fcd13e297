"""Relay-tree control plane: interior fan-out nodes between the rank-0
coordinator and the leaf ranks (docs/architecture.md).

The flat star makes rank 0 do one serial send per rank on the hottest
broadcast path and hold one uplink socket per rank.  With
``HOROVOD_COORD_FANOUT=F`` the control plane becomes a tree instead:

* leaves (worker ranks) connect to a *relay* — one per simulated
  "host", arity <= F — speaking the regular wire format, unchanged;
* relays aggregate their children's uplink frames into batched ``RB``
  frames toward their parent and fan every broadcast frame down
  verbatim, so the root touches O(F) links and its recv loop drains
  batches instead of per-rank frames;
* relays themselves form a tree of arity <= F until <= F links reach
  the root.  Rank 0's own loopback client always connects directly.

Robustness by construction (the part that earns the hierarchy its
keep): relays are **stateless fail-stop forwarders**.  All per-rank
stream state — sessions, downlink out-logs, uplink cursors — stays on
the root, exactly where the reconnecting-channel machinery keeps
it.  A relay that dies (or loses its parent link) simply disappears:
its children see a dead socket and *re-home* — they walk their
ancestor chain (parent relay, grandparent, ..., root) with the
standard resume handshake, the root replays the downlink frames they
missed from their per-rank out-logs, and they replay their unacked
uplink frames.  A killed relay therefore costs one detection window,
never the world; children that cannot re-home inside the grace window
are promoted through the existing elastic eviction path.

Liveness composes per hop: every parent watches its children with the
depth-aware deadline (``env.depth_aware_liveness_timeout``), a relay
reports a silent/disconnected child up via an ``RL`` notice, and the
relay suppresses its children's idle heartbeats behind a single HB of
its own (HB/MR/MQ frames are *out-of-stream*: never logged, never
replayed — see controller_net).
"""
# hvdlint-module: hot-path (instrumentation must hide behind one attribute check — docs/static_analysis.md)

import heapq
import json
import logging
import os
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import env as env_mod
from . import flight_recorder as _fr
from . import metrics

logger = logging.getLogger("horovod_tpu_torch.relay")

# --- relay-link frame kinds (relay<->parent hops only; the leaf<->
#     parent hop speaks the regular, byte-identical wire format) -------
MAGIC_RELAY_BATCH = b"RB"   # child->parent: batched uplink items
MAGIC_RELAY_DOWN = b"RD"    # parent->child relay: targeted downlink
MAGIC_RELAY_LOST = b"RL"    # relay->parent: child lost notice (JSON)
MAGIC_METRICS_AGG = b"MA"   # relay->parent: aggregated MR snapshots
MAGIC_REGISTER = b"RG"      # RB item kind: forwarded leaf registration

# Relay registration encodes the relay id in the (otherwise >= 0)
# registration rank field: relay k registers as rank -2 - k.  -1 is
# left unused (a sentinel in parts of the reference protocol).
_RELAY_REG_BASE = -2

_REHOMES = metrics.counter(
    "hvd_relay_rehomes_total",
    "Leaf re-home outcomes after a relay/link loss (resumed_parent = "
    "same relay came back; resumed_ancestor = climbed to a "
    "grandparent/the root; failed = grace window expired)")
_CHILD_LOST = metrics.counter(
    "hvd_relay_child_lost_total",
    "Children a relay reported lost to its parent, by kind")
_RELAY_FRAMES = metrics.counter(
    "hvd_relay_frames_total",
    "Frames forwarded through a relay, by direction")
_UPLINK_ITEMS = metrics.histogram(
    "hvd_relay_uplink_items_per_frame",
    "Child uplink items coalesced into one RB frame toward the "
    "parent (drain-all-pending batching)", bounds=metrics.COUNT_BUCKETS)
_AGG_SNAPSHOTS = metrics.counter(
    "hvd_relay_agg_metrics_total",
    "Aggregated MA metrics frames sent upward by relays (each "
    "replaces its subtree's individual MR replies)")
_SWEEP_VISITS = metrics.counter(
    "hvd_liveness_sweep_visits_total",
    "Deadline-heap entries visited by liveness sweeps (stays O(due), "
    "not O(world), per tick — asserted by the perf pin test)")


def relay_reg_rank(relay_id: int) -> int:
    return _RELAY_REG_BASE - relay_id


def is_relay_reg(rank: int) -> bool:
    return rank <= _RELAY_REG_BASE


def relay_id_from_reg(rank: int) -> int:
    return _RELAY_REG_BASE - rank


def relay_addr_map() -> Dict[int, str]:
    """The HOROVOD_RELAY_ADDRS map ({relay_id: "host:port"}), {} when
    unset/unparseable (the KV-published addresses then apply)."""
    raw = env_mod.env_str_opt(env_mod.HOROVOD_RELAY_ADDRS)
    if not raw:
        return {}
    try:
        return {int(k): str(v) for k, v in json.loads(raw).items()}
    except (ValueError, TypeError, AttributeError):
        logger.warning("unparseable %s=%r; ignoring",
                       env_mod.HOROVOD_RELAY_ADDRS, raw)
        return {}


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

class RelayInfo:
    __slots__ = ("id", "level", "parent", "child_relays", "leaf_lo",
                 "leaf_hi")

    def __init__(self, rid, level, leaf_lo, leaf_hi):
        self.id = rid
        self.level = level
        self.parent: Optional[int] = None   # relay id; None = root
        self.child_relays: List[int] = []
        self.leaf_lo = leaf_lo   # leaf span [lo, hi) this subtree covers
        self.leaf_hi = leaf_hi

    @property
    def depth_below(self) -> int:
        """Relay hops from this node down to its leaves, counting the
        leaf link (level-0 relay -> 1)."""
        return self.level + 1

    @property
    def host_rank(self) -> int:
        """The worker rank that hosts this relay in launcher runs:
        the lowest rank of its span at every level (so one process
        hosts its whole ancestor column and parents come up with it)."""
        return self.leaf_lo


class TreePlan:
    """The deterministic relay tree for (size, fanout): every rank of
    1..size-1 is the direct child of exactly one level-0 relay; relays
    group under higher-level relays until <= fanout of them (plus rank
    0's direct link) reach the root."""

    def __init__(self, size: int, fanout: int):
        assert fanout > 0 and size - 1 > fanout
        self.size = size
        self.fanout = fanout
        self.relays: Dict[int, RelayInfo] = {}
        self._leaf_parent: Dict[int, int] = {}
        next_id = 0
        level_nodes: List[int] = []
        # Level 0: leaves 1..size-1 chunked by fanout.
        for lo in range(1, size, fanout):
            hi = min(size, lo + fanout)
            info = RelayInfo(next_id, 0, lo, hi)
            self.relays[next_id] = info
            for r in range(lo, hi):
                self._leaf_parent[r] = next_id
            level_nodes.append(next_id)
            next_id += 1
        # Higher levels until the top fits the root's fanout budget.
        level = 0
        while len(level_nodes) > fanout:
            level += 1
            parents: List[int] = []
            for i in range(0, len(level_nodes), fanout):
                chunk = level_nodes[i:i + fanout]
                info = RelayInfo(next_id, level,
                                 self.relays[chunk[0]].leaf_lo,
                                 self.relays[chunk[-1]].leaf_hi)
                info.child_relays = list(chunk)
                for c in chunk:
                    self.relays[c].parent = next_id
                self.relays[next_id] = info
                parents.append(next_id)
                next_id += 1
            level_nodes = parents
        self.root_relays: List[int] = list(level_nodes)
        self.levels = level + 1

    def leaf_parent(self, rank: int) -> Optional[int]:
        """Relay serving ``rank`` (None = direct root link; rank 0 is
        always direct)."""
        return self._leaf_parent.get(rank)

    def relay_ancestors(self, rid: int) -> List[int]:
        out = []
        cur = self.relays[rid].parent
        while cur is not None:
            out.append(cur)
            cur = self.relays[cur].parent
        return out

    def ancestors_of_leaf(self, rank: int) -> List[int]:
        """Relay chain from ``rank`` up to (excluding) the root,
        nearest first; [] for direct ranks."""
        rid = self.leaf_parent(rank)
        if rid is None:
            return []
        return [rid] + self.relay_ancestors(rid)

    def leaf_hops(self, rank: int) -> int:
        return len(self.ancestors_of_leaf(rank))

    def relays_hosted_by(self, rank: int) -> List[int]:
        """Relay ids this worker rank hosts in launcher runs, highest
        level first (parents must be up before children connect)."""
        out = [rid for rid, info in self.relays.items()
               if info.host_rank == rank]
        return sorted(out, key=lambda rid: -self.relays[rid].level)

    def to_meta(self) -> dict:
        return {"size": self.size, "fanout": self.fanout,
                "relays": len(self.relays), "levels": self.levels,
                "root_links": len(self.root_relays) + 1}


def plan_tree(size: int, fanout: int) -> Optional[TreePlan]:
    """The tree for (size, fanout); None when the flat star is the
    right topology (fanout off, or every rank fits the root's budget
    directly)."""
    if fanout <= 0 or size - 1 <= fanout:
        return None
    return TreePlan(size, fanout)


# ---------------------------------------------------------------------------
# lazy deadline heap (the O(due) liveness sweep)
# ---------------------------------------------------------------------------

class DeadlineHeap:
    """Min-heap of (deadline, key) with lazy revalidation: traffic on
    a link only updates its last-heard timestamp (O(1) dict store, no
    heap op); the sweep pops entries whose *recorded* deadline lapsed
    and re-schedules the ones whose true deadline moved.  A sweep tick
    therefore visits O(entries due) links, not O(world) — each live
    link costs one pop+push per timeout window, amortized, instead of
    one visit per tick."""

    def __init__(self):
        # Entries are (deadline, seq, key): the monotonic seq breaks
        # deadline ties so heapq never compares the keys themselves
        # (they are deliberately heterogeneous — ints, tuples, link
        # tokens — and unorderable).
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = 0
        self.visits = 0   # popped entries, read by the perf pin test

    def __len__(self):
        return len(self._heap)

    def schedule(self, key, deadline: float):
        self._seq += 1
        heapq.heappush(self._heap, (deadline, self._seq, key))

    def due(self, now: float, deadline_fn) -> List[object]:
        """Pop lapsed entries; ``deadline_fn(key)`` returns the key's
        CURRENT true deadline or None (key no longer tracked).  Keys
        whose true deadline also lapsed are returned (and dropped —
        the caller re-schedules survivors it keeps); refreshed keys
        are re-pushed at their true deadline."""
        out = []
        while self._heap and self._heap[0][0] <= now:
            _, _, key = heapq.heappop(self._heap)
            self.visits += 1
            _SWEEP_VISITS.inc()
            true = deadline_fn(key)
            if true is None:
                continue
            if true <= now:
                out.append(key)
            else:
                self._seq += 1
                heapq.heappush(self._heap, (true, self._seq, key))
        return out


# ---------------------------------------------------------------------------
# RB / RD frame packing (relay links only)
# ---------------------------------------------------------------------------

_ITEM_HEAD = struct.Struct("<iQ2sI")   # origin, epoch, magic, len
_RD_HEAD = struct.Struct("<i2sI")      # target, magic, len


def child_epoch_value(relay_id: int, counter: int) -> int:
    """Wire epoch for a relay's Nth connection from a child: the
    assigning relay's id rides the high bits, so epochs are globally
    unique ACROSS relays — a leaf that re-homes from relay A to relay
    B (same top-level link from the root's view) can never collide
    with stale epoch-counter values still in flight from A."""
    return ((relay_id & 0x7FFFFFFF) << 32) | (counter & 0xFFFFFFFF)


def pack_rb_items(items) -> bytes:
    """items: [(origin_rank, epoch, magic, payload)].  The epoch is
    the direct parent's per-child connection counter composited with
    its relay id (child_epoch_value): the root discards stream items
    whose epoch does not match the rank's current attachment, so
    frames in flight from a superseded child socket — even one on a
    DIFFERENT relay after an intra-subtree re-home — can never be
    double-counted against the resume cursor."""
    parts = [struct.pack("<I", len(items))]
    for origin, epoch, magic, payload in items:
        parts.append(_ITEM_HEAD.pack(origin, epoch, magic,
                                     len(payload)))
        parts.append(payload)
    return b"".join(parts)


def unpack_rb_items(buf: bytes) -> List[Tuple[int, int, bytes, bytes]]:
    (count,) = struct.unpack_from("<I", buf, 0)
    off = 4
    items = []
    for _ in range(count):
        origin, epoch, magic, ln = _ITEM_HEAD.unpack_from(buf, off)
        off += _ITEM_HEAD.size
        items.append((origin, epoch, magic, buf[off:off + ln]))
        off += ln
    return items


def pack_rd(target: int, magic: bytes, payload: bytes) -> bytes:
    return _RD_HEAD.pack(target, magic, len(payload)) + payload


def unpack_rd(buf: bytes) -> Tuple[int, bytes, bytes]:
    target, magic, ln = _RD_HEAD.unpack_from(buf, 0)
    off = _RD_HEAD.size
    return target, magic, buf[off:off + ln]


# ---------------------------------------------------------------------------
# selector-based frame mux (the root's batched recv loop + relays)
# ---------------------------------------------------------------------------

_MAX_FRAME = 512 << 20   # frame-length sanity bound per link


class FrameMux:
    """One thread draining frames from many BLOCKING sockets via a
    selector: select() gates readability, each readiness event costs
    exactly one recv() (which cannot block on a readable socket), and
    per-link buffers re-assemble length-prefixed frames.  Replaces
    thread-per-link on the root/relays, where the link count is what
    the tree bounds.  Sends stay plain blocking sendall from caller
    threads, same as the thread-per-link model."""

    def __init__(self, on_frame, on_close, name="hvd-mux",
                 on_data=None):
        # on_frame(token, magic, payload) -> False to close the link;
        # on_close(token) fires exactly once per removed link;
        # on_data(token) fires on every received chunk (liveness
        # refresh for large frames trickling in slower than a frame).
        self._on_frame = on_frame
        self._on_close = on_close
        self._on_data = on_data
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._pending: deque = deque()   # ("add", token, sock) | ("close", token)
        self._links: Dict[object, Tuple[socket.socket, bytearray]] = {}
        self._lock = threading.Lock()
        self._stop_flag = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)

    def start(self):
        self._thread.start()

    def add(self, token, sock: socket.socket):
        with self._lock:
            self._pending.append(("add", token, sock))
        self._wake()

    def close_link(self, token):
        with self._lock:
            self._pending.append(("close", token, None))
        self._wake()

    def stop(self):
        self._stop_flag.set()
        self._wake()
        self._thread.join(timeout=5.0)

    def _wake(self):
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _drain_pending_locked(self):
        while self._pending:
            op, token, sock = self._pending.popleft()
            if op == "add":
                self._links[token] = (sock, bytearray())
                try:
                    # The socket may have been closed by a racing
                    # teardown before we got to register it.
                    # hvdlint: bounded-by(selector-registered link:
                    # recv only fires on EVENT_READ, select polls 0.2s)
                    sock.settimeout(None)
                    self._sel.register(sock, selectors.EVENT_READ,
                                       token)
                except (KeyError, ValueError, OSError):
                    self._links.pop(token, None)
                    self._on_close(token)
            else:
                self._drop(token)

    def _drop(self, token):
        ent = self._links.pop(token, None)
        if ent is None:
            return
        sock, _ = ent
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        try:
            sock.close()
        except OSError:
            pass
        self._on_close(token)

    def _run(self):
        while not self._stop_flag.is_set():
            with self._lock:
                self._drain_pending_locked()
            events = self._sel.select(timeout=0.2)
            for key, _ in events:
                if key.data is None:   # wakeup pipe
                    try:
                        # hvdlint: bounded-by(EVENT_READ-gated: data
                        # is already waiting when select returns)
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                    continue
                token = key.data
                ent = self._links.get(token)
                if ent is None:
                    continue
                sock, buf = ent
                try:
                    # hvdlint: bounded-by(EVENT_READ-gated: data is
                    # already waiting when select returns)
                    chunk = sock.recv(262144)
                except OSError:
                    chunk = b""
                if not chunk:
                    self._drop(token)
                    continue
                if self._on_data is not None:
                    self._on_data(token)
                buf.extend(chunk)
                if not self._parse(token, buf):
                    self._drop(token)
        # teardown: close everything without firing callbacks twice
        with self._lock:
            self._drain_pending_locked()
        for token in list(self._links):
            self._drop(token)
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _parse(self, token, buf: bytearray) -> bool:
        while len(buf) >= 6:
            magic = bytes(buf[:2])
            (ln,) = struct.unpack_from("<I", buf, 2)
            if ln > _MAX_FRAME:
                logger.error("oversized frame (%d bytes) on %r; "
                             "dropping the link", ln, token)
                return False
            if len(buf) < 6 + ln:
                return True
            payload = bytes(buf[6:6 + ln])
            del buf[:6 + ln]
            try:
                keep = self._on_frame(token, magic, payload)
            except Exception:
                logger.exception("frame handler failed on %r", token)
                return False
            if keep is False:
                return False
        return True


# ---------------------------------------------------------------------------
# the relay server
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, magic: bytes, payload: bytes):
    """THE length-prefixed wire framing primitive (both hops of the
    tree and the flat star share it; controller_net aliases it)."""
    sock.sendall(magic + struct.pack("<I", len(payload)) + payload)


def recv_frame(sock: socket.socket):
    """Blocking counterpart of send_frame; None on EOF."""
    def recv_exact(n):
        b = b""
        while len(b) < n:
            # hvdlint: bounded-by(callers arm settimeout — accept
            # loops the registration timeout, recv loops the liveness
            # poll period; socket.timeout propagates to them)
            chunk = sock.recv(n - len(b))
            if not chunk:
                return None
            b += chunk
        return b
    head = recv_exact(6)
    if head is None:
        return None
    magic, ln = head[:2], struct.unpack("<I", head[2:])[0]
    payload = recv_exact(ln)
    if payload is None:
        return None
    return magic, payload


class _ChildToken:
    __slots__ = ("kind", "ident", "epoch", "sock", "clean")

    def __init__(self, kind, ident, epoch, sock):
        self.kind = kind      # "leaf" | "relay"
        self.ident = ident    # rank | relay id
        self.epoch = epoch
        self.sock = sock
        self.clean = False

    def __repr__(self):
        return "<%s %s e%d>" % (self.kind, self.ident, self.epoch)


class RelayServer:
    """A stateless interior node of the relay tree (module docstring).
    Fail-stop by design: any parent-link death or internal error shuts
    the relay down, closing every child socket so the children re-home
    through their ancestor chain — the relay holds no stream state
    worth saving."""

    def __init__(self, relay_id: int, parent_addrs: List[str],
                 bind_addr: str = "127.0.0.1", port: int = 0,
                 liveness_interval_s: float = 0.0,
                 liveness_timeout_s: float = 0.0,
                 registration_timeout_s: float = 30.0,
                 depth_below: int = 1):
        self.relay_id = relay_id
        self.depth_below = depth_below
        self._parent_addrs = list(parent_addrs)
        self.liveness_interval_s = liveness_interval_s
        self.liveness_timeout_s = liveness_timeout_s or \
            2.0 * liveness_interval_s
        self.registration_timeout_s = registration_timeout_s
        self._stop = threading.Event()
        self._wedged = False
        self._lock = threading.Lock()          # children/routes/queue
        self._send_lock = threading.Lock()     # parent uplink socket
        self._children: Dict[object, _ChildToken] = {}
        self._eligible: set = set()            # tokens past their WE ack
        self._route: Dict[int, _ChildToken] = {}   # leaf rank -> child
        self._child_epoch: Dict[int, int] = {}     # per-rank conn counter
        self._last_heard: Dict[object, float] = {}
        self._lheap = DeadlineHeap()
        self._up_q: deque = deque()   # ("item", (o,e,m,p)) | ("raw", m, p)
        self._up_ev = threading.Event()
        self._last_uplink_t = time.monotonic()
        self._mr_pending: Dict[object, Tuple[List[int], dict]] = {}
        # --- parent link (connect BEFORE accepting children, so a
        # child registration always has somewhere to go) ---
        self._parent = self._connect_parent()
        # --- child listener ---
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind_addr, port))
        self._srv.listen(128)
        self.port = self._srv.getsockname()[1]
        self._mux = FrameMux(self._on_child_frame, self._on_child_close,
                             name="hvd-relay%d-mux" % relay_id)
        self._mux.start()
        self._threads = []
        for target, name in (
                (self._accept_loop, "accept"),
                (self._parent_recv_loop, "parent"),
                (self._uplink_loop, "uplink")):
            t = threading.Thread(target=target, daemon=True,
                                 name="hvd-relay%d-%s" % (relay_id,
                                                          name))
            t.start()
            self._threads.append(t)
        if self.liveness_interval_s > 0:
            t = threading.Thread(target=self._liveness_loop,
                                 daemon=True,
                                 name="hvd-relay%d-liveness" % relay_id)
            t.start()
            self._threads.append(t)
        logger.info("relay %d up on port %d (depth_below=%d, parent "
                    "chain %s)", relay_id, self.port, depth_below,
                    self._parent_addrs)

    # ------------------------------------------------------------------
    # parent link
    # ------------------------------------------------------------------
    def _connect_parent(self) -> socket.socket:
        deadline = time.monotonic() + env_mod.start_timeout()
        last_err = None
        while time.monotonic() < deadline:
            for addr in self._parent_addrs:
                host, port = addr.rsplit(":", 1)
                try:
                    s = socket.create_connection((host, int(port)),
                                                 timeout=5.0)
                except OSError as e:
                    last_err = e
                    continue
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                reg = struct.pack("<i", relay_reg_rank(self.relay_id))
                reg += json.dumps({"relay": self.relay_id,
                                   "depth_below": self.depth_below
                                   }).encode()
                try:
                    send_frame(s, b"RQ", reg)
                except OSError as e:
                    last_err = e
                    s.close()
                    continue
                return s
            time.sleep(0.2)
        raise ConnectionError(
            "relay %d could not reach a parent in %s: %s"
            % (self.relay_id, self._parent_addrs, last_err))

    def _parent_recv_loop(self):
        sock = self._parent
        if self.liveness_interval_s > 0:
            sock.settimeout(max(self.liveness_timeout_s / 4.0, 0.05))
        try:
            while not self._stop.is_set():
                try:
                    frame = recv_frame(sock)
                except socket.timeout:
                    continue
                except OSError:
                    frame = None
                if frame is None:
                    break
                if self._wedged:
                    # SIGSTOP analog for drills: hold everything.
                    while self._wedged and not self._stop.is_set():
                        time.sleep(0.02)
                magic, payload = frame
                _RELAY_FRAMES.inc(1, dir="down")
                if _fr.ENABLED and magic == b"HB":
                    # Downlink HB arrival: one half of the HB round
                    # trip blackbox_merge aligns this relay's clock by.
                    _fr.record(_fr.HB_RX,
                               rank="relay%d" % self.relay_id,
                               role="relay")
                if magic == MAGIC_RELAY_DOWN:
                    self._route_down(payload)
                    continue
                if magic == b"MQ":
                    # Metrics poll generation boundary: whatever the
                    # previous poll accumulated goes up now, so a slow
                    # child can delay but never wedge aggregation.
                    self._flush_metrics_agg()
                self._broadcast_children(magic, payload)
        finally:
            # Fail-stop: parent gone (or shutdown) -> the subtree must
            # re-home; closing every child socket is the signal.
            self.shutdown()

    def _route_down(self, payload: bytes):
        target, magic, inner = unpack_rd(payload)
        with self._lock:
            token = self._route.get(target)
            if token is not None and token.kind == "leaf":
                # First RD for a child is always the root's WE ack: it
                # opens the broadcast gate (broadcasts the root sent
                # BEFORE it registered this rank were never logged in
                # its out-log, so delivering them would desync the
                # resume cursor).
                self._eligible.add(token)
        if token is None:
            logger.warning("relay %d: no route for targeted %s frame "
                           "to rank %d", self.relay_id,
                           magic.decode("ascii", "replace"), target)
            return
        try:
            if token.kind == "leaf":
                send_frame(token.sock, magic, inner)
            else:
                send_frame(token.sock, MAGIC_RELAY_DOWN, payload)
        except OSError:
            pass   # child death is handled by the mux EOF path

    def _broadcast_children(self, magic: bytes, payload: bytes):
        with self._lock:
            targets = [t for t in self._children.values()
                       if t.kind == "relay" or t in self._eligible]
        for token in targets:
            try:
                send_frame(token.sock, magic, payload)
            except OSError:
                pass

    # ------------------------------------------------------------------
    # children
    # ------------------------------------------------------------------
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
            conn.settimeout(self.registration_timeout_s)
            try:
                frame = recv_frame(conn)
            except (socket.timeout, OSError):
                conn.close()
                continue
            if frame is None:
                conn.close()
                continue
            magic, payload = frame
            if magic != b"RQ" or len(payload) < 4:
                # Garbage first frame (port scanner, misdirected
                # peer, wrong kind): drop the connection, never the
                # accept loop — registration is always an RQ frame.
                conn.close()
                continue
            rank = struct.unpack("<i", payload[:4])[0]
            # hvdlint: bounded-by(registered child moves onto the
            # selector mux below; select polls at 0.2s)
            conn.settimeout(None)
            if is_relay_reg(rank):
                token = _ChildToken("relay", relay_id_from_reg(rank),
                                    0, conn)
                with self._lock:
                    self._children[token] = token
                    self._last_heard[token] = time.monotonic()
                    self._schedule_child_locked(token)
                self._mux.add(token, conn)
                continue
            with self._lock:
                counter = self._child_epoch.get(rank, 0) + 1
                self._child_epoch[rank] = counter
                epoch = child_epoch_value(self.relay_id, counter)
                token = _ChildToken("leaf", rank, epoch, conn)
                old = self._route.get(rank)
                self._children[token] = token
                self._route[rank] = token
                self._last_heard[token] = time.monotonic()
                self._schedule_child_locked(token)
            if _fr.ENABLED:
                # Child attach + epoch bump: a postmortem can prove
                # which connection epoch a frame in flight belonged to.
                _fr.record(_fr.RELAY_ATTACH,
                           rank="relay%d" % self.relay_id,
                           role="relay", peer=rank, cyc=epoch,
                           superseded=old is not None)
            if old is not None and old.kind == "leaf":
                # Supersede only a stale connection of the SAME leaf.
                # A relay-kind route token means the rank used to be
                # reachable through a (healthy) sub-relay — closing
                # that link would fail-stop its whole subtree; the
                # route replacement above is all that's needed.
                self._mux.close_link(old)
            # Forward the registration (fresh or resume) up; the root
            # answers with a targeted RD(WE) that opens this child's
            # broadcast gate.
            self._enqueue_item(rank, epoch, MAGIC_REGISTER, payload)
            self._mux.add(token, conn)

    def _schedule_child_locked(self, token):
        if self.liveness_interval_s > 0:
            self._lheap.schedule(token, time.monotonic() +
                                 self._child_deadline(token))

    def _child_deadline(self, token) -> float:
        if token.kind == "leaf":
            return self.liveness_timeout_s
        return env_mod.depth_aware_liveness_timeout(
            self.liveness_timeout_s, max(1, self.depth_below - 1))

    def _on_child_frame(self, token, magic: bytes, payload: bytes):
        if self._stop.is_set():
            return False
        self._last_heard[token] = time.monotonic()
        if self._wedged:
            while self._wedged and not self._stop.is_set():
                time.sleep(0.02)
        _RELAY_FRAMES.inc(1, dir="up")
        if token.kind == "relay":
            if magic == MAGIC_RELAY_BATCH:
                # Learn routes from the item origins, then forward the
                # original bytes verbatim (no re-pack).
                try:
                    items = unpack_rb_items(payload)
                except (struct.error, IndexError):
                    logger.error("relay %d: corrupt RB from %r",
                                 self.relay_id, token)
                    return False
                with self._lock:
                    for origin, _, _, _ in items:
                        self._route[origin] = token
                self._enqueue_raw(magic, payload)
                return True
            if magic == b"HB":
                if _fr.ENABLED:
                    _fr.record(_fr.HB_RX,
                               rank="relay%d" % self.relay_id,
                               role="relay", relay=token.ident)
                return True   # sub-relay liveness only
            if magic in (MAGIC_METRICS_AGG,):
                self._note_metrics(token, payload)
                return True
            if magic == MAGIC_RELAY_LOST:
                self._enqueue_raw(magic, payload)
                return True
            logger.warning("relay %d: unexpected %s frame from %r",
                           self.relay_id,
                           magic.decode("ascii", "replace"), token)
            return True
        # leaf child
        if magic == b"HB":
            if _fr.ENABLED:
                _fr.record(_fr.HB_RX, rank="relay%d" % self.relay_id,
                           role="relay", peer=token.ident)
            return True    # consumed: one relay HB stands in for all
        if magic == b"MR":
            self._note_metrics(token, payload)
            return True
        self._enqueue_item(token.ident, token.epoch, magic, payload)
        return True

    def _on_child_close(self, token):
        with self._lock:
            if self._children.pop(token, None) is None:
                return   # superseded/already handled
            self._eligible.discard(token)
            self._last_heard.pop(token, None)
            self._mr_pending.pop(token, None)
            lost = self._routed_ranks_locked(token)
            for r, _ in lost:
                if self._route.get(r) is token:
                    self._route.pop(r, None)
        if _fr.ENABLED and not self._stop.is_set() and \
                token.kind == "relay":
            # An interior sub-relay's link died: this parent is the
            # only witness that can NAME it — the root's RL notice
            # carries the reporter's id, not the dead hop's.
            _fr.record(_fr.RELAY_DOWN,
                       rank="relay%d" % self.relay_id, role="relay",
                       relay=token.ident,
                       reason="child relay link closed at relay %d"
                              % self.relay_id)
        if self._stop.is_set() or not lost:
            return
        self._report_lost(lost, "disconnect",
                          "child link closed at relay %d"
                          % self.relay_id)

    def _routed_ranks_locked(self, token) -> List[tuple]:
        """(rank, epoch) pairs this child link covers.  Direct leaf
        children carry their connection epoch (the root can prove the
        notice refers to the CURRENT attachment); ranks routed through
        a sub-relay carry None — the root then arms a suspicion clock
        instead of detaching (see controller_net._handle_relay_lost)."""
        if token.kind == "leaf":
            return [(token.ident, token.epoch)]
        return [(r, None) for r, t in self._route.items()
                if t is token]

    def _report_lost(self, ranks: List[tuple], kind: str, reason: str):
        _CHILD_LOST.inc(len(ranks), kind=kind)
        if _fr.ENABLED:
            _fr.record(_fr.RELAY_LOST,
                       rank="relay%d" % self.relay_id, role="relay",
                       lost_kind=kind, reason=reason,
                       ranks=[r for r, _ in ranks])
        self._enqueue_raw(MAGIC_RELAY_LOST, json.dumps(
            {"ranks": ranks, "kind": kind, "reason": reason}).encode())

    # ------------------------------------------------------------------
    # uplink batching
    # ------------------------------------------------------------------
    def _enqueue_item(self, origin, epoch, magic, payload):
        with self._lock:
            self._up_q.append(("item", (origin, epoch, magic, payload)))
        self._up_ev.set()

    def _enqueue_raw(self, magic, payload):
        with self._lock:
            self._up_q.append(("raw", magic, payload))
        self._up_ev.set()

    def _uplink_loop(self):
        """Drain-all-pending batching (as request coalescing does):
        whatever accumulated while the previous send was on the wire
        goes up as ONE RB frame — batching under load, zero added
        latency when idle."""
        while not self._stop.is_set():
            if not self._up_ev.wait(timeout=0.5):
                continue
            self._up_ev.clear()
            while True:
                with self._lock:
                    if not self._up_q:
                        break
                    batch: List[tuple] = []
                    raw = None
                    while self._up_q:
                        entry = self._up_q[0]
                        if entry[0] == "item":
                            self._up_q.popleft()
                            batch.append(entry[1])
                        else:
                            if batch:
                                break
                            raw = self._up_q.popleft()
                            break
                if self._wedged:
                    while self._wedged and not self._stop.is_set():
                        time.sleep(0.02)
                try:
                    with self._send_lock:
                        self._last_uplink_t = time.monotonic()
                        if batch:
                            _UPLINK_ITEMS.observe(len(batch))
                            send_frame(self._parent, MAGIC_RELAY_BATCH,
                                        pack_rb_items(batch))
                        elif raw is not None:
                            send_frame(self._parent, raw[1], raw[2])
                except OSError:
                    self.shutdown()
                    return

    # ------------------------------------------------------------------
    # liveness + heartbeats
    # ------------------------------------------------------------------
    def _liveness_loop(self):
        period = max(self.liveness_interval_s / 2.0, 0.05)
        while not self._stop.wait(period):
            if self._wedged:
                continue
            now = time.monotonic()
            # Relay HB up (suppressed while real uplink flows).
            if now - self._last_uplink_t >= self.liveness_interval_s:
                try:
                    with self._send_lock:
                        self._last_uplink_t = now
                        send_frame(self._parent, b"HB", b"")
                    if _fr.ENABLED:
                        # Uplink HB departure: the other half of the
                        # clock-alignment round trip.
                        _fr.record(_fr.FRAME_TX,
                                   rank="relay%d" % self.relay_id,
                                   role="relay", frame="HB", nbytes=6)
                except OSError:
                    self.shutdown()
                    return
            with self._lock:
                due = self._lheap.due(now, self._deadline_for_locked)
                silent = [(t, self._routed_ranks_locked(t))
                          for t in due]
            for token, ranks in silent:
                logger.warning(
                    "relay %d: child %r silent past %.1fs; reporting "
                    "lost", self.relay_id, token,
                    self._child_deadline(token))
                if _fr.ENABLED and token.kind == "relay":
                    # A WEDGED sub-relay never says its own last word;
                    # the per-hop deadline here is the only evidence
                    # that names it.
                    _fr.record(_fr.RELAY_DOWN,
                               rank="relay%d" % self.relay_id,
                               role="relay", relay=token.ident,
                               reason="silent past the per-hop "
                                      "deadline at relay %d"
                                      % self.relay_id)
                if ranks:
                    self._report_lost(
                        ranks, "silent",
                        "silent past the per-hop deadline at relay %d"
                        % self.relay_id)
                self._mux.close_link(token)

    def _deadline_for_locked(self, token):
        if token not in self._children:
            return None
        heard = self._last_heard.get(token)
        if heard is None:
            return None
        return heard + self._child_deadline(token)

    # ------------------------------------------------------------------
    # metrics aggregation (MR -> MA)
    # ------------------------------------------------------------------
    def _note_metrics(self, token, payload: bytes):
        try:
            snap = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return
        if token.kind == "leaf":
            entry = ([token.ident], snap)
        else:
            entry = (list(snap.get("ranks", [])),
                     snap.get("snapshot") or {})
        with self._lock:
            self._mr_pending[token] = entry
            live = set(self._children.values())
            complete = live and live.issubset(set(self._mr_pending))
        if complete:
            self._flush_metrics_agg()

    def _flush_metrics_agg(self):
        with self._lock:
            if not self._mr_pending:
                return
            pending, self._mr_pending = self._mr_pending, {}
        ranks: List[int] = []
        snaps = []
        for rlist, snap in pending.values():
            ranks.extend(rlist)
            snaps.append(snap)
        merged = metrics.merge_snapshots(snaps)
        _AGG_SNAPSHOTS.inc()
        self._enqueue_raw(MAGIC_METRICS_AGG, json.dumps(
            {"ranks": sorted(ranks), "snapshot": merged}).encode())

    # ------------------------------------------------------------------
    # lifecycle + drill hooks
    # ------------------------------------------------------------------
    def shutdown(self):
        if self._stop.is_set():
            return
        self._stop.set()
        if _fr.ENABLED:
            # Fail-stop: the relay's own last word in a postmortem.
            _fr.record(_fr.RELAY_DOWN,
                       rank="relay%d" % self.relay_id, role="relay",
                       relay=self.relay_id,
                       reason="fail-stop shutdown")
        self._up_ev.set()
        for s in (self._srv, self._parent):
            try:
                s.close()
            except OSError:
                pass
        with self._lock:
            children = list(self._children.values())
        for token in children:
            try:
                token.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                token.sock.close()
            except OSError:
                pass
        self._mux.stop()

    # Drill hooks (tools/chaos_soak.py): deterministic in-process
    # analogs of a relay process death / SIGSTOP / uplink cable pull.
    def debug_kill(self):
        """Abrupt relay death: every socket dies at once, exactly what
        a SIGKILL'd relay process looks like to its peers."""
        self.shutdown()

    def debug_wedge(self, on: bool = True):
        """SIGSTOP analog: stop forwarding in both directions and stop
        heartbeating, keep every socket open — only liveness deadlines
        can expose it."""
        self._wedged = on

    def debug_sever_parent(self):
        """Pull the uplink cable: the relay notices the dead parent
        link and fail-stops, severing its children (who re-home)."""
        try:
            self._parent.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._parent.close()
        except OSError:
            pass
