"""Response cache: the negotiation fast path.

The analog of the reference response cache (reference: response_cache.{h,cc}:
ResponseCache :45-102 — cache keyed by tensor name, HIT only when
device/dtype/shape/scale all match, else INVALID → renegotiation; and
CacheCoordinator :107-169 — in the reference, workers exchange hit
bitvectors with one or two bitwise-AND allreduces instead of a full
negotiation round; fast path in controller.cc:81-236).

This build's control plane is a star (workers push to a rank-0
coordinator over TCP), so the fast path is framed differently but buys
the same thing — O(small-constant) control bytes per steady-state step
instead of O(tensors) full request/response payloads:

  * The COORDINATOR owns bit assignment.  When it broadcasts a newly
    negotiated Response it attaches a fresh ``cache_bits`` entry per
    tensor; every worker stores the per-tensor response under that bit.
    Because bits are assigned in exactly one place, workers never have
    to agree on LRU/eviction order (the subtle invariant the reference
    maintains with symmetric caches + bitvector sync).
  * Workers whose next request for a tensor matches the cached
    signature send a 4-byte bit (CH frame) instead of the full request.
  * When EVERY participating rank contributed via bit, the coordinator
    broadcasts a CB frame: fused batches of bits in execution order.
    Workers reconstruct the fused Response locally from their caches.
  * Any full request for a cached tensor (signature change) forces the
    coordinator to evict + renegotiate, and the re-broadcast re-seeds
    everyone — self-healing, no eviction consensus needed.  Workers
    never evict on their own: EV frames (coordinator capacity-LRU or
    invalidation) are the only way entries leave a worker cache, so
    worker caches always cover the coordinator's live bits.

On TPU the cache is *load-bearing*: a cache hit means the fused batch
signature is unchanged, so the compiled XLA executable for the batch is
reused without recompilation (SURVEY §7: response-cache hits map to
executable-cache hits).
"""
# hvdlint-module: hot-path (instrumentation must hide behind one attribute check — docs/static_analysis.md)

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from . import metrics
from .message import Request, RequestType, Response, ResponseType

_CACHE_EVENTS = metrics.counter(
    "hvd_response_cache_total",
    "Worker response-cache events (hit / miss / invalidate / evict); "
    "a hit also implies a compiled-executable reuse on TPU")

# Response types that participate in the cache (JOIN/BARRIER/ERROR are
# control-flow, never cached — reference response_cache.cc caches the
# data collectives only).  ALLTOALL is excluded since round 5: its
# response carries the send-split matrix, and splits may legally change
# call-to-call under an unchanged signature — a cached response would
# serve stale recv splits.  Full negotiation per alltoall is still one
# round cheaper than the pre-round-5 CH + data-plane split-allgather.
CACHEABLE = {ResponseType.ALLREDUCE, ResponseType.ADASUM,
             ResponseType.ALLGATHER, ResponseType.BROADCAST,
             ResponseType.REDUCESCATTER}

_RESP_TO_REQ = {
    ResponseType.ALLREDUCE: RequestType.ALLREDUCE,
    ResponseType.ALLGATHER: RequestType.ALLGATHER,
    ResponseType.BROADCAST: RequestType.BROADCAST,
    ResponseType.ADASUM: RequestType.ADASUM,
    ResponseType.ALLTOALL: RequestType.ALLTOALL,
    ResponseType.REDUCESCATTER: RequestType.REDUCESCATTER,
}


def request_signature(req: Request) -> tuple:
    """Everything that must be unchanged for a cached response to be
    valid for this rank (reference response_cache.cc:49-87 checks
    device/dtype/shape/prescale/postscale)."""
    return (tuple(req.tensor_shape), int(req.tensor_type), req.root_rank,
            req.prescale_factor, req.postscale_factor,
            req.process_set_id, req.reduce_op, int(req.request_type),
            tuple(req.process_set_ranks))


def signature_to_request(sig: tuple, rank: int, name: str,
                         first_dim: Optional[int] = None) -> Request:
    """Reconstruct a Request from a cached signature (coordinator side:
    used when a cache-bit contribution must be merged with full requests
    in a degraded round).  ``first_dim`` overrides shape[0] for ops with
    per-rank first dimensions (allgather)."""
    (shape, dtype, root, pre, post, psid, op, rtype, psr) = sig
    if first_dim is not None and shape:
        shape = (first_dim,) + tuple(shape[1:])
    return Request(request_rank=rank, request_type=RequestType(rtype),
                   tensor_name=name, tensor_shape=tuple(shape),
                   tensor_type=dtype, root_rank=root, prescale_factor=pre,
                   postscale_factor=post, process_set_id=psid,
                   reduce_op=op, process_set_ranks=tuple(psr))


def split_response(resp: Response, world_size: int) -> List[Response]:
    """Slice a (possibly fused) Response into per-tensor responses.

    For fused allgathers the tensor_sizes list is the concatenation of
    per-GROUP-rank row counts per tensor (group = process-set ranks
    when given, else the world; see fusion.py) — slice accordingly.
    """
    out = []
    per_sizes = 0
    group = len(resp.process_set_ranks) or world_size
    if resp.response_type == ResponseType.ALLGATHER and group > 0 \
            and len(resp.tensor_sizes) == group * len(resp.tensor_names):
        per_sizes = group
    for i, name in enumerate(resp.tensor_names):
        out.append(Response(
            response_type=resp.response_type,
            tensor_names=[name],
            tensor_type=resp.tensor_type,
            tensor_sizes=(resp.tensor_sizes[i * per_sizes:
                                            (i + 1) * per_sizes]
                          if per_sizes else list(resp.tensor_sizes)),
            prescale_factor=resp.prescale_factor,
            postscale_factor=resp.postscale_factor,
            process_set_id=resp.process_set_id,
            root_rank=resp.root_rank,
            reduce_op=resp.reduce_op,
            tensor_shapes=([resp.tensor_shapes[i]]
                           if i < len(resp.tensor_shapes) else []),
            process_set_ranks=resp.process_set_ranks,
        ))
    return out


def merge_responses(parts: List[Response]) -> Response:
    """Merge per-tensor cached responses into one fused Response —
    the worker-side inverse of the coordinator's fusion plan (must
    mirror fusion.py's concatenation order exactly)."""
    first = parts[0]
    merged = Response(
        response_type=first.response_type,
        tensor_names=[], tensor_type=first.tensor_type,
        tensor_sizes=[], prescale_factor=first.prescale_factor,
        postscale_factor=first.postscale_factor,
        process_set_id=first.process_set_id, root_rank=first.root_rank,
        reduce_op=first.reduce_op, tensor_shapes=[],
        process_set_ranks=first.process_set_ranks)
    for p in parts:
        merged.tensor_names.extend(p.tensor_names)
        merged.tensor_sizes.extend(p.tensor_sizes)
        merged.tensor_shapes.extend(p.tensor_shapes)
    return merged


class WorkerResponseCache:
    """Per-rank cache: name → (coordinator bit, per-tensor response,
    this rank's request signature).  Entries without a signature (this
    rank never submitted the tensor — e.g. non-members of a process set,
    joined ranks) still resolve CB bits but never produce hits.

    Workers NEVER evict on their own: eviction follows coordinator EV
    frames exclusively, so the worker's entry set is always a superset
    of the coordinator's live bits no matter how per-rank capacity
    knobs are (mis)configured — a CB frame can then never reference a
    bit the worker dropped unilaterally.  The coordinator's capacity
    bounds growth for everyone."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._lock = threading.Lock()
        # name -> [bit, response, sig-or-None]
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self._bit_names: Dict[int, str] = {}

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def lookup_bit(self, req: Request,
                   count_miss: bool = True) -> Optional[int]:
        """Bit for a HIT, else None.  A signature mismatch (INVALID)
        drops the local entry so the full request goes out and the
        coordinator renegotiates.  Entries are keyed by
        (process_set_id, name) — the same name may be cached for two
        process sets at once.

        ``count_miss=False`` suppresses the miss metric only: the
        inline fast-path probe passes it because a missed request
        falls back to the negotiation queue, where the cycle's own
        lookup counts the SAME logical miss — counting both would
        inflate misses ~2x.  Hits/invalidations happen exactly once
        (a hit short-circuits the second lookup; an invalidation
        deletes the entry) so they always count."""
        key = (req.process_set_id, req.tensor_name)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                if count_miss:
                    _CACHE_EVENTS.inc(1, event="miss")
                return None
            bit, _, sig = ent
            if sig is None or sig != request_signature(req):
                del self._entries[key]
                self._bit_names.pop(bit, None)
                _CACHE_EVENTS.inc(1, event="invalidate")
                return None
            _CACHE_EVENTS.inc(1, event="hit")
            return bit

    def insert(self, name: str, bit: int, response: Response,
               sig: Optional[tuple]):
        with self._lock:
            old = self._entries.pop(name, None)
            if old is not None:
                self._bit_names.pop(old[0], None)
            self._entries[name] = [bit, response, sig]
            self._bit_names[bit] = name

    def response_for_bit(self, bit: int) -> Optional[Response]:
        with self._lock:
            name = self._bit_names.get(bit)
            if name is None:
                return None
            return self._entries[name][1]

    def evict_bits(self, bits: List[int]):
        with self._lock:
            for b in bits:
                name = self._bit_names.pop(b, None)
                if name is not None:
                    self._entries.pop(name, None)
                    _CACHE_EVENTS.inc(1, event="evict")

    def debug_bits(self):
        """bit -> key snapshot for desync diagnostics."""
        with self._lock:
            return dict(sorted(self._bit_names.items()))

    def __len__(self):
        with self._lock:
            return len(self._entries)


class CoordinatorCache:
    """Rank-0 cache: authoritative bit assignment + enough signature
    state to synthesize a rank's request when a cache-bit contribution
    lands in a degraded (partially-uncached) round.

    Bits are monotonically increasing and never reused, so a late CH
    frame racing an eviction still resolves through the tombstone map
    (bounded FIFO; overflowing it would take ~64k evictions inside one
    round-trip window)."""

    TOMBSTONE_CAP = 65536

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        # name -> [bit, response(per-tensor), sig, group_id]
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self._bit_names: Dict[int, str] = {}
        # bit -> (name, sig, sizes, group_id) for recently evicted bits
        self._tombstones: "OrderedDict[int, tuple]" = OrderedDict()
        self._next_bit = 0
        self._disabled = False

    @property
    def enabled(self) -> bool:
        return self.capacity > 0 and not self._disabled

    def set_enabled(self, flag: bool) -> List[int]:
        """Runtime toggle (autotuner cache on/off).  Disabling evicts
        every live entry; the returned bits must be EV-broadcast so
        worker caches drain through the normal protocol."""
        evicted: List[int] = []
        if not flag and not self._disabled:
            for name in list(self._entries):
                bit = self.evict_name(name)
                if bit is not None:
                    evicted.append(bit)
        self._disabled = not flag
        return evicted

    def get(self, name: str) -> Optional[list]:
        return self._entries.get(name)

    def has(self, name: str) -> bool:
        return name in self._entries

    def resolve_bit(self, bit: int):
        """Returns (live, name, sig, sizes, group_id) or None.  ``live``
        False means the bit was evicted (tombstone): the contribution is
        honored but forces the full negotiation path."""
        name = self._bit_names.get(bit)
        if name is not None:
            # LRU: a bit contribution marks the tensor hot, so capacity
            # eviction prefers tensors no rank is actively using
            # (reference response_cache.h:45-102 LRU semantics).
            self._entries.move_to_end(name)
            ent = self._entries[name]
            return True, name, ent[2], ent[1].tensor_sizes, ent[3]
        tomb = self._tombstones.get(bit)
        if tomb is not None:
            return (False,) + tomb
        return None

    def insert(self, name: str, response: Response, sig: tuple,
               group_id: int, pending_names=()) -> Tuple[int, List[int]]:
        """Insert/replace; returns (bit, evicted_bits).  Capacity
        eviction skips tensors with an in-flight negotiation round
        (``pending_names``) so their bits stay resolvable."""
        evicted: List[int] = []
        old = self._entries.pop(name, None)
        if old is not None:
            self._tombstone(old[0], name, old[2],
                            old[1].tensor_sizes, old[3])
            self._bit_names.pop(old[0], None)
            evicted.append(old[0])
        while len(self._entries) >= self.capacity > 0:
            victim = None
            for cand in self._entries:
                if cand not in pending_names:
                    victim = cand
                    break
            if victim is None:
                break  # everything in flight; let the cache overgrow
            ent = self._entries.pop(victim)
            self._tombstone(ent[0], victim, ent[2],
                            ent[1].tensor_sizes, ent[3])
            self._bit_names.pop(ent[0], None)
            evicted.append(ent[0])
        bit = self._next_bit
        self._next_bit += 1
        self._entries[name] = [bit, response, sig, group_id]
        self._bit_names[bit] = name
        return bit, evicted

    def evict_name(self, name: str) -> Optional[int]:
        ent = self._entries.pop(name, None)
        if ent is None:
            return None
        bit, resp, sig, gid = ent
        self._tombstone(bit, name, sig, resp.tensor_sizes, gid)
        self._bit_names.pop(bit, None)
        return bit

    def _tombstone(self, bit, name, sig, sizes, gid):
        self._tombstones[bit] = (name, sig, sizes, gid)
        while len(self._tombstones) > self.TOMBSTONE_CAP:
            self._tombstones.popitem(last=False)

    def clear_tombstones_for(self, name: str):
        dead = [b for b, t in self._tombstones.items() if t[0] == name]
        for b in dead:
            del self._tombstones[b]

    def __len__(self):
        return len(self._entries)
