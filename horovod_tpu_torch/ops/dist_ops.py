"""Multi-process data plane over ``torch.distributed``.

Counterpart of :class:`horovod_tpu.ops.xla_ops.XlaMeshBackend` and
:class:`horovod_tpu.ops.ring_ops.RingBackend`: every rank executes the
identical fused batch the coordinator broadcast, as the same
``torch.distributed`` collectives in the same order.

* A fused allreduce is one :func:`fusion_buffer.pack` (prescale) into a
  persistent flat buffer, one ``all_reduce`` of that buffer and one
  :func:`fusion_buffer.unpack` (postscale; Average divides it by the
  group size, as ``ring_ops`` does).  Unsigned Min/Max and Product
  gather and then reduce, as ``xla_ops._reduce`` does.
* Hierarchical allreduce (``HOROVOD_HIERARCHICAL_ALLREDUCE`` with
  several ranks per host): reduce-scatter over the host's ranks,
  allreduce of the shards across hosts, allgather over the host.
* Allgather pads uneven first dimensions to the largest; broadcast
  packs its tensors into one buffer; alltoall takes the coordinator's
  split matrix when given; reducescatter gives the first ranks the
  remainder rows (``even_row_counts``).
* Process sets are subgroups made on first use by their members only
  (``use_local_synchronization=True``): non-members skip the response.

The device rule is decided once, at init (:func:`cuda_transport`, then
:func:`world_transport` across the ranks): CPU tensors always ride gloo;
CUDA tensors ride NCCL when every rank has a card of its own, and gloo
when ranks share a card, in which
case each packed buffer crosses to host memory and back once per
response (the reference's ``DoAllreduceCudaOnCPU``).  ``name`` is
``"nccl"`` or ``"gloo"`` accordingly; it labels the metrics.

Collectives run on the caller's current stream (the runtime's own
stream on CUDA) with ``async_op=True`` and ``work.wait()``, so the
unpack is ordered after the collective on the device, not on the host.
"""

import functools
import socket
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..common import metrics
from ..common.timeline import span
from . import fusion_buffer as fb
from .adasum import adasum_allreduce
from .backend import Backend, even_row_counts

_UNSIGNED = (torch.uint8, torch.uint16)
_DIST_OPS = {"Sum": dist.ReduceOp.SUM, "Average": dist.ReduceOp.SUM,
             "Min": dist.ReduceOp.MIN, "Max": dist.ReduceOp.MAX}


def cuda_transport(local_size: int) -> str:
    """The transport CUDA tensors take: ``"nccl"`` when each local rank
    has a card of its own, ``"gloo"`` when local ranks share one (NCCL
    refuses two ranks on one device) or there is no card."""
    if torch.cuda.is_available() and \
            local_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def card_identity(card: Optional[int]) -> str:
    """What names ``card`` across processes: its UUID where PyTorch
    reports one, else this host's name and the card's index."""
    if card is None:
        return "cpu"
    uuid = getattr(torch.cuda.get_device_properties(card), "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{socket.gethostname()}:{card}"


def world_transport(store, rank: int, size: int, proposal: str,
                    card: str) -> str:
    """The transport every rank takes, agreed through ``store`` before
    the process group exists: NCCL only when every rank proposed it and
    no two ranks hold the same card.  Two host names of one machine
    (``localhost`` and ``127.0.0.1``) each count their own local ranks,
    so ``cuda_transport`` alone can propose NCCL for ranks that share a
    card; one rank on gloo beside others on NCCL would hang the first
    CUDA collective."""
    store.set(f"hvd_transport/{rank}", f"{proposal}|{card}")
    keys = [f"hvd_transport/{r}" for r in range(size)]
    store.wait(keys)
    seen = [store.get(k).decode().split("|", 1) for k in keys]
    cards = [c for _, c in seen]
    if all(t == "nccl" for t, _ in seen) and len(set(cards)) == size:
        return "nccl"
    return "gloo"


def process_group_backend(transport: str) -> str:
    """The ``init_process_group`` backend string: one group that serves
    CPU tensors over gloo and CUDA tensors over ``transport``."""
    return f"cpu:gloo,cuda:{transport}"


def _timed(op: str, nbytes_fn):
    """Records count, payload bytes and host seconds of a collective
    under this backend's name (host seconds: on CUDA the call returns
    once the work is enqueued), and the program span ``<backend>.<op>``
    (``nccl.allreduce``)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            with span(f"{self.name}.{op.lower()}"):
                result = fn(self, *args, **kwargs)
            metrics.record_collective(self.name, op,
                                      int(nbytes_fn(*args, **kwargs)),
                                      time.perf_counter() - t0)
            return result
        return wrapper
    return deco


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _by_device(arrays: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``arrays`` grouped by device, in first-seen order (a
    fused response may mix a CPU and a CUDA tensor of one dtype)."""
    groups = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.device, []).append(i)
    return list(groups.values())


class TorchDistBackend(Backend):
    """``state`` carries ``rank_info`` and ``knobs``; the default
    process group must already be initialized with
    :func:`process_group_backend` of ``transport``."""

    def __init__(self, state, transport: str):
        if transport not in ("nccl", "gloo"):
            raise ValueError(f"unknown transport {transport!r}")
        self.state = state
        self.name = transport
        ri = state.rank_info
        self.size = ri.size
        self.rank = ri.rank
        self.buffers = fb.FusionBuffers()
        self._groups = {}
        self.stats = {"flat_allreduces": 0, "hierarchical_allreduces": 0,
                      "allreduce_bytes": 0}
        # The two-level layout of HOROVOD_HIERARCHICAL_ALLREDUCE: several
        # ranks per host, hosts in rank order (xla_ops' ``proc`` topology).
        self._hier = (ri.local_size > 1 and
                      ri.size == ri.cross_size * ri.local_size and
                      ri.rank == ri.cross_rank * ri.local_size + ri.local_rank)

    # ------------------------------------------------------------------
    # groups and transport
    # ------------------------------------------------------------------
    def world_size(self, ps_ranks=()) -> int:
        return len(ps_ranks) if ps_ranks else self.size

    def _subgroup(self, ranks: Tuple[int, ...]):
        """The cached subgroup of ``ranks``, made on first use by its
        members only."""
        g = self._groups.get(ranks)
        if g is None:
            g = dist.new_group(list(ranks), use_local_synchronization=True)
            self._groups[ranks] = g
        return g

    def _group(self, ps_ranks) -> Tuple[object, List[int]]:
        """(group, member ranks) of a process set; None is the world."""
        if not ps_ranks:
            return None, list(range(self.size))
        ranks = tuple(ps_ranks)
        return self._subgroup(ranks), list(ranks)

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.name == "gloo"

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        # gloo has no uint16 type; its data movement and its sums are
        # the same bits as int16's.
        return t.view(torch.int16) if t.dtype == torch.uint16 else t

    def _run(self, fn, src: torch.Tensor, dst: torch.Tensor = None):
        """``fn(src, dst)`` on the wire; ``dst`` None means in place.
        A CUDA tensor over gloo crosses to host memory and back once."""
        if not self._staged(src):
            fn(self._wire(src), self._wire(src if dst is None else dst))
            return
        host = self.buffers.get("cpu", src.dtype, src.numel(), pin=True)
        host = host.view(src.shape)
        host.copy_(src)
        if dst is None:
            fn(self._wire(host), self._wire(host))
            src.copy_(host)
        else:
            out = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
            fn(self._wire(host), self._wire(out))
            dst.copy_(out)

    @staticmethod
    def _all_reduce(op, group):
        def fn(src, dst):
            dist.all_reduce(dst, op=op, group=group, async_op=True).wait()
        return fn

    @staticmethod
    def _all_gather(group):
        def fn(src, dst):
            dist.all_gather_into_tensor(dst, src, group=group,
                                        async_op=True).wait()
        return fn

    # ------------------------------------------------------------------
    # allreduce
    # ------------------------------------------------------------------
    def hierarchical_active(self, ps_ranks=()) -> bool:
        # No "device" topology here (one card per process), so the
        # knob's auto value (None) means off, as xla_ops decides for
        # the ``proc`` topology.
        return bool(self.state.knobs.hierarchical_allreduce) and \
            self._hier and not ps_ranks

    @_timed("ALLREDUCE", metrics.list_nbytes)
    def allreduce(self, arrays, reduce_op, prescale, postscale,
                  ps_ranks=()):
        if reduce_op not in ("Sum", "Average", "Min", "Max", "Product"):
            raise ValueError(f"unknown reduce op {reduce_op!r}")
        arrays = [a.contiguous() for a in arrays]
        outs = [None] * len(arrays)
        hier = self.hierarchical_active(ps_ranks) and \
            reduce_op in ("Sum", "Average")
        for idx in _by_device(arrays):
            part = [arrays[i] for i in idx]
            if hier:
                self.stats["hierarchical_allreduces"] += 1
                res = self._hierarchical_allreduce(part, reduce_op, prescale,
                                                   postscale)
            else:
                self.stats["flat_allreduces"] += 1
                res = self._flat_allreduce(part, reduce_op, prescale,
                                           postscale, ps_ranks)
            for i, r in zip(idx, res):
                outs[i] = r
        self.stats["allreduce_bytes"] += metrics.list_nbytes(arrays)
        return outs

    def _flat_allreduce(self, arrays, reduce_op, prescale, postscale,
                        ps_ranks):
        group, ranks = self._group(ps_ranks)
        x0 = arrays[0]
        _, total = fb.layout([a.numel() for a in arrays], x0.dtype)
        flat = fb.pack(arrays, prescale,
                       out=self.buffers.get(x0.device, x0.dtype, total))
        if reduce_op == "Product" or (reduce_op in ("Min", "Max") and
                                      x0.dtype in _UNSIGNED):
            full = torch.empty(len(ranks) * total, dtype=x0.dtype,
                               device=x0.device)
            self._run(self._all_gather(group), flat, full)
            full = full.view(len(ranks), total)
            if reduce_op == "Product":
                flat.copy_(torch.prod(full, dim=0, dtype=x0.dtype))
            elif reduce_op == "Max":
                flat.copy_(full.amax(dim=0))
            else:
                flat.copy_(full.amin(dim=0))
        else:
            self._run(self._all_reduce(_DIST_OPS[reduce_op], group), flat)
        post = postscale / len(ranks) if reduce_op == "Average" \
            else postscale
        outs = [_empty_like(a) for a in arrays]
        fb.unpack(flat, outs, post)
        return outs

    def _hierarchical_allreduce(self, arrays, reduce_op, prescale,
                                postscale):
        ri = self.state.rank_info
        nlocal = ri.local_size
        local = self._subgroup(tuple(
            ri.cross_rank * nlocal + i for i in range(nlocal)))
        cross = self._subgroup(tuple(
            c * nlocal + ri.local_rank for c in range(ri.cross_size)))
        x0 = arrays[0]
        _, total = fb.layout([a.numel() for a in arrays], x0.dtype)
        padded = -(-total // nlocal) * nlocal
        buf = self.buffers.get(x0.device, x0.dtype, padded)
        fb.pack(arrays, prescale, out=buf)
        buf[total:].zero_()
        chunk = padded // nlocal

        def two_level(src, dst):
            shard = torch.empty(chunk, dtype=dst.dtype, device=dst.device)
            dist.reduce_scatter_tensor(shard, dst, group=local,
                                       async_op=True).wait()
            dist.all_reduce(shard, group=cross, async_op=True).wait()
            dist.all_gather_into_tensor(dst, shard, group=local,
                                        async_op=True).wait()

        self._run(two_level, buf)
        post = postscale / self.size if reduce_op == "Average" \
            else postscale
        outs = [_empty_like(a) for a in arrays]
        fb.unpack(buf, outs, post)
        return outs

    @_timed("ADASUM", metrics.list_nbytes)
    def adasum_allreduce(self, arrays, prescale, postscale, ps_ranks=()):
        arrays = [a.contiguous() for a in arrays]
        group, ranks = self._group(ps_ranks)
        outs = [None] * len(arrays)
        for idx in _by_device(arrays):
            part = [arrays[i] for i in idx]
            res = adasum_allreduce(part, prescale, postscale, ranks,
                                   ranks.index(self.rank),
                                   functools.partial(self._exchange,
                                                     group=group),
                                   self.buffers)
            for i, r in zip(idx, res):
                outs[i] = r
        return outs

    def _exchange(self, v: torch.Tensor, peer: int, group=None):
        """Send ``v`` to ``peer`` and return what ``peer`` sent."""
        u = torch.empty_like(v)

        def fn(src, dst):
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, src, peer, group),
                    dist.P2POp(dist.irecv, dst, peer, group)]):
                w.wait()
        self._run(fn, v, u)
        return u

    # ------------------------------------------------------------------
    # allgather / broadcast / alltoall / reducescatter / barrier
    # ------------------------------------------------------------------
    @_timed("ALLGATHER", metrics.list_nbytes)
    def allgather(self, arrays, sizes, ps_ranks=()):
        """``sizes`` holds ``group_size`` first-dimension sizes per
        tensor, in tensor order."""
        group, ranks = self._group(ps_ranks)
        gsize = len(ranks)
        results = []
        for i, x in enumerate(arrays):
            tsizes = [int(s) for s in sizes[i * gsize:(i + 1) * gsize]]
            x = x.contiguous()
            if x.dim() == 0:
                x = x.reshape(1)
            rows = x.shape[0]
            max_rows = max(tsizes) if tsizes else rows
            if rows < max_rows:
                x = torch.cat([x, x.new_zeros((max_rows - rows,) +
                                              tuple(x.shape[1:]))])
            full = x.new_empty((gsize * max_rows,) + tuple(x.shape[1:]))
            self._run(self._all_gather(group), x, full)
            results.append(torch.cat(
                [full[r * max_rows:r * max_rows + tsizes[r]]
                 for r in range(gsize)]))
        return results

    @_timed("BROADCAST", metrics.list_nbytes)
    def broadcast(self, arrays, root_rank, ps_ranks=()):
        """``root_rank`` is a rank of the world, inside the process set."""
        group, _ = self._group(ps_ranks)
        arrays = [a.contiguous() for a in arrays]
        outs = [_empty_like(a) for a in arrays]
        for idx in _by_device(arrays):
            part = [arrays[i] for i in idx]
            x0 = part[0]
            _, total = fb.layout([a.numel() for a in part], x0.dtype)
            flat = fb.pack(part, 1.0,
                           out=self.buffers.get(x0.device, x0.dtype, total))

            def fn(src, dst):
                dist.broadcast(dst, src=int(root_rank), group=group,
                               async_op=True).wait()
            self._run(fn, flat)
            fb.unpack(flat, [outs[i] for i in idx], 1.0)
        return outs

    @_timed("ALLTOALL", metrics.one_nbytes)
    def alltoall(self, array, splits, ps_ranks=(), split_matrix=None):
        group, ranks = self._group(ps_ranks)
        gsize, my_idx = len(ranks), ranks.index(self.rank)
        x = array.contiguous()
        if splits is None:
            splits = even_row_counts(x.shape[0], gsize)
        if isinstance(splits, torch.Tensor):
            splits = splits.tolist()
        splits = [int(s) for s in np.asarray(splits).reshape(-1)]
        if split_matrix is not None and len(split_matrix) == gsize * gsize:
            # The coordinator piggybacked every rank's send splits on the
            # response: no split exchange on the data plane.
            mat = np.asarray(split_matrix, dtype=np.int64).reshape(
                gsize, gsize)
        else:
            mine = torch.tensor(splits, dtype=torch.int64)
            mat = self.allgather([mine], [gsize] * gsize,
                                 ps_ranks)[0].numpy().reshape(gsize, gsize)
        recv = mat[:, my_idx].copy()
        out = x.new_empty((int(recv.sum()),) + tuple(x.shape[1:]))

        def fn(src, dst):
            dist.all_to_all_single(dst, src, [int(r) for r in recv], splits,
                                   group=group, async_op=True).wait()
        self._run(fn, x, out)
        return out, torch.from_numpy(recv)

    @_timed("REDUCESCATTER", metrics.list_nbytes)
    def reducescatter(self, arrays, reduce_op, ps_ranks=()):
        """Rank r receives its dim-0 share of the sum; the first ranks
        absorb the remainder.  Average divides by the group size; every
        other op sums, as ``xla_ops`` reduces."""
        group, ranks = self._group(ps_ranks)
        gsize, my_idx = len(ranks), ranks.index(self.rank)
        results = []
        for x in arrays:
            x = x.contiguous()
            rows = x.shape[0]
            counts = even_row_counts(rows, gsize)
            chunk = max(counts) if counts else 0
            rest = tuple(x.shape[1:])
            padded = x.new_zeros((gsize, chunk) + rest)
            start = 0
            for r, c in enumerate(counts):
                padded[r, :c] = x[start:start + c]
                start += c
            out = x.new_empty((chunk,) + rest)

            def fn(src, dst):
                dist.reduce_scatter_tensor(dst, src, group=group,
                                           async_op=True).wait()
            self._run(fn, padded.view((gsize * chunk,) + rest), out)
            y = out[:counts[my_idx]]
            if reduce_op == "Average":
                y = y / gsize
            results.append(y)
        return results

    def barrier(self, ps_ranks=()):
        self.allreduce([torch.zeros(1)], "Sum", 1.0, 1.0, ps_ranks)
        return None

    def close(self):
        """Drop this incarnation's fusion buffers, pinned staging and
        subgroups (``shutdown`` destroys the groups themselves): an
        elastic re-init builds a new backend for the next world."""
        self.buffers.clear()
        self._groups.clear()


def world1_checks(backend: TorchDistBackend,
                  device: torch.device) -> dict:
    """Every collective of ``backend`` once, in a world of one rank, on
    tensors of ``device``; each against what a world of one must give,
    exactly.  This is how NCCL runs on a machine with a single card
    (NCCL refuses two ranks on one device): ``chip_smoke.py`` and the
    ``cuda`` tests call it.  Returns {check: passed}."""
    from .backend import _scale
    g = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn(1000, generator=g).to(device)
    b = torch.randn(7, 3, generator=g).to(device)
    u8 = torch.randint(0, 256, (33,), generator=g).to(torch.uint8).to(device)
    rows = torch.arange(15, dtype=torch.float32, device=device).view(5, 3)
    out = {}
    fused = backend.allreduce([a, b], "Sum", 0.5, 3.0)
    out["allreduce_fused_scaled"] = all(
        torch.equal(r, _scale(_scale(x, 0.5), 3.0))
        for r, x in zip(fused, (a, b)))
    out["allreduce_average"] = torch.equal(
        backend.allreduce([b], "Average", 1.0, 1.0)[0], b)
    out["allreduce_uint8_max"] = torch.equal(
        backend.allreduce([u8], "Max", 1.0, 1.0)[0], u8)
    out["allgather"] = torch.equal(backend.allgather([rows], [5])[0], rows)
    out["broadcast"] = torch.equal(backend.broadcast([rows], 0)[0], rows)
    got, recv = backend.alltoall(rows, [5], split_matrix=[5])
    out["alltoall"] = torch.equal(got, rows) and recv.tolist() == [5]
    out["reducescatter"] = torch.equal(
        backend.reducescatter([rows], "Sum")[0], rows)
    out["adasum"] = torch.equal(
        backend.adasum_allreduce([a], 1.0, 1.0)[0], a)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out
