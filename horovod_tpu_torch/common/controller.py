"""Coordinator/worker negotiation: matching requests into responses.

Mirrors the reference controller protocol (reference: controller.{h,cc}:
ComputeResponseList :69-449 — rank 0 collects Requests from all ranks,
counts readiness (IncrementTensorCount :942-965), validates shape/dtype/
op agreement (ConstructResponse :471-748, mismatch → Response::ERROR),
fuses (FuseResponses :777-914) and broadcasts the ordered ResponseList;
protocol spec in controller.h:69-102).

Two implementations:
  * LoopbackController — single process; every request matches instantly.
  * The multi-process controller lives in controller_net.py and reuses
    construct_response/IncrementTensorCount from here over a TCP store.
"""

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .fusion import fuse_responses
from .message import (DataType, Request, RequestType, Response,
                      ResponseType)

logger = logging.getLogger("horovod_tpu_torch.controller")

_REQ_TO_RESP = {
    RequestType.ALLREDUCE: ResponseType.ALLREDUCE,
    RequestType.ALLGATHER: ResponseType.ALLGATHER,
    RequestType.BROADCAST: ResponseType.BROADCAST,
    RequestType.JOIN: ResponseType.JOIN,
    RequestType.ADASUM: ResponseType.ADASUM,
    RequestType.ALLTOALL: ResponseType.ALLTOALL,
    RequestType.REDUCESCATTER: ResponseType.REDUCESCATTER,
    RequestType.BARRIER: ResponseType.BARRIER,
}


def construct_response(name: str, msgs: List[Request], size: int,
                       joined_ranks: Set[int]) -> Response:
    """Validate the per-rank requests for one tensor and build a Response.

    Mismatched type/op/root/shape across ranks yields an ERROR response
    whose message names the offending ranks, matching reference
    ConstructResponse semantics (controller.cc:471-748).
    """
    assert msgs
    first = msgs[0]
    err = None

    for m in msgs[1:]:
        if m.request_type != first.request_type:
            err = (f"Mismatched collective operations: rank "
                   f"{first.request_rank} requested "
                   f"{first.request_type.name}, rank {m.request_rank} "
                   f"requested {m.request_type.name}.")
            break
        if m.tensor_type != first.tensor_type:
            err = (f"Mismatched data types for tensor {name}: rank "
                   f"{first.request_rank} has "
                   f"{DataType(first.tensor_type).name}, rank "
                   f"{m.request_rank} has {DataType(m.tensor_type).name}.")
            break
        if m.reduce_op != first.reduce_op:
            err = (f"Mismatched reduction ops for tensor {name}.")
            break
        if (m.prescale_factor != first.prescale_factor or
                m.postscale_factor != first.postscale_factor):
            err = f"Mismatched prescale/postscale factors for tensor {name}."
            break
        if first.request_type == RequestType.BROADCAST and \
                m.root_rank != first.root_rank:
            err = (f"Mismatched broadcast root ranks for tensor {name}: "
                   f"{first.root_rank} vs {m.root_rank}.")
            break
        if first.request_type in (RequestType.ALLREDUCE,
                                  RequestType.ADASUM,
                                  RequestType.BROADCAST) and \
                m.tensor_shape != first.tensor_shape:
            err = (f"Mismatched shapes for tensor {name}: rank "
                   f"{first.request_rank} has {first.tensor_shape}, rank "
                   f"{m.request_rank} has {m.tensor_shape}.")
            break
        if first.request_type in (RequestType.ALLGATHER,
                                  RequestType.ALLTOALL,
                                  RequestType.REDUCESCATTER) and \
                m.tensor_shape[1:] != first.tensor_shape[1:]:
            err = (f"Mismatched non-first dimensions for tensor {name}.")
            break

    if err is None and first.request_type == RequestType.ALLTOALL:
        group = len(first.process_set_ranks) or size
        for m in msgs:
            # 0-d tensors are promoted to one row by the data plane
            # (same convention as the allgather sizes above).
            dim0 = m.tensor_shape[0] if m.tensor_shape else 1
            if len(m.splits) != group:
                err = (f"Alltoall splits for tensor {name}: rank "
                       f"{m.request_rank} sent {len(m.splits)} entries "
                       f"for a group of {group}.")
                break
            if any(s < 0 for s in m.splits):
                err = (f"Alltoall splits for tensor {name}: rank "
                       f"{m.request_rank} sent negative splits "
                       f"{list(m.splits)}.")
                break
            if sum(m.splits) != dim0:
                # A ragged lookup batch is the common way to get here:
                # name the rank and both sums so the off-by-N is
                # visible without a debugger.
                err = (f"Alltoall splits for tensor {name}: rank "
                       f"{m.request_rank} splits {list(m.splits)} sum "
                       f"to {sum(m.splits)} but must sum to the first "
                       f"dimension ({dim0}); its tensor sends {dim0} "
                       f"rows, its splits account for "
                       f"{sum(m.splits)}.")
                break

    if err is not None:
        return Response(response_type=ResponseType.ERROR,
                        tensor_names=[name], error_message=err,
                        process_set_id=first.process_set_id)

    resp = Response(
        response_type=_REQ_TO_RESP[first.request_type],
        tensor_names=[name],
        tensor_type=first.tensor_type,
        prescale_factor=first.prescale_factor,
        postscale_factor=first.postscale_factor,
        process_set_id=first.process_set_id,
        root_rank=first.root_rank,
        reduce_op=first.reduce_op,
        tensor_shapes=[tuple(first.tensor_shape)],
        process_set_ranks=tuple(first.process_set_ranks),
    )
    if first.request_type == RequestType.ALLGATHER:
        # Record each participating rank's first-dimension size in
        # GROUP order (process-set ranks when given, else world rank
        # order) — consumers slice tensor_sizes in group_size strides
        # (xla_ops/ring_ops allgather, fusion, split_response); joined
        # (departed) ranks contribute zero rows.
        by_rank = {m.request_rank: m for m in msgs}
        ranks = list(first.process_set_ranks) or list(range(size))
        sizes = []
        for r in ranks:
            if r in by_rank:
                shape = by_rank[r].tensor_shape
                sizes.append(shape[0] if shape else 1)
            else:
                sizes.append(0)
        resp.tensor_sizes = sizes
    elif first.request_type == RequestType.ALLTOALL:
        # Flattened group×group send-split matrix, rows in GROUP order
        # (row g = group-rank g's send splits): rank g's recv splits
        # are column g.  Piggybacked on negotiation so the data plane
        # never needs its own split-exchange collective (reference:
        # AlltoallGetRecvSplits, mpi_controller.cc:212-223).  Joined
        # (departed) ranks contribute zero rows.
        by_rank = {m.request_rank: m for m in msgs}
        ranks = list(first.process_set_ranks) or list(range(size))
        group = len(ranks)
        matrix = []
        for r in ranks:
            if r in by_rank:
                matrix.extend(int(s) for s in by_rank[r].splits)
            else:
                matrix.extend([0] * group)
        resp.tensor_sizes = matrix
    return resp


@dataclass
class MessageTable:
    """Pending per-tensor request accumulation on the coordinator
    (IncrementTensorCount, controller.cc:942-965).  Keyed by
    (process_set_id, tensor_name): the SAME tensor name may be in
    flight on different process sets concurrently — the reference
    allows this structurally by giving every process set its own
    controller (process_set.h ProcessSetTable); a name-only key mixes
    the negotiations and wedges both sets."""
    entries: Dict[tuple, List[Request]] = field(default_factory=dict)

    @staticmethod
    def key(req: Request) -> tuple:
        return (req.process_set_id, req.tensor_name)

    def increment(self, req: Request, required: int,
                  joined_count: int = 0) -> bool:
        msgs = self.entries.setdefault(self.key(req), [])
        msgs.append(req)
        return len(msgs) + joined_count >= required

    def pop(self, key: tuple) -> List[Request]:
        return self.entries.pop(key, [])

    def ready_count(self, key: tuple) -> int:
        return len(self.entries.get(key, []))


class Controller:
    """Base interface; subclasses implement the cross-rank exchange."""

    def __init__(self, state):
        self.state = state
        self.size = state.rank_info.size
        self.rank = state.rank_info.rank
        self.joined_ranks: Set[int] = set()
        self.last_joined_rank = -1

    def is_coordinator(self) -> bool:
        return self.rank == 0

    def compute_response_list(self, pending: List[Request], entry_sizes,
                              threshold_bytes: int
                              ) -> Tuple[List[Response], List[Request]]:
        raise NotImplementedError

    def synchronize_parameters(self, params: dict) -> dict:
        """Broadcast autotuner-chosen knobs from rank 0 (reference:
        Controller::SynchronizeParameters, controller.cc:39-53)."""
        return params


class LoopbackController(Controller):
    """Single-process controller: all requests are instantly matched.

    This is also the negotiation model used when one process drives a
    whole TPU slice: there is exactly one program, so ordering is already
    deterministic and negotiation degenerates to validation + fusion.
    """

    def compute_response_list(self, pending, entry_sizes, threshold_bytes):
        responses: List[Response] = []
        group_ids = {}
        for req in pending:
            group_ids[MessageTable.key(req)] = req.group_id
            if req.request_type == RequestType.JOIN:
                self.joined_ranks.add(req.request_rank)
                self.last_joined_rank = req.request_rank
                responses.append(Response(
                    response_type=ResponseType.JOIN,
                    tensor_names=[req.tensor_name],
                    last_joined_rank=req.request_rank,
                    process_set_id=req.process_set_id))
                continue
            responses.append(construct_response(
                req.tensor_name, [req], 1, self.joined_ranks))
        fused = fuse_responses(responses, entry_sizes, threshold_bytes,
                               group_ids)
        return fused, []
