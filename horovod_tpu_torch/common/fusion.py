"""Fusion planning: batch matched responses into fused collectives.

The reference fuses same-type/same-dtype responses into one buffer up to
HOROVOD_FUSION_THRESHOLD bytes, with a look-ahead skip so one mismatched
dtype doesn't break a fusable run (reference: controller.cc:777-914,
FuseResponses, look-ahead at :826-848; threshold rounding for
hierarchical ops at :451-469).

On TPU the fused batch becomes ONE compiled XLA program (concat →
collective → split happen on-device in HBM, fused by XLA), so the fusion
plan doubles as the executable-cache key: stable plans mean compile-cache
hits — which is why deterministic ordering matters even more here than in
the reference (SURVEY §7 hard parts).
"""
# hvdlint-module: hot-path (instrumentation must hide behind one attribute check — docs/static_analysis.md)

from typing import List

from . import metrics
from .message import Response, ResponseType, dtype_size


_FUSABLE = {ResponseType.ALLREDUCE, ResponseType.ADASUM,
            ResponseType.ALLGATHER, ResponseType.REDUCESCATTER}

_FUSED_TENSORS = metrics.histogram(
    "hvd_fusion_tensors_per_response",
    "Tensors batched into one fused response",
    bounds=metrics.COUNT_BUCKETS)
_FUSED_BYTES = metrics.histogram(
    "hvd_fusion_bytes",
    "Payload bytes per fused response (vs. HOROVOD_FUSION_THRESHOLD)",
    bounds=metrics.BYTE_BUCKETS)


def response_bytes(resp: Response, entry_sizes) -> int:
    """Total payload bytes of a response given per-tensor element
    counts.  ``entry_sizes`` is keyed by (process_set_id, name): the
    same name may be live on two process sets with different shapes."""
    total = 0
    for name in resp.tensor_names:
        total += entry_sizes[(resp.process_set_id, name)] * \
            dtype_size(resp.tensor_type)
    return total


def _can_fuse(a: Response, b: Response) -> bool:
    if a.response_type != b.response_type:
        return False
    if a.response_type not in _FUSABLE:
        return False
    return (a.tensor_type == b.tensor_type
            and a.process_set_id == b.process_set_id
            and a.prescale_factor == b.prescale_factor
            and a.postscale_factor == b.postscale_factor
            and a.reduce_op == b.reduce_op)


def _merge(a: Response, b: Response) -> Response:
    return Response(
        response_type=a.response_type,
        tensor_names=a.tensor_names + b.tensor_names,
        tensor_type=a.tensor_type,
        devices=a.devices,
        tensor_sizes=a.tensor_sizes + b.tensor_sizes,
        prescale_factor=a.prescale_factor,
        postscale_factor=a.postscale_factor,
        process_set_id=a.process_set_id,
        reduce_op=a.reduce_op,
        root_rank=a.root_rank,
        tensor_shapes=a.tensor_shapes + b.tensor_shapes,
        process_set_ranks=a.process_set_ranks,
    )


def _premerge_groups(responses: List[Response], group_ids) -> List[Response]:
    """Merge members of one grouped submission into a single response
    BEFORE threshold-bounded fusion, so a group is never split across
    compiled programs even when it exceeds the threshold (reference
    keeps groups together via the group table, controller.cc:199-223).
    Members of mixed dtype/op stay separate (they could not share one
    fused buffer anyway); order is anchored at each group's first
    member."""
    merged: List[Response] = []
    index = {}  # (group_id, fuse key) -> position in merged
    for resp in responses:
        gid = -1
        if resp.tensor_names and group_ids:
            gid = group_ids.get(
                (resp.process_set_id, resp.tensor_names[0]), -1)
        if gid < 0 or resp.response_type not in _FUSABLE:
            merged.append(resp)
            continue
        key = (gid, resp.response_type, resp.tensor_type,
               resp.process_set_id, resp.prescale_factor,
               resp.postscale_factor, resp.reduce_op)
        pos = index.get(key)
        if pos is None:
            index[key] = len(merged)
            merged.append(resp)
        else:
            merged[pos] = _merge(merged[pos], resp)
    return merged


def fuse_responses(responses: List[Response], entry_sizes,
                   threshold_bytes: int, group_ids=None) -> List[Response]:
    """Greedy fusion with look-ahead skip.

    ``entry_sizes`` maps tensor name → element count; ``group_ids``
    (optional) maps tensor name → grouped-submission id for group
    atomicity.  Responses that cannot fuse (broadcast, alltoall, errors,
    joins) pass through unchanged, preserving overall order determinism
    so every rank builds the identical plan.
    """
    out: List[Response] = []
    queue = _premerge_groups(responses, group_ids)
    while queue:
        base = queue.pop(0)
        if base.response_type not in _FUSABLE:
            out.append(base)
            continue
        acc_bytes = response_bytes(base, entry_sizes)
        fused = base
        skipped: List[Response] = []
        i = 0
        while i < len(queue):
            cand = queue[i]
            if _can_fuse(fused, cand):
                cand_bytes = response_bytes(cand, entry_sizes)
                if acc_bytes + cand_bytes <= threshold_bytes:
                    fused = _merge(fused, cand)
                    acc_bytes += cand_bytes
                    queue.pop(i)
                    continue
                else:
                    # Full — stop scanning, keep remaining order intact.
                    break
            else:
                # Look-ahead skip (reference controller.cc:826-848): a
                # response of a different dtype/type does not terminate
                # the scan; keep looking for fusable candidates behind it.
                i += 1
        out.append(fused)
    for resp in out:
        if resp.response_type in _FUSABLE and resp.tensor_names:
            _FUSED_TENSORS.observe(len(resp.tensor_names))
            try:
                _FUSED_BYTES.observe(response_bytes(resp, entry_sizes))
            except KeyError:
                pass  # caller passed a partial size map; skip bytes
    return out
