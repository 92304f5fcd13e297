"""Data-plane backends executing fused collective batches.

The analog of the reference's OperationManager + per-backend op classes
(reference: ops/operation_manager.{h,cc} priority dispatch;
ops/nccl_operations.cc, ops/mpi_operations.cc, ops/gloo_operations.cc).
Counterpart of :mod:`horovod_tpu.ops.backend`; every array is a torch
tensor, and results stay on the device their inputs came in on.

A world of one rank runs the ``SingleProcessBackend``; a larger one the
``TorchDistBackend`` of ``dist_ops.py`` (NCCL or gloo, the counterpart
of ``xla_ops.py`` and ``ring_ops.py``).
"""

from typing import Any, List, Tuple

import numpy as np
import torch


def even_row_counts(rows: int, gsize: int) -> List[int]:
    """Dim-0 rows per group rank: base share each, first ranks absorb
    the remainder.  The ONE uneven-split convention every backend
    must agree on (reference: allgather displacement rule,
    collective_operations.cc)."""
    base, rem = divmod(rows, gsize)
    return [base + (1 if r < rem else 0) for r in range(gsize)]


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Floats multiply in their own dtype (the factor rounded to it);
    integers multiply in float64 and cast back, truncating, as numpy's
    ``(x * factor).astype(x.dtype)`` does."""
    if factor == 1.0:
        return x
    if x.is_floating_point():
        return x * torch.tensor(factor, dtype=x.dtype, device=x.device)
    return (x.to(torch.float64) * factor).to(x.dtype)


class Backend:
    """``ps_ranks`` on every method is the process-set member tuple
    (empty = the global world)."""
    name = "abstract"

    def world_size(self, ps_ranks: Tuple[int, ...] = ()) -> int:
        raise NotImplementedError

    def allreduce(self, arrays: List[Any], reduce_op: str, prescale: float,
                  postscale: float, ps_ranks=()) -> List[Any]:
        raise NotImplementedError

    def adasum_allreduce(self, arrays, prescale, postscale,
                         ps_ranks=()) -> List[Any]:
        raise NotImplementedError

    def allgather(self, arrays: List[Any], sizes: List[int],
                  ps_ranks=()) -> List[Any]:
        raise NotImplementedError

    def broadcast(self, arrays: List[Any], root_rank: int,
                  ps_ranks=()) -> List[Any]:
        raise NotImplementedError

    def alltoall(self, array, splits, ps_ranks=(),
                 split_matrix=None) -> Tuple[Any, Any]:
        """``split_matrix``: optional flattened group×group send-split
        matrix assembled by the coordinator (rows in group order);
        when given the backend must not run its own split exchange."""
        raise NotImplementedError

    def reducescatter(self, arrays: List[Any], reduce_op: str,
                      ps_ranks=()) -> List[Any]:
        raise NotImplementedError

    def barrier(self, ps_ranks=()):
        raise NotImplementedError


class SingleProcessBackend(Backend):
    """World of one rank: collectives are (scaled) identities.

    Matches reference behavior when running without a launcher — e.g.
    `python train.py` directly gives size()==1 and allreduce returns its
    input (times pre/post scale).
    """
    name = "single"

    def world_size(self, ps_ranks=()) -> int:
        return 1

    def allreduce(self, arrays, reduce_op, prescale, postscale,
                  ps_ranks=()):
        return [_scale(_scale(x, prescale), postscale) for x in arrays]

    def adasum_allreduce(self, arrays, prescale, postscale, ps_ranks=()):
        return self.allreduce(arrays, "Adasum", prescale, postscale,
                              ps_ranks)

    def allgather(self, arrays, sizes, ps_ranks=()):
        return list(arrays)

    def broadcast(self, arrays, root_rank, ps_ranks=()):
        return list(arrays)

    def alltoall(self, array, splits, ps_ranks=(), split_matrix=None):
        if splits is None:
            return array, None
        if isinstance(splits, torch.Tensor):
            return array, splits.clone()
        return array, torch.from_numpy(np.asarray(splits))

    def reducescatter(self, arrays, reduce_op, ps_ranks=()):
        return list(arrays)

    def barrier(self, ps_ranks=()):
        return None


def create_backend(state) -> Backend:
    if state.rank_info.size == 1:
        return SingleProcessBackend()
    from .dist_ops import TorchDistBackend
    return TorchDistBackend(state, state.transport)
