"""Model-parallel sparse embedding engine — the recsys/DLRM workload.

Counterpart of :mod:`horovod_tpu.sparse`: embedding tables row-sharded
across ranks (:class:`~.embedding.ShardedEmbedding`), looked up and
updated through the eager ``hvd.alltoall`` with explicit splits, pooled
per example by :class:`~.embedding.EmbeddingBag`, and persisted as the
checkpoint layer's ``RowDelta`` items (a full base, then touched-rows
deltas).  The tables live on the card; see ``embedding.py`` for what
crosses to the host and how the updates keep the JAX engine's order.
"""

from .embedding import (EmbeddingBag, ShardedEmbedding,
                        lookup_overlapped)

__all__ = ["ShardedEmbedding", "EmbeddingBag", "lookup_overlapped"]
