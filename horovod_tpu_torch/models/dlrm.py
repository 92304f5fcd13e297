"""DLRM-tiny: the dense half of a recsys click-through model.

Counterpart of :mod:`horovod_tpu.models.dlrm`: a bottom MLP embeds the
dense features, the categorical features are pooled from the embedding
tables of :mod:`horovod_tpu_torch.sparse` (model-parallel, outside this
module: their exchange is an eager alltoall with per-step splits), and a
top MLP scores the concatenation of the dense vector with the pooled
embeddings.  This module holds what allreduces: the data-parallel dense
parameters.  ``synthetic_click_batch`` is the JAX package's, in numpy,
so both packages draw the same batches from one seed.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .mnist import _init


@dataclass
class DLRMConfig:
    num_dense: int = 4                 # dense feature count
    embed_dim: int = 16                # rows are (embed_dim,)
    table_rows: Tuple[int, ...] = (65536, 65536)
    ids_per_table: int = 2             # multi-hot width per example
    bottom: Tuple[int, ...] = (32, 16)  # bottom MLP widths
    top: Tuple[int, ...] = (32, 16)     # top MLP widths (then 1)

    @property
    def num_tables(self) -> int:
        return len(self.table_rows)


def dlrm_tiny_config() -> DLRMConfig:
    return DLRMConfig()


class DLRMDense(nn.Module):
    """Bottom MLP + top MLP over [dense_vec, per-table pooled
    embeddings]; returns raw logits ``(batch,)``.  The Dense layers are
    flax's ``Dense_0..`` in order (bottom, top, then the scoring layer)
    as ``dense.0..``.  Weights are random from ``seed`` (flax's
    initializers), on ``device`` (``None``: the card)."""

    def __init__(self, config: DLRMConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        widths = [config.num_dense, *config.bottom]
        layers = [nn.Linear(a, b) for a, b in zip(widths, widths[1:])]
        widths = [config.bottom[-1] + config.num_tables * config.embed_dim,
                  *config.top, 1]
        layers += [nn.Linear(a, b) for a, b in zip(widths, widths[1:])]
        self.dense = nn.ModuleList(layers)
        _init(self, seed, device)

    def forward(self, dense, emb):
        n_bottom = len(self.config.bottom)
        x = dense
        for layer in self.dense[:n_bottom]:
            x = F.relu(layer(x))
        # emb: (batch, num_tables * embed_dim), pooled by the sparse
        # engine's EmbeddingBag in example order.
        z = torch.cat([x, emb], dim=-1)
        for layer in self.dense[n_bottom:-1]:
            z = F.relu(layer(z))
        return self.dense[-1](z)[..., 0]


def bce_logits_loss(logits, labels):
    """Numerically stable sigmoid binary cross-entropy, in fp32.  The
    clip at 0 is a ReLU: its gradient at a logit of exactly 0 is 0, as
    ``jnp.clip``'s is (``torch.clamp`` passes 1 there, and a logit is
    exactly 0 wherever the top MLP's ReLUs all close)."""
    logits = logits.float()
    labels = labels.float()
    return torch.mean(F.relu(logits) - logits * labels +
                      torch.log1p(torch.exp(-torch.abs(logits))))


def synthetic_click_batch(rng: np.random.Generator, batch: int,
                          config: DLRMConfig
                          ) -> Tuple[np.ndarray, List[np.ndarray],
                                     np.ndarray, np.ndarray]:
    """One synthetic batch: ``(dense, ids_per_table, offsets,
    labels)``.  Ids are Zipf-skewed (hot-row heavy) and clipped to the
    table; offsets are the fixed-width bag boundaries."""
    dense = rng.standard_normal((batch, config.num_dense)
                                ).astype(np.float32)
    ids = []
    for rows in config.table_rows:
        raw = rng.zipf(1.3, size=batch * config.ids_per_table)
        ids.append(((raw - 1) % rows).astype(np.int64))
    offsets = (np.arange(batch, dtype=np.int64)
               * config.ids_per_table)
    labels = (rng.random(batch) < 0.3).astype(np.float32)
    return dense, ids, offsets, labels


def convert_flax_dlrm_params(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``DLRMDense`` parameters (nested as flax returns
    them, a leading ``params`` level allowed) as this module's
    ``state_dict`` (fp32, CPU): ``Dense_i`` becomes ``dense.i``, its
    ``[in, out]`` kernel transposed to ``[out, in]``."""
    params = params.get("params", params)
    sd = {}
    for mod, leaves in params.items():
        num = mod.rpartition("_")[2]
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        sd[f"dense.{num}.weight"] = torch.tensor(
            np.ascontiguousarray(kernel.T))
        sd[f"dense.{num}.bias"] = torch.tensor(
            np.asarray(leaves["bias"], dtype=np.float32))
    return sd
