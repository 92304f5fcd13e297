"""ElasticSampler: a torch data sampler that repartitions the remaining
indices when the world changes (reference: torch/elastic/sampler.py:
25-132 — tracks processed indices so a reset resumes mid-epoch without
repeating or dropping samples).

Counterpart of :mod:`horovod_tpu.torch.elastic.sampler`, copied: the
same seed gives the same indices at every world size."""

import math
from typing import Iterator, List, Set

import torch.utils.data

from ...common import basics


class ElasticSampler(torch.utils.data.Sampler):
    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: Set[int] = set()

        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices: List[int] = []
        self.num_samples = 0
        self.total_size = 0
        self.reset()

    def set_epoch(self, epoch: int):
        """New epoch: clear processed tracking and reshuffle."""
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int):
        """Mark the batch's samples processed (call per step, before
        commit).  Consumed indices are the slice of this rank's
        iteration order."""
        consumed = self.indices[batch_idx * batch_size:
                                (batch_idx + 1) * batch_size]
        self.processed_indices.update(consumed)

    def record_indices(self, indices) -> None:
        self.processed_indices.update(int(i) for i in indices)

    def reset(self):
        """Repartition the remaining (unprocessed) indices over the
        current world (called on elastic reset and epoch change)."""
        self.num_replicas = basics.size() if basics.is_initialized() \
            else 1
        self.rank = basics.rank() if basics.is_initialized() else 0

        all_indices = list(range(len(self.dataset)))
        if self.shuffle:
            g = torch.Generator()
            g.manual_seed(self.seed + self.epoch)
            perm = torch.randperm(len(all_indices), generator=g).tolist()
            all_indices = [all_indices[i] for i in perm]
        self.remaining_indices = [i for i in all_indices
                                  if i not in self.processed_indices]

        self.num_samples = int(
            math.ceil(len(self.remaining_indices) / self.num_replicas)) \
            if self.num_replicas else 0
        self.total_size = self.num_samples * self.num_replicas
        # Pad so every rank yields the same count (DistributedSampler
        # convention).
        padded = list(self.remaining_indices)
        if padded:
            while len(padded) < self.total_size:
                padded += padded[:self.total_size - len(padded)]
        self.indices = padded[self.rank:self.total_size:
                              self.num_replicas]

    def state_dict(self):
        return {
            "epoch": self.epoch,
            "processed_indices": sorted(self.processed_indices),
        }

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.processed_indices = set(state["processed_indices"])
        self.reset()

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return self.num_samples
