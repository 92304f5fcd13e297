"""Checkpoint coordination for elastic jobs.

Counterpart of :mod:`horovod_tpu.checkpoint`, of which the port has so
far only what the elastic launcher needs: the rendezvous-KV commit
coordinator (``SCOPE``, ``KEY_LATEST``, ``KVCommitCoordinator``), the
manifest scan the driver runs at start (``committed_steps``) and the
``HOROVOD_CHECKPOINT_DIR`` knob it reads.  The durable checkpointer, the
manager, the shard format and delta checkpoints come with their own
slice (ROADMAP.md Queue 1, item 15).
"""

from .coordinator import (KEY_LATEST, SCOPE, CommitCoordinator,
                          KVCommitCoordinator, LocalCommitCoordinator)
from .manifest import committed_steps

# Where durable checkpoints live; the elastic driver scans it at start
# to advertise the restart step (horovod_tpu/checkpoint/elastic.py).
ENV_DIR = "HOROVOD_CHECKPOINT_DIR"

__all__ = [
    "ENV_DIR", "SCOPE", "KEY_LATEST", "CommitCoordinator",
    "KVCommitCoordinator", "LocalCommitCoordinator", "committed_steps",
]
