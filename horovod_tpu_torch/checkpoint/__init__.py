"""Durable sharded checkpointing for elastic training state.

Counterpart of :mod:`horovod_tpu.checkpoint`, whose docstring gives the
design: per-rank shards written by an async double-buffered writer
(``CheckpointManager``), a coordinator-arbitrated two-phase commit whose
record is ``MANIFEST.json``, restore of the newest valid step with
fallback past corrupt ones and re-sharding across world sizes, delta
chains of ``RowDelta`` items, the elastic bridge
(``DurableCheckpointer``) and the SIGTERM hook
(``install_preemption_hook``).  The shard bytes and the manifest are the
JAX package's, so a checkpoint written by either package restores in
the other.  Items are host values (numpy arrays and picklable Python
objects): the port's ``TorchState`` copies its tensors to numpy when it
hands them over (``torch/elastic/state.py``).

The port adds the names its elastic launcher reads: ``ENV_DIR``
(``HOROVOD_CHECKPOINT_DIR``), the KV scope and key of the commit marks
and the driver's manifest scan (``committed_steps``).
"""

from .coordinator import (KEY_LATEST, SCOPE, CommitCoordinator,
                          KVCommitCoordinator, LocalCommitCoordinator)
from .delta import RowDelta, assemble_table
from .elastic import ENV_DIR, DurableCheckpointer
from .manager import (CheckpointError, CheckpointManager,
                      CheckpointNotFoundError)
from .manifest import (MANIFEST_NAME, Manifest, committed_steps,
                       list_step_dirs, read_manifest, step_dir)
from .preemption import install_preemption_hook
from .shard_io import CheckpointCorruptError

__all__ = [
    "CheckpointManager", "CheckpointError", "CheckpointNotFoundError",
    "CheckpointCorruptError", "CommitCoordinator",
    "LocalCommitCoordinator", "KVCommitCoordinator",
    "DurableCheckpointer", "install_preemption_hook",
    "Manifest", "MANIFEST_NAME", "read_manifest", "step_dir",
    "list_step_dirs", "RowDelta", "assemble_table",
    "ENV_DIR", "SCOPE", "KEY_LATEST", "committed_steps",
]
