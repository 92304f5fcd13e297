"""Online embedding serving plane: snapshot-consistent reads at QPS
while training continues.

Counterpart of :mod:`horovod_tpu.serve`; the port serves its tables from
the card (``device``, ``None``: the card; see ``replica.py``).

The subsystem closes the trained-to-served loop that Check-N-Run
(NSDI '22) describes: the trainer's committed checkpoint manifests +
RowDelta chains (``horovod_tpu/checkpoint/``) double as the serving
plane's consistency boundary and incremental update channel.  A
:class:`ServingReplica` bootstraps from the latest committed manifest,
tails newly committed steps, and atomically flips immutable snapshots
so every read observes exactly one committed training step;
:class:`ServeServer` fronts it with the job-secret-HMAC HTTP contract
shared with /metrics//status//profile.

In-process use (the ``hvd.serve`` API)::

    import horovod_tpu_torch as hvd
    plane = hvd.serve.start(ckpt_dir)         # bootstrap + tail + HTTP
    rows, step = plane.replica.lookup("cat0", [3, 5, 3])
    ...
    plane.stop()

Knobs: ``HOROVOD_SERVE_MAX_STALENESS_STEPS`` (reject reads when the
replica lags the freshest commit by more than N steps),
``HOROVOD_SERVE_POLL_SECONDS`` (manifest tail cadence),
``HOROVOD_SERVE_PORT`` (HTTP port; 0 = ephemeral).  See
docs/serving.md in the JAX package.
"""

from typing import Optional

from ..common import env as _env
from ..common.env import env_int
from .replica import ServingReplica, StalenessError
from .server import ServeServer

__all__ = ["ServingReplica", "StalenessError", "ServeServer",
           "ServePlane", "start"]


class ServePlane:
    """One running serving plane: replica + tail thread + HTTP
    endpoint, stopped together."""

    def __init__(self, replica: ServingReplica,
                 server: Optional[ServeServer]):
        self.replica = replica
        self.server = server

    @property
    def port(self) -> Optional[int]:
        return self.server.port if self.server is not None else None

    def stop(self):
        if self.server is not None:
            self.server.stop()
            self.server = None
        self.replica.stop()


def start(directory: str, port: Optional[int] = None,
          secret: Optional[str] = None, http: bool = True,
          tail: bool = True, device=None) -> ServePlane:
    """Bootstrap a replica from ``directory``'s latest committed step,
    its tables on ``device`` (``None``: the card), and (by default)
    start the tail thread and the HTTP lookup endpoint.  Raises
    CheckpointNotFoundError when nothing has been committed yet."""
    replica = ServingReplica(directory, device=device)
    replica.bootstrap()
    if tail:
        replica.start()
    server = None
    if http:
        if port is None:
            port = env_int(_env.HOROVOD_SERVE_PORT, 0)
        server = ServeServer(replica, port=port, secret=secret)
    return ServePlane(replica, server)
