"""Elastic launcher subsystem: host discovery, the elastic driver, the
worker-state registry, and the elastic rendezvous handler.

The analog of the reference's ``horovod/runner/elastic/`` (reference:
runner/elastic/{driver,discovery,registration,rendezvous,worker}.py).

Counterpart of :mod:`horovod_tpu.runner.elastic`, copied less
``TPUPodDiscovery``: a discovery script lists the hosts, and a world
change re-forms the ``torch.distributed`` process group and the
negotiation controller at fresh ports in the surviving processes.
"""

from .discovery import (FixedHosts, HostDiscovery, HostDiscoveryScript,
                        HostManager)
from .driver import ElasticDriver
from .registration import READY, SUCCESS, FAILURE, WorkerStateRegistry

__all__ = [
    "ElasticDriver", "HostDiscovery", "HostDiscoveryScript", "FixedHosts",
    "HostManager", "WorkerStateRegistry", "READY", "SUCCESS", "FAILURE",
]
