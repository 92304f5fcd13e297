"""Rank-0-chosen service endpoints, published through the rendezvous KV.

Counterpart of :mod:`horovod_tpu.runner.endpoints`, copied.  The
``torch.distributed`` store (``HOROVOD_TPU_COORDINATOR``) and the
negotiation TCP server both bind in the rank-0 process, so their ports must be chosen on RANK 0's
host — a port free on the launcher machine may be in use where the
services actually bind (reference launchers sidestep this because MPI
owns the wire-up; our TCP control plane must do it explicitly).

Protocol: rank 0 picks free local ports and PUTs the full endpoints
JSON under ``<scope>/<key>``; every other rank long-polls that key.
Used by both the elastic worker rendezvous (fresh key per epoch) and
the static launcher (one key per run) when rank 0 is remote.
"""

import json
from typing import Dict

from .http_server import RendezvousClient, find_ports

ENDPOINTS_SCOPE = "elastic_endpoints"
STATIC_KEY = "static"


def resolve_endpoints(client: RendezvousClient, rank: int,
                      rank0_addr: str, key: str,
                      timeout: float) -> Dict[str, str]:
    """Fix the coordinator/controller endpoints for one world epoch.

    Returns ``{"coordinator": "h:p", "controller_addr": "h:p"}``.
    Rank 0 chooses the ports (on its own host) and publishes; others
    wait for the published value.
    """
    if rank == 0:
        coord_port, ctrl_port = find_ports(2)
        endpoints = {"coordinator": f"{rank0_addr}:{coord_port}",
                     "controller_addr": f"{rank0_addr}:{ctrl_port}"}
        client.put(ENDPOINTS_SCOPE, key, json.dumps(endpoints).encode())
        return endpoints
    raw = client.wait_get(ENDPOINTS_SCOPE, key, timeout=timeout)
    return json.loads(raw.decode())
