"""Elastic rendezvous handler: serves fresh rank assignments from the
live driver (reference: runner/elastic/rendezvous.py:28-55 —
``HOROVOD_GLOO_GET_RANK_AND_SIZE`` answered from driver assignments).

Protocol (worker → driver):

    GET /rank_and_size/<hostname>:<local_rank>?last_epoch=<E>

Records the worker as READY in the state registry (its arrival at the
reset barrier), then long-polls until an epoch newer than E is planned.
Responds JSON::

    {"pending": true}                              try again
    {"invalid": true, ...}                         slot retired → exit
    {"rank":R,"size":S,"local_rank":..,"local_size":..,
     "cross_rank":..,"cross_size":..,"epoch":E',
     "rank0_addr":"h"}                             new identity

The coordinator/controller endpoints are NOT part of this response:
the rank-0 worker combines ``rank0_addr`` with ports it binds itself
and publishes them under ``elastic_endpoints/<epoch>`` (see
runner/endpoints.py); other workers long-poll that key.  Drivers may
still include explicit ``coordinator``/``controller_addr`` keys as a
legacy override, which workers honor verbatim.

Counterpart of :mod:`horovod_tpu.runner.elastic.rendezvous`, copied on
the port's ``KVStoreHandler``: its replies are the same bytes.
"""

import json
from urllib.parse import parse_qs

from ...common.env import GET_RANK_AND_SIZE
from ..http_server import KVStoreHandler
from ..hosts import INVALID_SLOT_INFO


class ElasticRendezvousHandler(KVStoreHandler):
    def handle_get_special(self, scope: str, key: str):
        if scope != GET_RANK_AND_SIZE:
            return None
        driver = getattr(self.server, "elastic_driver", None)
        if driver is None:
            return None
        # NOTE: urlparse would read "host:0?..." as scheme "host";
        # split query manually.
        path, _, query = key.partition("?")
        qs = parse_qs(query)
        last_epoch = int(qs.get("last_epoch", ["0"])[0])
        hostname, local_rank_s = path.rsplit(":", 1)
        local_rank = int(local_rank_s)

        if last_epoch > 0:
            # A re-rendezvous: this survivor's arrival at the reset
            # barrier.  Fresh workers (last_epoch=0) joined after the
            # plan and are not parties of the previous epoch's barrier.
            driver.record_ready(hostname, local_rank)
        slot, world, epoch = driver.get_slot_info(
            hostname, local_rank, last_epoch)
        if slot is None:
            return json.dumps({"pending": True}).encode()
        if slot == INVALID_SLOT_INFO or slot.rank < 0:
            return json.dumps({"invalid": True, "epoch": epoch}).encode()
        payload = {
            "rank": slot.rank, "size": slot.size,
            "local_rank": slot.local_rank, "local_size": slot.local_size,
            "cross_rank": slot.cross_rank, "cross_size": slot.cross_size,
            "hostname": slot.hostname, "epoch": epoch,
        }
        payload.update({k: v for k, v in world.items()
                        if k in ("coordinator", "controller_addr",
                                 "rank0_addr", "generation",
                                 "ckpt_latest_step")})
        return json.dumps(payload).encode()
