"""Worker-side elastic plumbing: rendezvous for a fresh rank identity
and the host-update poll source.

Reference: the worker half of gloo_context.cc:154-200 (elastic rank
re-query at re-init) + runner/elastic/worker.py (host-update
notification).  Here both ride the driver's rendezvous KV store: rank
identity via the long-polled ``rank_and_size`` scope, membership-change
notification by polling the ``elastic/generation`` key at
``state.commit()`` time.

Counterpart of :mod:`horovod_tpu.runner.elastic.worker`, copied.  The
epoch this process last rendezvoused at is what ``current_epoch`` gives
the failpoints' ``epoch=`` predicate and the rank-0 coordinator's
lost-rank notice.
"""

import json
import logging
import os
import time
from typing import Dict, Optional

from ...common import env as env_mod
from ...common import failpoints as _fp
from ...common.elastic import HostUpdateSource
from ..http_server import RendezvousClient

logger = logging.getLogger("horovod_tpu_torch.elastic")


class HostsRemovedError(SystemExit):
    """This worker's slot was retired from the plan; exit cleanly."""

    def __init__(self):
        super().__init__(0)


def _client() -> RendezvousClient:
    addr = env_mod.env_require(env_mod.HOROVOD_RENDEZVOUS_ADDR)
    port = int(env_mod.env_require(env_mod.HOROVOD_RENDEZVOUS_PORT))
    return RendezvousClient(addr, port)


# The epoch this process last rendezvoused at (0 = never).
_last_epoch = 0


def current_epoch() -> int:
    return _last_epoch


def elastic_rendezvous(timeout: Optional[float] = None) -> Dict:
    """Ask the driver for this worker's rank assignment in the next
    epoch.  Blocks until the driver has planned it; updates the process
    env contract (rank vars + coordinator/controller endpoints) and
    returns the assignment dict.

    Raises HostsRemovedError when the slot was retired.
    """
    global _last_epoch
    if _fp.ENABLED:
        # Failpoint site: worker-side re-rendezvous.  delay() models a
        # worker slow to rejoin after a resize; error() one that fails
        # its rendezvous (the retry loop treats it like any init
        # failure); crash() kills the worker process for real —
        # `elastic.rendezvous=crash(epoch=2)` is the env-contract way
        # to fault a live pod's second epoch.
        _fp.maybe_fail("elastic.rendezvous", epoch=_last_epoch + 1)
    client = _client()
    hostname = env_mod.env_str(env_mod.HOROVOD_HOSTNAME, "localhost")
    local_rank = env_mod.env_int(env_mod.HOROVOD_LOCAL_RANK, 0)
    timeout = timeout or env_mod.start_timeout()
    deadline = time.monotonic() + timeout
    key = f"{hostname}:{local_rank}?last_epoch={_last_epoch}"
    while time.monotonic() < deadline:
        try:
            raw = client.get(env_mod.GET_RANK_AND_SIZE, key)
        except OSError:
            # Transient HTTP hiccup (server busy mid-replan); retry.
            time.sleep(0.25)
            continue
        if raw is None:
            time.sleep(0.25)
            continue
        info = json.loads(raw.decode())
        if info.get("pending"):
            continue
        if info.get("invalid"):
            logger.info("elastic: slot retired; exiting cleanly")
            raise HostsRemovedError()
        _last_epoch = int(info["epoch"])
        if "ckpt_latest_step" in info:
            # Restart-from-latest-valid: the driver found a committed
            # durable checkpoint at job start; expose it so the
            # binding's DurableCheckpointer restores before first sync.
            os.environ["HOROVOD_CKPT_LATEST"] = \
                str(info["ckpt_latest_step"])
        os.environ[env_mod.HOROVOD_RANK] = str(info["rank"])
        os.environ[env_mod.HOROVOD_SIZE] = str(info["size"])
        os.environ[env_mod.HOROVOD_LOCAL_RANK] = str(info["local_rank"])
        os.environ[env_mod.HOROVOD_LOCAL_SIZE] = str(info["local_size"])
        os.environ[env_mod.HOROVOD_CROSS_RANK] = str(info["cross_rank"])
        os.environ[env_mod.HOROVOD_CROSS_SIZE] = str(info["cross_size"])
        _resolve_endpoints(client, info,
                           max(1.0, deadline - time.monotonic()))
        logger.info("elastic: rendezvous epoch %d rank %d/%d",
                    _last_epoch, info["rank"], info["size"])
        return info
    raise TimeoutError("elastic rendezvous timed out")


def _resolve_endpoints(client: RendezvousClient, info: Dict,
                       timeout: float):
    """Fix the epoch's coordinator/controller endpoints via the shared
    rank-0-publishes protocol (see runner/endpoints.py).  Keyed by
    epoch so each replan gets fresh endpoints.  A driver that still
    publishes explicit endpoints (tests / older drivers) wins."""
    if "coordinator" in info and "controller_addr" in info:
        os.environ[env_mod.HOROVOD_TPU_COORDINATOR] = info["coordinator"]
        os.environ["HOROVOD_CONTROLLER_ADDR"] = info["controller_addr"]
        return
    from ..endpoints import resolve_endpoints
    endpoints = resolve_endpoints(
        client, info["rank"], info.get("rank0_addr", "127.0.0.1"),
        str(info["epoch"]), timeout)
    os.environ[env_mod.HOROVOD_TPU_COORDINATOR] = endpoints["coordinator"]
    os.environ["HOROVOD_CONTROLLER_ADDR"] = endpoints["controller_addr"]


def latest_committed_step() -> Optional[int]:
    """Newest durably committed checkpoint step the driver (or any
    rank's commit arbiter) published in the rendezvous KV, or None.
    The on-disk manifest remains the durable truth; this is the fast
    path a re-rendezvousing worker checks without a directory scan."""
    from ...checkpoint.coordinator import KEY_LATEST, SCOPE
    try:
        raw = _client().get(SCOPE, KEY_LATEST)
    except (OSError, KeyError):
        return None
    if raw is None:
        return None
    try:
        return int(raw.decode())
    except ValueError:
        return None


def kv_commit_coordinator():
    """A :class:`~horovod_tpu_torch.checkpoint.KVCommitCoordinator` over
    this worker's rendezvous connection — the coordinator_factory for
    DurableCheckpointer in launcher-managed elastic jobs."""
    from ...checkpoint.coordinator import KVCommitCoordinator
    return KVCommitCoordinator(_client())


class RendezvousHostUpdateSource(HostUpdateSource):
    """Polls the driver's discovery generation key; a change since the
    last check means membership changed."""

    def __init__(self, seed_generation: int = 0):
        # Seeded with the generation the current epoch's plan reflects:
        # any bump after the plan (even one landing before this worker
        # finished init) must still trigger an interrupt.
        self._last_seen = seed_generation
        self._client = _client()

    def has_update(self) -> bool:
        from .driver import ELASTIC_SCOPE, KEY_GENERATION
        try:
            raw = self._client.get(ELASTIC_SCOPE, KEY_GENERATION)
        except OSError:
            return False
        if raw is None:
            return False
        gen = int(raw.decode())
        if gen > self._last_seen:
            self._last_seen = gen
            return True
        return False
