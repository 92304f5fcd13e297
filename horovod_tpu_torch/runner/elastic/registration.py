"""Worker-state registry: the driver-side barrier over worker results.

Reference: runner/elastic/registration.py:28-174 — workers report
READY (re-rendezvoused after a reset), SUCCESS (training function
returned) or FAILURE (process exited non-zero / raised); the registry
acts as a barrier keyed by reset epoch, blacklists repeatedly failing
hosts, and bounds the number of resets by ``reset_limit``.  The barrier
is an explicit arrival count: the recording call that completes the set
runs the evaluation action inline.

Counterpart of :mod:`horovod_tpu.runner.elastic.registration`, copied.
"""

import logging
import threading
from collections import defaultdict
from typing import Dict, Optional, Set

logger = logging.getLogger("horovod_tpu_torch.elastic")

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, driver, host_manager, reset_limit: Optional[int] = None,
                 verbose: bool = False):
        self._driver = driver
        self._host_manager = host_manager
        self._reset_limit = reset_limit
        self._reset_count = 0
        self._lock = threading.Lock()
        self._states: Dict[str, str] = {}       # "host:local_rank" -> state
        self._workers: Dict[str, Set[str]] = defaultdict(set)  # state -> keys
        self._size = 0
        self._fired = False
        self._rendezvous_id = 0
        self._verbose = verbose

    @property
    def reset_count(self) -> int:
        return self._reset_count

    def last_rendezvous(self) -> int:
        return self._rendezvous_id

    def get_recorded(self, state: str) -> Set[str]:
        with self._lock:
            return set(self._workers[state])

    def reset(self, size: int):
        """Arm a new arrival barrier over ``size`` workers."""
        with self._lock:
            logger.debug("registry reset: size=%d", size)
            self._states.clear()
            self._workers.clear()
            self._size = size
            self._fired = False
            self._rendezvous_id += 1

    def size(self) -> int:
        with self._lock:
            return self._size

    def count(self) -> int:
        with self._lock:
            return len(self._states)

    def record_ready(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, READY)

    def record_success(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, SUCCESS)

    def record_failure(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, FAILURE)

    def _record_state(self, host: str, slot: int, state: str) -> int:
        if self._driver.finished():
            return self._rendezvous_id
        if state == FAILURE and self._host_manager.is_blacklisted(host):
            return self._rendezvous_id

        key = f"{host}:{slot}"
        fire = False
        with self._lock:
            if self._size == 0:
                return self._rendezvous_id
            cur = self._states.get(key)
            if cur == state:
                return self._rendezvous_id
            if cur == FAILURE and state == READY:
                # FAILURE is sticky within an epoch: the driver
                # records it for a straggler being migrated while the
                # worker process is still alive — the worker's own
                # re-rendezvous must not resurrect the slot, or the
                # eviction evaporates at the barrier.
                return self._rendezvous_id
            if cur is not None:
                # A worker moves READY -> SUCCESS/FAILURE within one
                # epoch; replace its recorded state without re-counting.
                self._workers[cur].discard(key)
            self._states[key] = state
            self._workers[state].add(key)
            # Fire once per epoch, when every worker has arrived:
            # survivors arrive READY at re-rendezvous, exited workers
            # arrive SUCCESS/FAILURE via the process monitor.
            if not self._fired and len(self._states) >= self._size:
                self._fired = True
                fire = True
        if fire:
            self._on_workers_recorded()
        return self._rendezvous_id

    def _on_workers_recorded(self):
        logger.info("elastic: all %d workers finished; evaluating",
                    self.size())
        if len(self.get_recorded(SUCCESS)) == self.size():
            logger.info("elastic: all workers succeeded; shutting down")
            self._driver.stop()
            return
        # Blacklist hosts of failed workers (reference:
        # registration.py:150-160 — a failed slot taints the host).
        failures = self.get_recorded(FAILURE)
        for key in failures:
            host = key.rsplit(":", 1)[0]
            self._host_manager.blacklist(host)
        if self._driver.finished():
            return
        if failures:
            if self._reset_limit is not None and \
                    self._reset_count >= self._reset_limit:
                logger.error("elastic: reset limit %d reached; terminating",
                             self._reset_limit)
                self._driver.stop(error_message=(
                    f"Elastic reset limit of {self._reset_limit} resets "
                    "reached; aborting."))
                return
            self._reset_count += 1
        self._driver.resume()
