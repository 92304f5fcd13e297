"""Host discovery for elastic runs.

Reference: runner/elastic/discovery.py:79-165 — ``HostDiscovery``
subclasses produce the current ``{host: slots}`` view; ``HostManager``
tracks ordered current hosts, applies the blacklist, and detects
changes.  The ordering contract (reference: discovery.py:113-121) is
load-bearing: existing hosts keep their order (hence their ranks) and
new hosts append, so surviving ranks stay stable across resets.

Counterpart of :mod:`horovod_tpu.runner.elastic.discovery`, copied less
``TPUPodDiscovery`` (it reads TPU-VM metadata, which a GPU host does not
have; a discovery script lists GPU hosts).  Deltas from the reference
(closed-loop elasticity, docs/failure_recovery.md "Autoscaling"):

* the blacklist decays — ``HOROVOD_ELASTIC_BLACKLIST_COOLDOWN`` > 0
  re-admits an evicted host after ``base * 2^(strikes-1)`` seconds
  (each repeat offense doubles the sit-out), so a transient wedge or
  conn-drop no longer costs a host for the whole job;
* scale-up admission is explicit — ``update_available_hosts`` can hold
  newly discovered hosts PENDING instead of admitting them, so the
  driver's policy engine (not the discovery poll) decides when a
  mid-job resize happens;
* ``HostDiscoveryScript`` execution is bounded and self-healing: a
  hung/failing script times out (``HOROVOD_ELASTIC_DISCOVERY_TIMEOUT``),
  logs once, and the caller keeps the last-good host set — and an
  EMPTY output while hosts are known is treated as a script glitch,
  never as "remove everyone".
"""

import logging
import subprocess
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Set

from ...common import env as env_mod

logger = logging.getLogger("horovod_tpu_torch.elastic")


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Returns {hostname: slots} of currently available hosts."""
        raise NotImplementedError()


class HostDiscoveryScript(HostDiscovery):
    """Runs a user script that prints one ``host`` or ``host:slots``
    line per available host (reference: discovery.py:136-157).

    Execution is bounded by ``env.discovery_timeout()`` (the
    ``start_timeout()``-style fresh-parse contract): a hung script must
    not stall the driver's discovery loop.  A timeout, a non-zero
    exit, or an empty stdout while hosts are already known all fall
    back to the LAST GOOD host set, logged once per outage (the flag
    resets on the next healthy run) — removing every worker because a
    flaky script printed nothing is the failure mode this guards."""

    def __init__(self, discovery_script: str, default_slots: int):
        self._script = discovery_script
        self._default_slots = default_slots
        self._last_good: Optional[Dict[str, int]] = None
        self._warned = False
        super().__init__()

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        try:
            # hvdlint: bounded-by(env.discovery_timeout knob — a hung
            # discovery script is cut, never awaited forever)
            stdout = subprocess.check_output(
                self._script, shell=True,
                timeout=env_mod.discovery_timeout()).decode("utf-8")
        except (subprocess.TimeoutExpired,
                subprocess.CalledProcessError, OSError) as e:
            return self._degraded("discovery script failed (%s)"
                                  % type(e).__name__)
        host_slots = OrderedDict()
        for line in stdout.strip().split("\n"):
            line = line.strip()
            if not line:
                continue
            host = line
            if ":" in line:
                host, slots = line.split(":", 1)
                try:
                    host_slots[host] = int(slots)
                except ValueError:
                    continue
            else:
                host_slots[host] = self._default_slots
        if not host_slots:
            # An empty listing while hosts are known reads as a script
            # glitch (truncated output, transient upstream outage) —
            # NOT as "every host left at once".  At formation (no
            # last-good yet) _degraded surfaces it as a hard error.
            return self._degraded("discovery script returned no hosts")
        if self._warned and host_slots:
            logger.info("discovery script healthy again (%d hosts)",
                        len(host_slots))
        self._warned = False
        self._last_good = OrderedDict(host_slots)
        return host_slots

    def _degraded(self, why: str) -> Dict[str, int]:
        if not self._warned:
            self._warned = True
            logger.warning(
                "%s; keeping last-good host set (%s)", why,
                sorted(self._last_good) if self._last_good else "none")
        if self._last_good is None:
            # No good run yet (job formation): surface the failure so
            # wait_for_available_slots keeps retrying with the real
            # error visible, instead of silently planning zero hosts.
            raise RuntimeError(
                "host discovery script produced no usable host set "
                "and no last-good set exists: %s" % why)
        return OrderedDict(self._last_good)


class FixedHosts(HostDiscovery):
    """A static host set (non-elastic fallback / tests,
    reference: discovery.py:160-165)."""

    def __init__(self, host_slots: Dict[str, int]):
        super().__init__()
        self._host_slots = host_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._host_slots)


class _BlacklistEntry:
    __slots__ = ("strikes", "until")

    def __init__(self, strikes: int, until: Optional[float]):
        self.strikes = strikes      # lifetime eviction count
        self.until = until          # monotonic expiry; None = forever


class HostManager:
    """Tracks current hosts in stable order + the blacklist
    (reference: discovery.py:79-134).

    The blacklist decays: with ``HOROVOD_ELASTIC_BLACKLIST_COOLDOWN``
    set, an entry expires after ``base * 2^(strikes-1)`` seconds
    (doubling per repeat offense, capped) and the host becomes
    re-admittable — it re-enters via the normal new-host append path,
    so the rank-stability ordering contract is untouched.  Base 0
    (default) keeps the legacy permanent blacklist.

    Scale-up admission: ``update_available_hosts(admit_new=False)``
    holds newly discovered hosts in a PENDING set instead of admitting
    them; the driver admits them explicitly (``admit_pending``) when
    its policy engine approves the resize.
    """

    def __init__(self, discovery: HostDiscovery,
                 cooldown_s: Optional[float] = None,
                 now=time.monotonic):
        self._current_hosts = OrderedDict()  # host -> slots, ordered
        self._discovery = discovery
        self._blacklist: Dict[str, _BlacklistEntry] = {}
        self._expired_strikes: Dict[str, int] = {}
        self._pending = OrderedDict()        # held for policy admission
        self._cooldown_s = cooldown_s        # None = read the knob
        self._now = now
        self._lock = threading.Lock()

    # -- blacklist ------------------------------------------------------
    def _base_cooldown(self) -> float:
        if self._cooldown_s is not None:
            return self._cooldown_s
        return env_mod.blacklist_cooldown()

    def _expire_blacklist_locked(self, now: float):
        for host, entry in list(self._blacklist.items()):
            if entry.until is not None and now >= entry.until:
                # Keep the strike count: re-offending doubles the next
                # sit-out instead of restarting the ladder.
                entry.until = None
                del self._blacklist[host]
                self._expired_strikes[host] = entry.strikes
                logger.info("blacklist cooldown expired for host %s "
                            "(strikes=%d); re-admittable", host,
                            entry.strikes)

    def blacklist(self, host: str):
        now = self._now()
        base = self._base_cooldown()
        with self._lock:
            strikes = self._expired_strikes.get(host, 0)
            entry = self._blacklist.get(host)
            if entry is not None:
                strikes = entry.strikes
            strikes += 1
            if base > 0:
                doublings = min(strikes - 1,
                                env_mod.BLACKLIST_MAX_STRIKE_DOUBLINGS)
                until = now + base * (2 ** doublings)
            else:
                until = None
            if entry is None:
                logger.warning(
                    "blacklisting host %s (strike %d, %s)", host,
                    strikes, "cooldown %.1fs" % (until - now)
                    if until is not None else "permanent")
            self._blacklist[host] = _BlacklistEntry(strikes, until)
            self._current_hosts.pop(host, None)
            self._pending.pop(host, None)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            self._expire_blacklist_locked(self._now())
            return host in self._blacklist

    def blacklist_info(self, host: str):
        """(strikes, seconds_remaining) for a blacklisted host, or
        None when the host is not (or no longer) blacklisted;
        seconds_remaining is None for a permanent entry."""
        with self._lock:
            self._expire_blacklist_locked(self._now())
            entry = self._blacklist.get(host)
            if entry is None:
                return None
            remaining = None if entry.until is None else \
                max(0.0, entry.until - self._now())
            return entry.strikes, remaining

    # -- discovery ------------------------------------------------------
    def update_available_hosts(self, admit_new: bool = True) -> bool:
        """Polls discovery; returns True when the available (ordered,
        non-blacklisted) host set changed.  ``admit_new=False`` holds
        newly discovered hosts PENDING (visible via
        ``pending_hosts()``) instead of admitting them — removals and
        slot-count changes on existing hosts still apply."""
        available = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            self._expire_blacklist_locked(self._now())
            prev = OrderedDict(
                (h, s) for h, s in self._current_hosts.items())
            # Keep surviving hosts in their existing order, then append
            # newly discovered hosts in discovery order.
            updated = OrderedDict()
            for host, slots in self._current_hosts.items():
                if host in available and host not in self._blacklist:
                    updated[host] = available[host]
            pending = OrderedDict()
            for host, slots in available.items():
                if host in updated or host in self._blacklist:
                    continue
                if admit_new:
                    updated[host] = slots
                else:
                    pending[host] = slots
            self._current_hosts = updated
            self._pending = pending
            return prev != updated

    def pending_hosts(self) -> "OrderedDict":
        """Discovered-but-unadmitted hosts (scale-up candidates)."""
        with self._lock:
            return OrderedDict(self._pending)

    def admit_pending(self,
                      max_slots: Optional[int] = None) -> List[str]:
        """Move pending hosts into the current set (appended, so
        existing ranks stay stable); returns the admitted names.
        ``max_slots`` caps the admitted slot count — the
        replacements-only path backfills lost capacity without
        growing the world past what the policy approved; unadmitted
        hosts stay pending."""
        with self._lock:
            admitted = []
            taken = 0
            for host, slots in list(self._pending.items()):
                if host in self._current_hosts or \
                        host in self._blacklist:
                    del self._pending[host]
                    continue
                if max_slots is not None and taken >= max_slots:
                    break  # deficit covered; a partial overshoot by
                    # the last host's extra slots is fine — a short
                    # world is the worse failure
                self._current_hosts[host] = slots
                del self._pending[host]
                admitted.append(host)
                taken += slots
            return admitted

    @property
    def current_hosts(self) -> "OrderedDict":
        with self._lock:
            return OrderedDict(self._current_hosts)

    def available_slots(self) -> int:
        with self._lock:
            return sum(self._current_hosts.values())
