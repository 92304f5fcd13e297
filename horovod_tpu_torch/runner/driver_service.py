"""Routable-interface discovery for multi-host launches.

Reference: runner/driver/driver_service.py:185-266 +
get_common_interfaces — the driver spawns task services on every host
and the tasks probe each other's network interfaces pairwise to find
NICs routable by all hosts, so rendezvous traffic never binds to an
address some worker cannot reach.  Here the driver binds ONE probe
server on all interfaces, ships a short self-contained probe client to
each remote host over the launcher's ssh channel, and keeps the
candidate addresses every host could connect to.  Multi-NIC GPU hosts
(a management NIC beside the data NICs) are common, so the probe removes
the guess.

Counterpart of :mod:`horovod_tpu.runner.driver_service`, copied.
"""

import logging
import shlex
import socket
import subprocess
import threading
import uuid
from typing import Callable, List, Optional, Sequence

logger = logging.getLogger("horovod_tpu_torch.runner")

PROBE_TIMEOUT_S = 5.0

# Self-contained probe client: tries every candidate ip:port, prints
# the ones whose probe server echoes the token back.
_PROBE_CLIENT = r"""
import socket, sys
token = sys.argv[1].encode()
port = int(sys.argv[2])
ok = []
for ip in sys.argv[3:]:
    try:
        s = socket.create_connection((ip, port), timeout={timeout})
        s.sendall(token)
        if s.recv(64) == token:
            ok.append(ip)
        s.close()
    except OSError:
        pass
print("PROBE_OK " + ",".join(ok))
"""


class ProbeServer:
    """Echo server on all interfaces: a client that sends the expected
    token gets it echoed back (token guards against port collisions
    with unrelated services)."""

    def __init__(self, token: str):
        self._token = token.encode()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-probe-server")
        self._thread.start()

    def _loop(self):
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(PROBE_TIMEOUT_S)
                data = conn.recv(64)
                if data == self._token:
                    conn.sendall(data)
            except OSError:
                pass
            finally:
                conn.close()

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


def probe_host(host_cmd_fn: Callable[[str], str], candidates,
               port: int, token: str,
               timeout: float = PROBE_TIMEOUT_S) -> List[str]:
    """Run the probe client on one host (via the launcher's remote
    shell) and return the candidate addresses it could reach."""
    client = _PROBE_CLIENT.format(timeout=timeout)
    inner = "python3 -c {} {} {} {}".format(
        shlex.quote(client), shlex.quote(token), port,
        " ".join(shlex.quote(c) for c in candidates))
    cmd = host_cmd_fn(inner)
    try:
        out = subprocess.run(cmd, shell=True, capture_output=True,
                             timeout=timeout * len(candidates) + 30)
    except subprocess.TimeoutExpired:
        return []
    for line in out.stdout.decode(errors="replace").splitlines():
        if line.startswith("PROBE_OK"):
            rest = line[len("PROBE_OK"):].strip()
            return [a for a in rest.split(",") if a]
    return []


def discover_routable_ip(candidates: Sequence[str],
                         remote_hosts: Sequence[str],
                         host_cmd_fn: Callable[[str, str], str],
                         verbose: int = 0) -> Optional[str]:
    """The first candidate address of THIS machine reachable from every
    remote host (reference get_common_interfaces semantics). Returns
    None when no candidate survives (callers fall back to the first
    local address and the launch proceeds best-effort).

    ``host_cmd_fn(hostname, command) -> shell line`` is the launcher's
    remote execution channel (ssh).
    """
    candidates = [c for c in candidates if c != "127.0.0.1"]
    if not candidates or not remote_hosts:
        return candidates[0] if candidates else None
    token = uuid.uuid4().hex
    server = ProbeServer(token)
    try:
        # Per-host probes are independent; run them concurrently so
        # launch latency is bounded by the slowest host, not the sum.
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(len(remote_hosts),
                                                32)) as pool:
            futures = {
                host: pool.submit(
                    probe_host,
                    lambda cmd, h=host: host_cmd_fn(h, cmd),
                    candidates, server.port, token)
                for host in remote_hosts
            }
            alive = set(candidates)
            for host, fut in futures.items():
                reachable = fut.result()
                alive &= set(reachable)
                if verbose:
                    logger.info("NIC probe: %s reaches %s", host,
                                sorted(reachable))
    finally:
        server.stop()
    if not alive:
        logger.warning(
            "no candidate address (%s) is reachable from all hosts %s; "
            "falling back to the first local address",
            candidates, list(remote_hosts))
        return None
    # Deterministic pick: candidate order (local_addresses is sorted).
    for c in candidates:
        if c in alive:
            return c
    return None
