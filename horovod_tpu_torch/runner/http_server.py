"""Rendezvous: threaded HTTP key-value store + client.

The control-plane rendezvous service the launcher runs on the driver
host (reference: runner/http/http_server.py:35-204 ``KVStoreHandler`` /
``RendezvousServer``).  Workers and driver communicate through scoped
keys:

    PUT  /scope/key     store a value
    GET  /scope/key     fetch (404 until present)
    DELETE /scope       finalize a scope (elastic: signal re-rendezvous)

Values are opaque bytes.  The elastic driver plugs in an extended
handler that answers ``GET /rank_and_size/<hostname>:<local_rank>``
from live host assignments (reference:
runner/elastic/rendezvous.py:28-55).

Counterpart of :mod:`horovod_tpu.runner.http_server`, copied: the same
wire format, job-secret guard and replay cache, so a client of either
package talks to a server of the other.  Failpoints come from the
port's ``common/failpoints.py``.
"""

import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.error import HTTPError
from urllib.request import Request as UrlRequest, urlopen

from ..common import failpoints as _fp
from . import job_secret

logger = logging.getLogger("horovod_tpu_torch.rendezvous")

OK = 200
NOT_FOUND = 404
BAD_REQUEST = 400
FORBIDDEN = 403
SERVER_ERROR = 500


class KVStore:
    """Scoped in-memory KV store shared by all handler threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, bytes]] = {}
        self._finalized: Dict[str, bool] = {}

    def put(self, scope: str, key: str, value: bytes):
        with self._lock:
            self._data.setdefault(scope, {})[key] = value

    def get(self, scope: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(scope, {}).get(key)

    def keys(self, scope: str):
        with self._lock:
            return list(self._data.get(scope, {}).keys())

    def finalize(self, scope: str):
        with self._lock:
            self._finalized[scope] = True

    def is_finalized(self, scope: str) -> bool:
        with self._lock:
            return self._finalized.get(scope, False)


class ReplayCache:
    """Signatures accepted within the HMAC skew window.  A signed
    request replayed by an eavesdropper (or a departed elastic worker)
    hits a cached entry and is rejected — full anti-replay on top of
    the timestamp window, bounded because entries expire with the
    window itself."""

    def __init__(self, window_s: float = job_secret.MAX_SKEW_S):
        import collections
        self._lock = threading.Lock()
        self._seen: Dict[str, float] = {}
        self._order = collections.deque()  # (accept time, sig)
        self._window = window_s

    def check_and_add(self, signature: str, now: float) -> bool:
        """True if the signature is fresh (and records it).  Entries
        are inserted in accept-time order, so expiry pops from the
        deque head — O(expired) per call, never a full rebuild."""
        with self._lock:
            horizon = now - 2 * self._window
            while self._order and self._order[0][0] <= horizon:
                t, s = self._order.popleft()
                if self._seen.get(s) == t:
                    del self._seen[s]
            if signature in self._seen:
                return False
            self._seen[signature] = now
            self._order.append((now, signature))
            return True


# Rendezvous values are addresses, host plans and pickled run results —
# small.  Bodies past this are rejected before the read so an
# unauthenticated client can't stream memory at the driver.
MAX_BODY_BYTES = 64 * 1024 * 1024


class KVStoreHandler(BaseHTTPRequestHandler):
    """Routes /scope/key to the server's KVStore.  Subclasses may
    override ``handle_get_special`` to serve computed scopes."""
    protocol_version = "HTTP/1.1"

    def _split(self) -> Optional[Tuple[str, str]]:
        parts = self.path.lstrip("/").split("/", 1)
        if len(parts) == 1:
            return parts[0], ""
        return parts[0], parts[1]

    def handle_get_special(self, scope: str, key: str) -> Optional[bytes]:
        return None

    def _authorized(self, body: bytes = b"") -> bool:
        """HMAC check against the server's job secret (reference:
        network.py BasicService message verification).  No secret on
        the server = open (direct/unit-test use); launchers always set
        one."""
        secret = getattr(self.server, "secret", None)
        if not secret:
            return True
        sig = self.headers.get(job_secret.HEADER)
        if job_secret.verify(secret, sig,
                             self.command, self.path, body,
                             self.headers.get(job_secret.TS_HEADER)):
            # Replay rejection applies to MUTATING methods only (the
            # threat is a replayed PUT poisoning a later re-rendezvous
            # round).  GETs are excluded deliberately: wait_get polls
            # the same path at 10 Hz from many workers, so two
            # pollers' time.time() floats can legitimately collide
            # into an identical signature — and caching read-only
            # requests buys nothing.
            if self.command == "GET":
                return True
            import time
            cache = getattr(self.server, "replay_cache", None)
            if cache is None or cache.check_and_add(sig, time.time()):
                return True
        return self._reject(FORBIDDEN)

    def _failpoint_gate(self) -> bool:
        """Failpoint site: one rendezvous KV request.  drop() closes
        the connection without answering (a lost datagram — clients
        retry); error() answers 500 (a driver-side fault — clients see
        HTTPError, an OSError, and their poll loops ride it out);
        delay() stalls the reply.  False = abort request handling."""
        if not _fp.ENABLED:
            return True
        try:
            if _fp.maybe_fail("rendezvous.request") == "drop":
                self.close_connection = True
                return False
        except _fp.FailpointError:
            return self._reject(SERVER_ERROR)
        return True

    def _reject(self, code: int) -> bool:
        # A rejected PUT may have unread body bytes on the socket;
        # keep-alive would misparse them as the next request line.
        self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()
        logger.warning("rejected %s %s from %s (%d)", self.command,
                       self.path, self.client_address[0], code)
        return False

    def _precheck_put(self, length: int) -> bool:
        """Cheap gates BEFORE the body read: size cap plus
        header-presence/timestamp-freshness checks.  The HMAC itself
        covers the body, so full verification necessarily happens
        after the read — this bounds, not eliminates, what an
        unauthenticated client can make us buffer (<= MAX_BODY_BYTES
        per connection)."""
        if length > MAX_BODY_BYTES or length < 0:
            return self._reject(BAD_REQUEST)
        secret = getattr(self.server, "secret", None)
        if not secret:
            return True
        if not self.headers.get(job_secret.HEADER) or \
                not job_secret.ts_fresh(
                    self.headers.get(job_secret.TS_HEADER)):
            return self._reject(FORBIDDEN)
        return True

    def do_GET(self):
        if not self._failpoint_gate() or not self._authorized():
            return
        scope, key = self._split()
        special = self.handle_get_special(scope, key)
        if special is None and key == "__keys__":
            # Scope listing: one request replaces O(world) per-key
            # polls in gather loops (checkpoint prepare marks, elastic
            # lost-rank notices).  Reserved key; real keys never use
            # the dunder form.
            import json as _json
            special = _json.dumps(sorted(
                self.server.kvstore.keys(scope))).encode()
        value = special if special is not None \
            else self.server.kvstore.get(scope, key)
        if value is None:
            self.send_response(NOT_FOUND)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(OK)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_PUT(self):
        if not self._failpoint_gate():
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._reject(BAD_REQUEST)
            return
        if not self._precheck_put(length):
            return
        value = self.rfile.read(length)
        if not self._authorized(value):
            return
        scope, key = self._split()
        self.server.kvstore.put(scope, key, value)
        self.send_response(OK)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):
        if not self._failpoint_gate() or not self._authorized():
            return
        scope, _ = self._split()
        self.server.kvstore.finalize(scope)
        self.send_response(OK)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, fmt, *args):  # quiet by default
        logger.debug("rendezvous: " + fmt, *args)


class RendezvousServer:
    """Threaded HTTP KV server; ``start()`` returns the bound port."""

    def __init__(self, verbose: int = 0,
                 handler_cls=KVStoreHandler, port: int = 0,
                 secret: Optional[str] = None):
        self._verbose = verbose
        self._handler_cls = handler_cls
        self._requested_port = port
        # Per-job HMAC key (explicit beats env so two jobs launched
        # from one driver process never share a key); None + no env =
        # open server (direct construction in tests).
        self._secret = secret if secret is not None \
            else job_secret.current()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def kvstore(self) -> Optional[KVStore]:
        return self._httpd.kvstore if self._httpd else None

    def start(self, handler_cls=None) -> int:
        cls = handler_cls or self._handler_cls
        self._httpd = ThreadingHTTPServer(
            ("0.0.0.0", self._requested_port), cls)
        self._httpd.kvstore = KVStore()
        self._httpd.secret = self._secret
        self._httpd.replay_cache = ReplayCache()
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="hvd-rendezvous", daemon=True)
        self._thread.start()
        port = self._httpd.server_address[1]
        logger.debug("rendezvous server listening on %d", port)
        return port

    # Elastic swaps assignments without restarting the server.
    def init(self, host_assignments=None):
        if self._httpd is not None:
            self._httpd.host_assignments = host_assignments or {}

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class RendezvousClient:
    """Tiny blocking HTTP client for the KV store.  Signs every
    request with the job secret (``HOROVOD_SECRET_KEY``, forwarded by
    the launcher env contract) when one is present."""

    def __init__(self, addr: str, port: int, timeout: float = 30.0,
                 secret: Optional[str] = None):
        self._base = f"http://{addr}:{port}"
        self._timeout = timeout
        self._secret = secret if secret is not None \
            else job_secret.current()

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None) -> UrlRequest:
        req = UrlRequest(self._base + path, data=body, method=method)
        if self._secret:
            import time
            ts = repr(time.time())
            req.add_header(job_secret.TS_HEADER, ts)
            req.add_header(job_secret.HEADER,
                           job_secret.sign(self._secret, method, path,
                                           body or b"", ts))
        return req

    def put(self, scope: str, key: str, value: bytes):
        req = self._request("PUT", f"/{scope}/{key}", value)
        with urlopen(req, timeout=self._timeout):
            pass

    def get(self, scope: str, key: str) -> Optional[bytes]:
        try:
            req = self._request("GET", f"/{scope}/{key}")
            with urlopen(req, timeout=self._timeout) as r:
                return r.read()
        except HTTPError as e:
            if e.code == NOT_FOUND:
                return None
            raise

    def keys(self, scope: str):
        """List the scope's keys in ONE request (the ``__keys__``
        special key) — gather loops use it to poll O(1) instead of
        one GET per expected rank per tick."""
        import json as _json
        raw = self.get(scope, "__keys__")
        if raw is None:
            return []
        try:
            return [str(k) for k in _json.loads(raw.decode())]
        except (ValueError, UnicodeDecodeError):
            return []

    def wait_get(self, scope: str, key: str,
                 timeout: float = 120.0) -> bytes:
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            v = self.get(scope, key)
            if v is not None:
                return v
            time.sleep(0.1)
        raise TimeoutError(f"rendezvous key {scope}/{key} never appeared")

    def delete(self, scope: str):
        req = self._request("DELETE", f"/{scope}/")
        with urlopen(req, timeout=self._timeout):
            pass


def find_port() -> int:
    return find_ports(1)[0]


def find_ports(n: int):
    """n distinct free ports; all sockets held open until every port is
    chosen so the same port can't be handed out twice."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def local_addresses():
    """Best-effort list of this host's non-loopback IPv4 addresses."""
    addrs = set()
    try:
        hostname = socket.gethostname()
        for info in socket.getaddrinfo(hostname, None, socket.AF_INET):
            addrs.add(info[4][0])
    except socket.gaierror:
        pass
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("8.8.8.8", 80))
        addrs.add(s.getsockname()[0])
        s.close()
    except OSError:
        pass
    addrs.discard("127.0.0.1")
    return sorted(addrs) or ["127.0.0.1"]
