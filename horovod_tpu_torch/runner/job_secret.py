"""Per-job shared secret + HMAC signing for control-plane RPC.

The reference HMAC-signs every driver/task service message with a
random per-job key so stray or malicious connections to the service
ports can't inject commands or read rendezvous state (reference:
runner/common/util/secret.py make_secret_key, network.py BasicService
_verify_message).  Here the same contract protects the rendezvous
HTTP KV store: launchers generate the key once, forward it through the
worker env (``HOROVOD_SECRET_KEY``), and both ends sign
``(method, path, body)`` with HMAC-SHA256.

A server started without a key (e.g. directly in a unit test) accepts
unsigned requests — the launcher paths always set one.

Counterpart of :mod:`horovod_tpu.runner.job_secret`, copied: the same
env name, headers, signing and freshness window, so a server of either
package accepts the other's signed requests.
"""

import base64
import hashlib
import hmac
import os
from typing import Optional

from ..common import env as env_mod

ENV = "HOROVOD_SECRET_KEY"
HEADER = "X-Horovod-Sig"
TS_HEADER = "X-Horovod-Ts"


def make_secret_key() -> str:
    """A fresh url-safe 256-bit key."""
    return base64.urlsafe_b64encode(os.urandom(32)).decode()


def current() -> Optional[str]:
    return env_mod.env_str_opt(ENV) or None


def for_job(env: Optional[dict] = None) -> str:
    """The key for ONE job launch: honor a caller/worker-provided key
    (``env`` dict or process env), else mint a fresh one.  Launchers
    hold the result in a local and thread it explicitly to their
    server and worker envs — deliberately NOT exported to os.environ,
    so two jobs launched from one driver process never share a key."""
    if env and env.get(ENV):
        return env[ENV]
    return current() or make_secret_key()


# Bound on |server clock - client timestamp|: replayed requests die
# after this window (full anti-replay would need per-request nonces;
# the window is the standard cheap mitigation for a LAN control plane).
MAX_SKEW_S = 900.0


def sign(secret: str, method: str, path: str, body: bytes,
         timestamp: str) -> str:
    mac = hmac.new(secret.encode(), digestmod=hashlib.sha256)
    for part in (method.encode(), path.encode(), body,
                 timestamp.encode()):
        # Length-prefix each field so ("PU","T/x") can't collide with
        # ("PUT","/x").
        mac.update(len(part).to_bytes(8, "big"))
        mac.update(part)
    return mac.hexdigest()


def ts_fresh(timestamp: Optional[str],
             max_skew_s: float = MAX_SKEW_S) -> bool:
    """Is the signed timestamp parseable and within the skew window?
    Shared by full verification and the server's pre-body-read gate so
    the freshness rule can never diverge between the two."""
    import time

    if not timestamp:
        return False
    try:
        ts = float(timestamp)
    except ValueError:
        return False
    return abs(time.time() - ts) <= max_skew_s


def verify(secret: str, signature: Optional[str], method: str,
           path: str, body: bytes, timestamp: Optional[str],
           max_skew_s: float = MAX_SKEW_S) -> bool:
    if not signature or not ts_fresh(timestamp, max_skew_s):
        return False
    try:
        expected = sign(secret, method, path, body, timestamp)
        return hmac.compare_digest(expected.encode(),
                                   signature.encode())
    except (UnicodeEncodeError, TypeError):
        # Attacker-controlled header bytes must yield False, not an
        # unhandled handler exception.
        return False
