"""Job-secret-HMAC-guarded HTTP lookup endpoint for the serving plane.

Counterpart of :mod:`horovod_tpu.serve.server`, with the same contract.
The replica answers on the device; the handler copies only the answered
rows to the host to encode them.

Reuses the rendezvous KV server's handler plumbing exactly like the
/metrics//status//profile endpoints do (common/metrics.py
``MetricsServer`` is the template): same ``KVStoreHandler`` base, same
HMAC guard (``job_secret`` — embeddings are trained model state, never
an unauthenticated sidechannel), same no-secret-serves-openly
unit-test semantics, same 404-bare / 403-unsigned / 200-signed
contract the auth-parity tests pin.

Protocol — ``POST /lookup`` with a JSON body::

    {"table": "cat0", "ids": [3, 5, 3]}                 # raw rows
    {"table": "cat0", "ids": [...], "offsets": [0, 2],
     "mode": "sum"}                                     # pooled bags

answers 200 with ``{"table", "step", "rows"}`` where ``step`` is the
served-step stamp (every row is the committed value at exactly that
training step), 400 on malformed bodies or out-of-range ids, 404 on
unknown tables (or when no replica is wired), and 503 when the
staleness bound rejects the read (the freshness contract surfaced as
backpressure).  ``GET /freshness`` reports the served/latest steps
and table inventory.
"""

import json
import logging
import threading
from typing import Optional

from .replica import ServingReplica, StalenessError

logger = logging.getLogger("horovod_tpu_torch.serve")

SERVICE_UNAVAILABLE = 503


class ServeServer:
    """Threaded HTTP front end over one :class:`ServingReplica`."""

    def __init__(self, replica: Optional[ServingReplica],
                 port: int = 0, secret: Optional[str] = None):
        from http.server import ThreadingHTTPServer

        from ..runner import job_secret
        from ..runner.http_server import (BAD_REQUEST, NOT_FOUND, OK,
                                          KVStoreHandler, ReplayCache)

        self._replica = replica
        server_self = self

        class _ServeHandler(KVStoreHandler):
            def _send_json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if not self._authorized():
                    return
                path = self.path.split("?", 1)[0].rstrip("/")
                replica = server_self._replica
                if path != "/freshness" or replica is None:
                    self.send_response(NOT_FOUND)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                served, latest = replica.freshness()
                self._send_json(OK, {
                    "served_step": served,
                    "latest_step": latest,
                    "tables": replica.table_names(),
                })

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._reject(BAD_REQUEST)
                    return
                if not self._precheck_put(length):
                    return
                body = self.rfile.read(length)
                if not self._authorized(body):
                    return
                path = self.path.split("?", 1)[0].rstrip("/")
                replica = server_self._replica
                if path != "/lookup" or replica is None:
                    self.send_response(NOT_FOUND)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                try:
                    req = json.loads(body.decode("utf-8"))
                    table = req["table"]
                    ids = req["ids"]
                except (ValueError, KeyError, UnicodeDecodeError, TypeError):
                    self._reject(BAD_REQUEST)
                    return
                try:
                    if req.get("offsets") is not None:
                        rows, step = replica.embedding_bag(
                            table, ids, req["offsets"],
                            mode=req.get("mode", "sum"))
                    else:
                        rows, step = replica.lookup(table, ids)
                except StalenessError as e:
                    self._send_json(SERVICE_UNAVAILABLE,
                                    {"error": str(e)})
                    return
                except KeyError:
                    self.send_response(NOT_FOUND)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                except (IndexError, ValueError, TypeError) as e:
                    logger.debug("bad lookup request: %s", e)
                    self._reject(BAD_REQUEST)
                    return
                self._send_json(OK, {
                    "table": table,
                    "step": step,
                    "rows": rows.cpu().tolist(),
                })

            def do_PUT(self):
                self._reject(405)

            def do_DELETE(self):
                self._reject(405)

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port),
                                          _ServeHandler)
        self._httpd.kvstore = None
        self._httpd.secret = secret if secret is not None \
            else job_secret.current()
        self._httpd.replay_cache = ReplayCache()
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-serve-http",
            daemon=True)
        self._thread.start()
        logger.debug("serve endpoint listening on %d", self.port)

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
