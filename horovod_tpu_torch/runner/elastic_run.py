"""Elastic launch: drive a command across a changing host set.

The analog of the reference's ``gloo_run_elastic``/``launch_gloo_elastic``
(reference: runner/gloo_run.py:288-337): start the rendezvous server
with the elastic handler, start the ElasticDriver, and let it spawn one
worker process per slot — locally via subprocess, remotely via ssh —
with the elastic env contract.  Unlike static runs, rank identity is NOT
in the spawn env: workers fetch it from the rendezvous server at every
(re)init, so the same process can change rank/size across epochs.

Counterpart of :mod:`horovod_tpu.runner.elastic_run`, copied over
``runner/gpu_run.py``.  As in the static launch, ``CUDA_VISIBLE_DEVICES``
is not narrowed per slot.
"""

import logging
import os
import shlex
import time
from typing import Dict, List, Optional

from .._alias import worker_pythonpath
from ..common import env as env_mod
from . import safe_shell_exec
from .hosts import SlotInfo
from . import job_secret
from .http_server import RendezvousServer, local_addresses
from .elastic.discovery import HostDiscovery
from .elastic.driver import ElasticDriver
from .elastic.rendezvous import ElasticRendezvousHandler
from .gpu_run import (PREPROVISIONED_PORT_ENV, _exportable,
                      _ssh_command, is_local, secret_transport)

logger = logging.getLogger("horovod_tpu_torch.elastic")


def launch_elastic(command: List[str],
                   discovery: HostDiscovery,
                   np: Optional[int],
                   min_np: int,
                   max_np: Optional[int] = None,
                   reset_limit: Optional[int] = None,
                   elastic_timeout: float = 600,
                   ssh_port: Optional[int] = None,
                   ssh_identity_file: Optional[str] = None,
                   output_filename: Optional[str] = None,
                   verbose: int = 0,
                   extra_worker_env: Optional[Dict[str, str]] = None,
                   env: Optional[Dict[str, str]] = None,
                   ) -> Dict[str, int]:
    """Run ``command`` elastically; returns {host:slot: exit_code}."""
    requested = env_mod.env_int(PREPROVISIONED_PORT_ENV, 0)
    secret = job_secret.for_job(env)
    server = RendezvousServer(verbose, handler_cls=ElasticRendezvousHandler,
                              port=requested, secret=secret)
    rendezvous_port = server.start()
    server.init({})

    driver = ElasticDriver(server, discovery, min_np=min_np, max_np=max_np,
                           timeout=elastic_timeout,
                           reset_limit=reset_limit, verbose=verbose)
    server._httpd.elastic_driver = driver

    run_command = " ".join(shlex.quote(c) for c in command)
    base_env = dict(env or os.environ)

    def create_worker(slot: SlotInfo) -> int:
        local = is_local(slot.hostname)
        # Per-worker: a local worker reaches the rendezvous via
        # loopback, a remote one needs this host's routable address —
        # resolved per spawn since hosts join over time.
        driver_ip = "127.0.0.1" if local else local_addresses()[0]
        worker_env = {
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_HOSTNAME": slot.hostname,
            "HOROVOD_LOCAL_RANK": str(slot.local_rank),
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": driver_ip,
            "HOROVOD_GLOO_RENDEZVOUS_PORT": str(rendezvous_port),
            "HOROVOD_CONTROLLER": "tcp",
            "PYTHONUNBUFFERED": "1",
        }
        if extra_worker_env:
            worker_env.update(extra_worker_env)
        # The port's `horovod` alias first (see gpu_run.slot_command).
        worker_env["PYTHONPATH"] = worker_pythonpath(
            worker_env.get("PYTHONPATH", base_env.get("PYTHONPATH")))
        assigns = " ".join(f"{k}={shlex.quote(str(v))}"
                           for k, v in worker_env.items())
        fwd = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in base_env.items()
                       if _exportable(k, v) and k not in worker_env and
                       k != job_secret.ENV)
        cmd = f"{assigns} {fwd} {run_command}"
        cmd, exec_env, stdin_data = secret_transport(cmd, secret, local)
        if not local:
            cmd = _ssh_command(slot.hostname, cmd, ssh_port,
                               ssh_identity_file)
        stdout = stderr = None
        if output_filename:
            d = os.path.join(output_filename,
                             f"{slot.hostname}.{slot.local_rank}")
            os.makedirs(d, exist_ok=True)
            stdout = open(os.path.join(d, "stdout"), "w")
            stderr = open(os.path.join(d, "stderr"), "w")
        if verbose:
            logger.info("elastic: launching %s:%d", slot.hostname,
                        slot.local_rank)
        try:
            return safe_shell_exec.execute(
                cmd, env=exec_env, stdin_data=stdin_data,
                stdout=stdout, stderr=stderr, index=slot.rank)
        finally:
            for f in (stdout, stderr):
                if f:
                    f.close()

    start = time.monotonic()
    try:
        driver.start(np, create_worker)
        driver.join()
        if driver.error_message:
            raise RuntimeError(driver.error_message)
        # Historical non-zero exits (a crashed worker the run recovered
        # from) are not failures; the driver's error_message is the
        # verdict.  Results are returned for inspection.
        results = driver.get_results()
        if verbose:
            logger.info("all workers finished in %.1fs: %s",
                        time.monotonic() - start, results)
        return results
    finally:
        driver.stop()
        server.stop()
