"""Static launch: spawn one worker process per slot.

Counterpart of :mod:`horovod_tpu.runner.tpu_run` and of the reference's
Gloo launcher (reference: runner/gloo_run.py:226-273 ``launch_gloo``):
compute the slot plan, start the rendezvous KV server on the driver,
then exec the training command once per slot — locally via a
subprocess, remotely via ssh — with the full rank env contract.  There
is no MPI path: the control plane is TCP/HTTP, the data plane is one
``torch.distributed`` process group (NCCL or gloo) once workers call
``hvd.init()``.

Worker env contract per slot (beyond the rank vars of
``hosts.slot_env_vars``):

    HOROVOD_GLOO_RENDEZVOUS_ADDR / _PORT   driver KV store
    HOROVOD_TPU_COORDINATOR                torch.distributed TCP store
                                           (rank-0 host:port)
    HOROVOD_CONTROLLER_ADDR                rank-0 negotiation TCP server
    HOROVOD_CONTROLLER=tcp                 controller kind

Cards: the launcher does not narrow ``CUDA_VISIBLE_DEVICES`` per slot.
Every worker sees all of its host's cards and takes card
``local_rank % device_count`` at init (``common/basics.py``), and the
transport of CUDA tensors compares ``local_size`` with the card count
(``ops/dist_ops.py:cuda_transport``).  With one visible card per
process, two ranks on two cards would count one card each and fall back
to gloo.
"""

import functools
import logging
import os
import shlex
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ..common import env as env_mod
from . import safe_shell_exec
from .hosts import SlotInfo, get_host_assignments, parse_hosts, \
    slot_env_vars
from . import job_secret
from .http_server import RendezvousServer, find_ports, local_addresses

logger = logging.getLogger("horovod_tpu_torch.run")

# A pre-provisioned rendezvous port, for schedulers that must know ports
# up front (reference: the Determined fork's
# PEDL_HOROVOD_GLOO_RENDEZVOUS_PORT hook, runner/gloo_run.py:250).
PREPROVISIONED_PORT_ENV = "HOROVOD_TPU_RENDEZVOUS_PORT"

_LOCAL_HOSTNAMES = ("localhost", "127.0.0.1")


@functools.lru_cache(maxsize=1)
def _local_addresses_cached():
    return tuple(local_addresses())


def is_local(hostname: str) -> bool:
    import socket
    return hostname in _LOCAL_HOSTNAMES or \
        hostname == socket.gethostname() or \
        hostname in _local_addresses_cached()


def nic_env(nics: str) -> Dict[str, str]:
    """The worker env that binds both planes to ``--network-interface``:
    ``HOROVOD_GLOO_IFACE`` for the control plane (as the JAX package
    exports it), ``GLOO_SOCKET_IFNAME`` (the first NIC) for
    ``torch.distributed``'s gloo, and ``NCCL_SOCKET_IFNAME`` (the whole
    list) for NCCL's bootstrap — the list upstream Horovod's gloo
    launcher exports as ``NCCL_SOCKET_IFNAME``."""
    names = [n.strip() for n in nics.split(",") if n.strip()]
    if not names:
        raise ValueError(f"--network-interface: no interface in {nics!r}")
    return {env_mod.HOROVOD_IFACE: nics,
            "GLOO_SOCKET_IFNAME": names[0],
            "NCCL_SOCKET_IFNAME": ",".join(names)}


def _ssh_command(hostname: str, command: str, ssh_port: Optional[int],
                 ssh_identity_file: Optional[str]) -> str:
    opts = "-o StrictHostKeyChecking=no -o BatchMode=yes"
    if ssh_port:
        opts += f" -p {ssh_port}"
    if ssh_identity_file:
        opts += f" -i {shlex.quote(ssh_identity_file)}"
    return f"ssh {opts} {hostname} {shlex.quote(command)}"


def _exportable(key: str, value: str) -> bool:
    return not key.startswith("BASH_FUNC_") and key != "LS_COLORS" and \
        "\n" not in value and key != "_"


def slot_command(run_command: str, slot: SlotInfo, env: Dict[str, str],
                 common_env: Dict[str, str]) -> str:
    """Build the full shell line for one slot (env assignments inlined
    so the contract survives the ssh hop, reference gloo_run.py:79-101).
    """
    slot_env = dict(common_env)
    slot_env.update(slot_env_vars(slot))
    slot_env["PYTHONUNBUFFERED"] = "1"
    slot_env.pop(job_secret.ENV, None)
    assigns = " ".join(f"{k}={shlex.quote(str(v))}"
                       for k, v in slot_env.items())
    # The HMAC key never rides the command line (world-readable via
    # /proc/*/cmdline locally); the caller transports it via the
    # subprocess env or the ssh channel.
    fwd = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items()
                   if _exportable(k, v) and k not in slot_env and
                   k != job_secret.ENV)
    return f"{assigns} {fwd} {run_command}"


def secret_transport(cmd: str, secret: str, local: bool):
    """(command, exec_env, stdin_data) that keeps the job key off every
    argv: a local worker gets it via the subprocess environment; a
    remote worker's far-side shell reads it from the ssh channel's
    stdin (``read`` consumes one line before exec'ing the real
    command), so neither the driver's ssh argv nor the remote argv
    ever carries the key (/proc/*/cmdline is world-readable on both
    ends)."""
    if local:
        exec_env = dict(os.environ)
        exec_env[job_secret.ENV] = secret
        return cmd, exec_env, None
    wrapped = (f"IFS= read -r {job_secret.ENV}; "
               f"export {job_secret.ENV}; {cmd}")
    return wrapped, None, (secret + "\n").encode()


def _pass_on_sigterm(event: threading.Event):
    """Make a SIGTERM to the launcher set ``event`` instead of killing
    it; returns the handler it replaced, or None off the main thread."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def _on_term(signum, frame):
        logger.warning("SIGTERM: passing it on to every worker")
        event.set()
    return signal.signal(signal.SIGTERM, _on_term)


class WorkerResults:
    """Collects per-slot exit codes; any non-zero marks failure."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._codes: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.any_failed = threading.Event()

    def record(self, rank: int, code: int):
        with self._lock:
            self._codes[rank] = code
        if code != 0:
            self.any_failed.set()

    @property
    def exit_codes(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._codes)


def launch_static(command: List[str],
                  hosts: str,
                  np: int,
                  env: Optional[Dict[str, str]] = None,
                  ssh_port: Optional[int] = None,
                  ssh_identity_file: Optional[str] = None,
                  output_filename: Optional[str] = None,
                  verbose: int = 0,
                  server_ip: Optional[str] = None,
                  kill_all_on_failure: bool = True,
                  extra_worker_env: Optional[Dict[str, str]] = None,
                  start_timeout: Optional[int] = None,
                  ) -> Dict[int, int]:
    """Run ``command`` on ``np`` slots of ``hosts``; block until all
    workers exit.  Returns {rank: exit_code}."""
    host_infos = parse_hosts(hosts)
    slots = get_host_assignments(host_infos, np, np)
    rank0_host = slots[0].hostname

    requested = env_mod.env_int(PREPROVISIONED_PORT_ENV, 0)
    # Per-job HMAC key: the server requires it on every request, the
    # env contract hands it to workers (reference secret.py/network.py).
    secret = job_secret.for_job(env)
    server = RendezvousServer(verbose, port=requested, secret=secret)
    rendezvous_port = server.start()
    server.init({})

    all_local = all(is_local(s.hostname) for s in slots)
    if server_ip:
        driver_ip = server_ip
    elif all_local:
        driver_ip = "127.0.0.1"
    else:
        # Probe which local address every remote host can actually
        # reach (reference: runner/driver/driver_service.py NIC
        # discovery) instead of guessing the first one.
        from .driver_service import discover_routable_ip
        remote = sorted({s.hostname for s in slots
                         if not is_local(s.hostname)})
        driver_ip = discover_routable_ip(
            local_addresses(), remote,
            lambda h, cmd: _ssh_command(h, cmd, ssh_port,
                                        ssh_identity_file),
            verbose=verbose) or local_addresses()[0]
    # Rank 0 hosts the torch.distributed store and the negotiation TCP
    # server; remote workers need a routable address for it.  When rank
    # 0 runs on the driver host, the driver's routable IP is that
    # address; otherwise the (remote) hostname itself is.
    if is_local(rank0_host):
        rank0_addr = "127.0.0.1" if all_local else driver_ip
    else:
        rank0_addr = rank0_host

    common_env = {
        env_mod.HOROVOD_RENDEZVOUS_ADDR: driver_ip,
        env_mod.HOROVOD_RENDEZVOUS_PORT: str(rendezvous_port),
        env_mod.HOROVOD_CONTROLLER: "tcp",
    }
    if is_local(rank0_host):
        # Rank 0 binds on this machine, so ports probed here are valid.
        coordinator_port, controller_port = find_ports(2)
        common_env[env_mod.HOROVOD_TPU_COORDINATOR] = \
            f"{rank0_addr}:{coordinator_port}"
        common_env["HOROVOD_CONTROLLER_ADDR"] = \
            f"{rank0_addr}:{controller_port}"
    else:
        # Rank 0 is remote: a port free here may be taken there.  The
        # rank-0 worker picks its own ports and publishes them through
        # the rendezvous KV (runner/endpoints.py); workers resolve at
        # init.
        common_env["HOROVOD_RANK0_ADDR"] = rank0_addr
    if start_timeout:
        # Bounds how long workers wait for each other at init
        # (consumed through env.start_timeout(): the controller
        # connect loop, rendezvous lookups, the process group's store
        # and the formation deadline).
        common_env[env_mod.HOROVOD_START_TIMEOUT] = str(start_timeout)
    if extra_worker_env:
        common_env.update(extra_worker_env)

    run_command = " ".join(shlex.quote(c) for c in command)
    results = WorkerResults(len(slots))
    events = [results.any_failed] if kill_all_on_failure else []
    # A preemption's SIGTERM to the launcher goes on to every worker's
    # tree (SIGTERM, then SIGKILL after the preemption hook's grace), and
    # the launcher lives until they exit: their final checkpoint commit
    # needs its rendezvous KV.  Then the launcher's own TERM applies.
    preempted = threading.Event()
    events.append(preempted)
    previous_term = _pass_on_sigterm(preempted)

    def _run_slot(slot: SlotInfo):
        cmd = slot_command(run_command, slot, env or dict(os.environ),
                           common_env)
        local = is_local(slot.hostname)
        cmd, exec_env, stdin_data = secret_transport(cmd, secret, local)
        if not local:
            cmd = _ssh_command(slot.hostname, cmd, ssh_port,
                               ssh_identity_file)
        stdout = stderr = None
        if output_filename:
            d = os.path.join(output_filename, f"rank.{slot.rank}")
            os.makedirs(d, exist_ok=True)
            stdout = open(os.path.join(d, "stdout"), "w")
            stderr = open(os.path.join(d, "stderr"), "w")
        if verbose:
            logger.info("launching rank %d on %s", slot.rank,
                        slot.hostname)
        try:
            code = safe_shell_exec.execute(
                cmd, env=exec_env, stdin_data=stdin_data,
                stdout=stdout, stderr=stderr, index=slot.rank,
                events=events, event_grace_s={
                    preempted: safe_shell_exec.PREEMPTION_TERMINATION_TIME_S})
        finally:
            for f in (stdout, stderr):
                if f:
                    f.close()
        results.record(slot.rank, code)

    threads = [threading.Thread(target=_run_slot, args=(s,), daemon=True)
               for s in slots]
    start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.stop()
    if previous_term is not None:
        signal.signal(signal.SIGTERM, previous_term)
        if preempted.is_set():
            signal.raise_signal(signal.SIGTERM)
    codes = results.exit_codes
    if verbose:
        logger.info("all workers finished in %.1fs: %s",
                    time.monotonic() - start, codes)
    failed = {r: c for r, c in codes.items() if c != 0}
    if failed:
        raise RuntimeError(
            "Horovod run failed: non-zero exit codes %s" % failed)
    return codes


# ---------------------------------------------------------------------------
# programmatic run(): ship a pickled function, collect per-rank results
# (reference: runner/__init__.py:91-206 + launch.py:604-623 run_func)
# ---------------------------------------------------------------------------
_FUNC_SCOPE = "runfunc"


def _cloudpickle():
    try:
        import cloudpickle
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.runner.run needs the cloudpickle package to "
            "ship the function to the workers; install cloudpickle") from e
    return cloudpickle


def _worker_main():
    """Entry executed by every slot of a ``run(func)`` launch."""
    cloudpickle = _cloudpickle()
    from .http_server import RendezvousClient
    addr = env_mod.env_require(env_mod.HOROVOD_RENDEZVOUS_ADDR)
    port = int(env_mod.env_require(env_mod.HOROVOD_RENDEZVOUS_PORT))
    rank = int(env_mod.env_require(env_mod.HOROVOD_RANK))
    client = RendezvousClient(addr, port)
    func = cloudpickle.loads(client.wait_get(_FUNC_SCOPE, "func"))
    result = func()
    client.put(_FUNC_SCOPE, f"result_{rank}", cloudpickle.dumps(result))


def run_func(func: Callable, hosts: str, np: int,
             env: Optional[Dict[str, str]] = None,
             verbose: int = 0, use_mpi=None, use_gloo=None,
             **kwargs) -> List:
    """Run ``func()`` on every rank; return results ordered by rank."""
    cloudpickle = _cloudpickle()
    from .http_server import RendezvousClient

    host_infos = parse_hosts(hosts)
    slots = get_host_assignments(host_infos, np, np)

    secret = job_secret.for_job(env)
    server = RendezvousServer(verbose, secret=secret)
    rendezvous_port = server.start()
    server.init({})
    driver_ip = "127.0.0.1" if all(is_local(s.hostname) for s in slots) \
        else local_addresses()[0]
    client = RendezvousClient(driver_ip, rendezvous_port, secret=secret)
    client.put(_FUNC_SCOPE, "func", cloudpickle.dumps(func))

    command = [sys.executable, "-m", "horovod_tpu_torch.runner.gpu_run"]
    worker_env = dict(env or os.environ)
    worker_env[job_secret.ENV] = secret
    worker_env.setdefault("PYTHONPATH", os.pathsep.join(sys.path))
    try:
        # The static launcher runs its own rendezvous server for worker
        # coordination; results flow through ours.
        launch_static(command, hosts, np, env=worker_env,
                      verbose=verbose,
                      extra_worker_env={
                          "HOROVOD_RUNFUNC_ADDR": driver_ip,
                          "HOROVOD_RUNFUNC_PORT": str(rendezvous_port)},
                      **kwargs)
        results = []
        for slot in slots:
            raw = client.wait_get(_FUNC_SCOPE, f"result_{slot.rank}",
                                  timeout=30.0)
            results.append(cloudpickle.loads(raw))
        return results
    finally:
        server.stop()


if __name__ == "__main__":
    # `python -m horovod_tpu_torch.runner.gpu_run` = run_func worker entry.
    if env_mod.env_set("HOROVOD_RUNFUNC_ADDR"):
        os.environ[env_mod.HOROVOD_RENDEZVOUS_ADDR] = \
            env_mod.env_require("HOROVOD_RUNFUNC_ADDR")
        os.environ[env_mod.HOROVOD_RENDEZVOUS_PORT] = \
            env_mod.env_require("HOROVOD_RUNFUNC_PORT")
    _worker_main()
