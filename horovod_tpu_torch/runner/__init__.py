"""horovod_tpu_torch.runner — the launcher.

Counterpart of :mod:`horovod_tpu.runner`, less ``tpu_metadata`` (no TPU
pod metadata on a GPU host).  ``horovodrun`` CLI (:mod:`.launch`,
``python -m horovod_tpu_torch.runner.launch``), static multi-host
launch (:mod:`.gpu_run`), elastic launch (:mod:`.elastic_run`,
:mod:`.elastic`), rendezvous KV service (:mod:`.http_server`), and the
programmatic API:

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.runner import run

    def train():
        hvd.init()
        ...
        return final_metric

    results = run(train, np=4)   # list of per-rank return values

Reference parity: runner/launch.py (CLI), runner/gloo_run.py (launch),
runner/__init__.py:91-206 (programmatic run).
"""

from typing import Callable, List, Optional

from .hosts import (HostInfo, SlotInfo, get_host_assignments,
                    parse_hosts, parse_host_files, slot_env_vars)
from .http_server import (KVStore, KVStoreHandler, RendezvousClient,
                          RendezvousServer, find_port)

__all__ = [
    "run", "run_commandline",
    "HostInfo", "SlotInfo", "parse_hosts", "parse_host_files",
    "get_host_assignments", "slot_env_vars",
    "RendezvousServer", "RendezvousClient", "KVStore", "KVStoreHandler",
    "find_port",
]


def run(func: Callable,
        args=(),
        kwargs=None,
        np: int = 1,
        hosts: Optional[str] = None,
        hostfile: Optional[str] = None,
        env: Optional[dict] = None,
        verbose: int = 0,
        use_gloo: Optional[bool] = None,
        use_mpi: Optional[bool] = None,
        ssh_port: Optional[int] = None,
        ssh_identity_file: Optional[str] = None) -> List:
    """Run ``func(*args, **kwargs)`` on ``np`` ranks; return the list of
    results ordered by rank (reference: runner/__init__.py:91-206)."""
    from .gpu_run import run_func as _run_func
    import functools

    if hostfile:
        hosts = parse_host_files(hostfile)
    if hosts is None:
        hosts = f"localhost:{np}"
    wrapped = functools.partial(func, *args, **(kwargs or {}))
    return _run_func(wrapped, hosts, np, env=env, verbose=verbose,
                     ssh_port=ssh_port,
                     ssh_identity_file=ssh_identity_file)


def run_commandline():
    from .launch import run_commandline as _main
    _main()
