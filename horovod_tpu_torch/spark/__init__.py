"""Spark orchestrator integration, the port's counterpart of
:mod:`horovod_tpu.spark` (reference: horovod/spark/ —
``horovod.spark.run()`` launches one training task per executor over a
barrier stage (spark/runner.py:417, task fn :31-80); the Estimator API
and Store abstraction live in submodules).

``run()`` needs a live ``pyspark`` session (imported lazily, as is
``cloudpickle``); the coordination pieces (env contract, rendezvous,
store) are pure Python.  Each task gets the env contract that
``common/basics.py`` reads: its slot's ranks, the process group's store
(``HOROVOD_TPU_COORDINATOR``) and the controller
(``HOROVOD_CONTROLLER_ADDR``) at rank 0's host, and the rendezvous
address, port and job secret of the driver's ``RendezvousServer``.
"""

import logging
import os
import socket
from typing import Callable, List, Optional

from ..runner.hosts import HostInfo, get_host_assignments, slot_env_vars
from ..runner.http_server import RendezvousServer, find_ports, \
    local_addresses
from .store import (FilesystemStore, FsspecStore, GCSStore,
                    HDFSStore, S3Store, Store)
from .backend import Backend, LocalBackend, SparkBackend
from .estimator import HorovodEstimator, HorovodModel

logger = logging.getLogger("horovod_tpu_torch.spark")

__all__ = ["run", "Store", "FilesystemStore", "FsspecStore",
           "HDFSStore", "S3Store", "GCSStore", "Backend", "LocalBackend",
           "SparkBackend", "HorovodEstimator", "HorovodModel"]


def run(fn: Callable, args=(), kwargs=None, num_proc: Optional[int] = None,
        extra_env: Optional[dict] = None, verbose: int = 2) -> List:
    """Run ``fn(*args, **kwargs)`` on ``num_proc`` Spark tasks in a
    barrier stage; returns results ordered by rank (reference:
    spark/runner.py:417 ``run``)."""
    try:
        import pyspark
        from pyspark import BarrierTaskContext
        from pyspark.sql import SparkSession
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark.run requires pyspark, which is not "
            "installed in this environment.") from e
    import cloudpickle

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is None:
        num_proc = max(int(sc.defaultParallelism), 1)

    from ..runner import job_secret
    secret = job_secret.make_secret_key()
    server = RendezvousServer(verbose, secret=secret)
    rendezvous_port = server.start()
    server.init({})
    driver_ip = local_addresses()[0]
    payload = cloudpickle.dumps((fn, args, kwargs or {}))

    def task_fn(index, _iterator):
        ctx = BarrierTaskContext.get()
        hostname = socket.gethostname()
        # Exchange hostnames through the barrier to build the slot
        # plan identically on every task (reference spark task fn).
        infos = ctx.allGather(hostname)
        counts = {}
        ordered = []
        for h in infos:
            if h not in counts:
                ordered.append(h)
            counts[h] = counts.get(h, 0) + 1
        hosts = [HostInfo(h, counts[h]) for h in ordered]
        slots = get_host_assignments(hosts, len(infos), len(infos))
        # This task's slot: the index-th occurrence of its hostname.
        occurrence = sum(1 for h in infos[:index] if h == hostname)
        my_slot = [s for s in slots if s.hostname == hostname][occurrence]

        env = slot_env_vars(my_slot)
        env.update({
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": driver_ip,
            "HOROVOD_GLOO_RENDEZVOUS_PORT": str(rendezvous_port),
            "HOROVOD_CONTROLLER": "tcp",
            # Closure-captured: spark executors don't inherit the
            # driver env, so the HMAC key rides the pickled task fn.
            "HOROVOD_SECRET_KEY": secret,
        })
        # Rank 0 announces coordinator/controller endpoints through the
        # barrier so all tasks agree.
        if my_slot.rank == 0:
            cport, ctlport = find_ports(2)
            addr = socket.gethostbyname(hostname)
            endpoints = f"{addr}:{cport},{addr}:{ctlport}"
        else:
            endpoints = ""
        all_endpoints = [e for e in ctx.allGather(endpoints) if e]
        coord, ctrl = all_endpoints[0].split(",")
        env["HOROVOD_TPU_COORDINATOR"] = coord
        env["HOROVOD_CONTROLLER_ADDR"] = ctrl
        if extra_env:
            env.update(extra_env)
        os.environ.update(env)

        f, a, kw = cloudpickle.loads(payload)
        result = f(*a, **kw)
        return [(my_slot.rank, cloudpickle.dumps(result))]

    try:
        rdd = sc.parallelize(range(num_proc), num_proc).barrier()
        collected = rdd.mapPartitionsWithIndex(task_fn).collect()
        by_rank = dict(collected)
        return [cloudpickle.loads(by_rank[r]) for r in range(num_proc)]
    finally:
        server.stop()
