"""Training backends for the estimator API.

Counterpart of :mod:`horovod_tpu.spark.backend` (reference:
spark/backend.py — ``SparkBackend`` runs the training function on Spark
barrier tasks).  ``SparkBackend`` wraps :func:`horovod_tpu_torch.spark.run`
(barrier stage + rendezvous), and ``LocalBackend`` runs the same function
on N local worker processes over the launcher env contract, so the
estimator is usable (and testable) without a Spark cluster.

On one host the workers share its cards: rank ``r`` takes card ``r %
device_count()`` at ``hvd.init()``, and ranks that share a card carry
their CUDA tensors over gloo, as a launch of ``-np N -H localhost:N``
does.  Each worker's output goes to a file of its own (``verbose < 2``),
never to a pipe that the driver reads one rank after another: a rank
that writes more than a pipe holds before a collective would block
there while its peers wait for it in that collective.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

from .._alias import worker_pythonpath


class Backend:
    def num_processes(self) -> int:
        raise NotImplementedError()

    def run(self, fn: Callable, args=(), extra_env: Optional[dict] = None
            ) -> List:
        """Run ``fn(*args)`` on every worker; returns per-rank results
        ordered by rank."""
        raise NotImplementedError()


class SparkBackend(Backend):
    """Barrier-stage backend (reference: spark/backend.py SparkBackend)."""

    def __init__(self, num_proc: Optional[int] = None, verbose: int = 2):
        self._num_proc = num_proc
        self._verbose = verbose

    def num_processes(self) -> int:
        if self._num_proc is not None:
            return self._num_proc
        from pyspark.sql import SparkSession
        sc = SparkSession.builder.getOrCreate().sparkContext
        return max(int(sc.defaultParallelism), 1)

    def run(self, fn, args=(), extra_env=None):
        from . import run as spark_run
        return spark_run(fn, args=args, num_proc=self.num_processes(),
                         extra_env=extra_env, verbose=self._verbose)


_WORKER_MAIN = r"""
import os
with open(os.environ["HVD_ESTIMATOR_FN"], "rb") as f:
    payload = f.read()
import cloudpickle
fn, args = cloudpickle.loads(payload)
result = fn(*args)
out = os.environ["HVD_ESTIMATOR_OUT"]
with open(out + ".tmp", "wb") as f:
    f.write(cloudpickle.dumps(result))
os.replace(out + ".tmp", out)
"""


def _tail(path: str, limit: int = 2000) -> str:
    if not os.path.exists(path):
        return ""
    with open(path, "rb") as f:
        f.seek(max(os.path.getsize(path) - limit, 0))
        return f.read().decode(errors="replace")


class LocalBackend(Backend):
    """Run the training function on N local processes wired through the
    standard env contract (the same processes ``python -m
    horovod_tpu_torch.runner.launch -np N -H localhost:N`` would
    start)."""

    def __init__(self, num_proc: int = 2, verbose: int = 1,
                 timeout: float = 600.0):
        self._num_proc = num_proc
        self._verbose = verbose
        self._timeout = timeout

    def num_processes(self) -> int:
        return self._num_proc

    def run(self, fn, args=(), extra_env=None):
        import cloudpickle
        from ..runner.http_server import find_ports

        nproc = self._num_proc
        coord_port, ctrl_port = find_ports(2)
        with tempfile.TemporaryDirectory(prefix="hvd_est_") as tmp:
            fn_path = os.path.join(tmp, "fn.pkl")
            with open(fn_path, "wb") as f:
                f.write(cloudpickle.dumps((fn, args)))
            procs, outs, logs = [], [], []
            for rank in range(nproc):
                out_path = os.path.join(tmp, f"out.{rank}.pkl")
                outs.append(out_path)
                env = dict(os.environ)
                env.update({
                    "HOROVOD_RANK": str(rank),
                    "HOROVOD_SIZE": str(nproc),
                    "HOROVOD_LOCAL_RANK": str(rank),
                    "HOROVOD_LOCAL_SIZE": str(nproc),
                    "HOROVOD_CROSS_RANK": "0",
                    "HOROVOD_CROSS_SIZE": "1",
                    "HOROVOD_TPU_COORDINATOR": f"127.0.0.1:{coord_port}",
                    "HOROVOD_CONTROLLER_ADDR": f"127.0.0.1:{ctrl_port}",
                    "HVD_ESTIMATOR_FN": fn_path,
                    "HVD_ESTIMATOR_OUT": out_path,
                    # The package from wherever the driver runs, and the
                    # port's `horovod` alias first.
                    "PYTHONPATH": worker_pythonpath(env.get("PYTHONPATH")),
                })
                if extra_env:
                    env.update(extra_env)
                if self._verbose >= 2:
                    log = None
                else:
                    logs.append(os.path.join(tmp, f"rank.{rank}.log"))
                    log = open(logs[-1], "wb")
                try:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", _WORKER_MAIN], env=env,
                        stdout=log, stderr=subprocess.STDOUT))
                finally:
                    if log is not None:
                        log.close()
            failures = []
            # One shared deadline: a wedged worker set must fail after
            # ~timeout total, not nproc * timeout.
            deadline = time.monotonic() + self._timeout
            for rank, p in enumerate(procs):
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                if p.returncode != 0:
                    failures.append(rank)
            if failures:
                detail = "\n".join(_tail(logs[r]) for r in failures
                                   if logs)[-4000:]
                raise RuntimeError(
                    f"estimator worker(s) {failures} failed"
                    + (f":\n{detail}" if detail.strip() else ""))
            results = []
            for path in outs:
                with open(path, "rb") as f:
                    results.append(pickle.loads(f.read()))
            return results
