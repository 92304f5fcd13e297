"""RayExecutor: run horovod_tpu_torch training over Ray actors.

Counterpart of :mod:`horovod_tpu.ray.runner`.  Reference:
ray/runner.py — ``Coordinator`` (:178-248) collects each actor's
hostname, computes the rank env contract per slot, and points every
worker at the rendezvous; ``RayExecutor`` (:250+) creates one actor per
slot (colocated per node) and drives setup/execution.

Ray narrows an actor's ``CUDA_VISIBLE_DEVICES`` to the GPUs it
reserves, and the port's default device is the card, so a worker with
``use_gpu`` reserves ``gpus_per_worker`` GPUs (1 when unset), as the
reference's executor does; the JAX package reserves none.
"""

import logging
import socket
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from ..runner.hosts import HostInfo, get_host_assignments, slot_env_vars
from ..runner.http_server import RendezvousServer, find_ports

logger = logging.getLogger("horovod_tpu_torch.ray")


class Coordinator:
    """Collects worker hostnames and hands out the env contract
    (reference: ray/runner.py:178-248)."""

    def __init__(self):
        self.hostnames_by_rank: "OrderedDict[str, List[int]]" = \
            OrderedDict()

    @property
    def world_size(self) -> int:
        return sum(len(v) for v in self.hostnames_by_rank.values())

    @property
    def node_id_by_rank(self) -> Dict[int, int]:
        out = {}
        for node_id, ranks in enumerate(self.hostnames_by_rank.values()):
            for r in ranks:
                out[r] = node_id
        return out

    def register(self, hostname: str, world_rank: int):
        self.hostnames_by_rank.setdefault(hostname, []).append(world_rank)

    def finalize_registration(self) -> Dict[int, Dict[str, str]]:
        """Returns {world_rank: env_vars} for every registered worker."""
        hosts = [HostInfo(h, len(ranks))
                 for h, ranks in self.hostnames_by_rank.items()]
        np = self.world_size
        slots = get_host_assignments(hosts, np, np)
        # Map computed slots back onto the registered world ranks
        # host-major, same ordering as registration.
        env_by_rank: Dict[int, Dict[str, str]] = {}
        slot_iter = iter(slots)
        for hostname, ranks in self.hostnames_by_rank.items():
            for world_rank in ranks:
                env_by_rank[world_rank] = slot_env_vars(next(slot_iter))
        return env_by_rank


class RayExecutor:
    """Drive ``num_workers`` horovod_tpu_torch workers as Ray actors
    (reference: ray/runner.py:250+ — simplified API: start(),
    run(fn, args), execute(fn), shutdown())."""

    def __init__(self, num_workers: int, cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 gpus_per_worker: Optional[int] = None,
                 env_vars: Optional[Dict[str, str]] = None):
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.gpus_per_worker = ((1 if gpus_per_worker is None
                                 else gpus_per_worker) if use_gpu else 0)
        self.env_vars = dict(env_vars or {})
        self.workers = []
        self._server: Optional[RendezvousServer] = None

    # -- actor plumbing (requires ray) ---------------------------------
    def start(self):
        import ray

        @ray.remote(num_cpus=self.cpus_per_worker,
                    num_gpus=self.gpus_per_worker)
        class Worker:
            def __init__(self):
                self._result = None

            def hostname(self):
                return socket.gethostname()

            def set_env(self, env):
                import os
                os.environ.update(env)

            def execute(self, fn, *args, **kwargs):
                return fn(*args, **kwargs)

        self.workers = [Worker.remote() for _ in range(self.num_workers)]
        coordinator = Coordinator()
        hostnames = ray.get([w.hostname.remote() for w in self.workers])
        for rank, hostname in enumerate(hostnames):
            coordinator.register(hostname, rank)
        env_by_rank = coordinator.finalize_registration()

        from ..runner import job_secret
        self._secret = job_secret.make_secret_key()
        self._server = RendezvousServer(secret=self._secret)
        rendezvous_port = self._server.start()
        self._server.init({})
        driver_ip = ray.util.get_node_ip_address() \
            if hasattr(ray.util, "get_node_ip_address") else \
            socket.gethostbyname(socket.gethostname())
        coord_port, ctrl_port = find_ports(2)
        rank0_host = hostnames[0]
        common = {
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": driver_ip,
            "HOROVOD_GLOO_RENDEZVOUS_PORT": str(rendezvous_port),
            "HOROVOD_CONTROLLER": "tcp",
            job_secret.ENV: self._secret,
            "HOROVOD_TPU_COORDINATOR": f"{rank0_host}:{coord_port}",
            "HOROVOD_CONTROLLER_ADDR": f"{rank0_host}:{ctrl_port}",
        }
        common.update(self.env_vars)
        ray.get([
            w.set_env.remote({**common, **env_by_rank[rank]})
            for rank, w in enumerate(self.workers)])

    def run(self, fn: Callable, args=None, kwargs=None) -> List:
        import ray
        return ray.get([
            w.execute.remote(fn, *(args or ()), **(kwargs or {}))
            for w in self.workers])

    def execute(self, fn: Callable) -> List:
        return self.run(fn)

    def shutdown(self):
        import ray
        for w in self.workers:
            ray.kill(w)
        self.workers = []
        if self._server is not None:
            self._server.stop()
            self._server = None
