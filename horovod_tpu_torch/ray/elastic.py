"""Elastic training over Ray, the port's counterpart of
:mod:`horovod_tpu.ray.elastic` (reference: ray/elastic.py —
``RayHostDiscovery`` reads the autoscaler's live node set :36-61;
``ElasticRayExecutor`` wires it into the elastic driver)."""

import logging
from collections import OrderedDict
from typing import Dict, Optional

from ..runner.elastic.discovery import HostDiscovery

logger = logging.getLogger("horovod_tpu_torch.ray")


class RayHostDiscovery(HostDiscovery):
    """Maps Ray's alive-node view to {hostname: slots} (reference:
    ray/elastic.py:36-61)."""

    def __init__(self, use_gpu: bool = False, cpus_per_slot: int = 1,
                 gpus_per_slot: int = 1):
        self.use_gpu = use_gpu
        self.cpus_per_slot = cpus_per_slot
        self.gpus_per_slot = gpus_per_slot

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        import ray
        host_slots = OrderedDict()
        for node in ray.nodes():
            if not node.get("Alive"):
                continue
            hostname = node.get("NodeManagerHostname") or \
                node.get("NodeManagerAddress")
            resources = node.get("Resources", {})
            if self.use_gpu:
                slots = int(resources.get("GPU", 0) // self.gpus_per_slot)
            else:
                slots = int(resources.get("CPU", 0) // self.cpus_per_slot)
            if slots > 0:
                host_slots[hostname] = slots
        return host_slots


class ElasticRayExecutor:
    """Elastic run over Ray nodes: the elastic driver spawns workers via
    ssh onto Ray hosts as membership changes (reference:
    ray/elastic.py ElasticRayExecutor, simplified to the command-launch
    path shared with horovodrun)."""

    def __init__(self, min_np: int, max_np: Optional[int] = None,
                 reset_limit: Optional[int] = None,
                 elastic_timeout: float = 600,
                 use_gpu: bool = False, cpus_per_slot: int = 1,
                 override_discovery: Optional[HostDiscovery] = None):
        self.discovery = override_discovery or RayHostDiscovery(
            use_gpu=use_gpu, cpus_per_slot=cpus_per_slot)
        self.min_np = min_np
        self.max_np = max_np
        self.reset_limit = reset_limit
        self.elastic_timeout = elastic_timeout

    def run_command(self, command, **kwargs):
        from ..runner.elastic_run import launch_elastic
        return launch_elastic(
            command, discovery=self.discovery, np=self.min_np,
            min_np=self.min_np, max_np=self.max_np,
            reset_limit=self.reset_limit,
            elastic_timeout=self.elastic_timeout, **kwargs)
