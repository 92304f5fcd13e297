"""Ray orchestrator integration, the port's counterpart of
:mod:`horovod_tpu.ray` (reference: horovod/ray/runner.py —
``RayExecutor`` placing one worker actor per slot, a ``Coordinator``
that collects hostnames into the rank env contract, and the elastic
variant over the Ray autoscaler in ray/elastic.py:36-61).

The coordination logic (slot planning, env contract, rendezvous
wiring) is pure Python and unit-testable without Ray; only actor
placement touches the ``ray`` package, which is imported lazily so the
module loads in environments without Ray installed.
"""

from .runner import Coordinator, RayExecutor
from .elastic import ElasticRayExecutor, RayHostDiscovery

__all__ = ["RayExecutor", "Coordinator", "ElasticRayExecutor",
           "RayHostDiscovery"]
