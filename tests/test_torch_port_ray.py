"""The port's ``ray/`` and ``mxnet/`` against the JAX package's, on the CPU.

Neither ray nor mxnet is installed: the ``Coordinator``'s env contract
and host discovery run as they are; ``RayExecutor`` runs its actors in
this process under a fake ``ray`` (one worker), whose ``fn`` joins the
port's world of one on the CPU.
"""

import os
import sys
import types

import pytest

import horovod_tpu.mxnet as jmxnet
import horovod_tpu.ray as jray
from horovod_tpu.runner.elastic.discovery import FixedHosts as JFixedHosts

import horovod_tpu_torch.mxnet as tmxnet
import horovod_tpu_torch.ray as tray
from horovod_tpu_torch.runner.elastic.discovery import FixedHosts


REGISTRATIONS = [("hostA", 0), ("hostA", 1), ("hostB", 2), ("hostB", 3),
                 ("hostC", 4)]


def test_ray_exports_the_jax_names():
    assert tray.__all__ == jray.__all__
    for name in tray.__all__:
        assert getattr(tray, name) is not None, name


@pytest.mark.parametrize("order", ["host_major", "interleaved"])
def test_coordinator_env_contract_matches_jax(order):
    regs = (REGISTRATIONS if order == "host_major"
            else sorted(REGISTRATIONS, key=lambda r: (r[1] % 2, r[1])))
    envs = []
    for mod in (jray, tray):
        c = mod.Coordinator()
        for host, rank in regs:
            c.register(host, rank)
        envs.append((c.world_size, c.node_id_by_rank,
                     c.finalize_registration()))
    assert envs[1] == envs[0]
    size, _, env = envs[1]
    assert size == 5 and sorted(env) == list(range(5))
    assert all(v["HOROVOD_SIZE"] == "5" for v in env.values())


def test_coordinator_contract_of_the_orchestrator_test():
    c = tray.Coordinator()
    for host, rank in REGISTRATIONS[:4]:
        c.register(host, rank)
    env = c.finalize_registration()
    assert env[0]["HOROVOD_RANK"] == "0"
    assert env[1]["HOROVOD_LOCAL_RANK"] == "1"
    assert env[2]["HOROVOD_HOSTNAME"] == "hostB"
    assert env[3]["HOROVOD_CROSS_RANK"] == "1"


def _nodes():
    return [
        {"Alive": True, "NodeManagerHostname": "n1",
         "Resources": {"CPU": 4.0}},
        {"Alive": True, "NodeManagerHostname": "n2",
         "Resources": {"CPU": 2.0, "GPU": 1.0}},
        {"Alive": True, "NodeManagerAddress": "10.0.0.3",
         "Resources": {"CPU": 8.0, "GPU": 4.0}},
        {"Alive": False, "NodeManagerHostname": "dead",
         "Resources": {"CPU": 8.0}},
    ]


@pytest.mark.parametrize("kwargs", [{"cpus_per_slot": 2}, {},
                                    {"use_gpu": True},
                                    {"use_gpu": True, "gpus_per_slot": 2}])
def test_ray_host_discovery_matches_jax(monkeypatch, kwargs):
    fake = types.ModuleType("ray")
    fake.nodes = _nodes
    monkeypatch.setitem(sys.modules, "ray", fake)
    got = tray.RayHostDiscovery(**kwargs).find_available_hosts_and_slots()
    assert got == jray.RayHostDiscovery(
        **kwargs).find_available_hosts_and_slots()
    if kwargs == {"cpus_per_slot": 2}:
        assert got == {"n1": 2, "n2": 1, "10.0.0.3": 4}


def test_elastic_ray_executor_uses_discovery(monkeypatch):
    ex = tray.ElasticRayExecutor(min_np=2, max_np=4, reset_limit=3,
                                 override_discovery=FixedHosts({"x": 2}))
    jex = jray.ElasticRayExecutor(min_np=2, max_np=4, reset_limit=3,
                                  override_discovery=JFixedHosts({"x": 2}))
    assert ex.discovery.find_available_hosts_and_slots() == \
        jex.discovery.find_available_hosts_and_slots() == {"x": 2}
    assert (ex.min_np, ex.max_np, ex.reset_limit, ex.elastic_timeout) == \
        (jex.min_np, jex.max_np, jex.reset_limit, jex.elastic_timeout)
    # run_command hands the port's launch_elastic the discovery and sizes.
    seen = {}

    def launch_elastic(command, **kw):
        seen.update(kw, command=command)
        return {0: 0}
    import horovod_tpu_torch.runner.elastic_run as elastic_run
    monkeypatch.setattr(elastic_run, "launch_elastic", launch_elastic)
    assert ex.run_command(["python", "train.py"], verbose=1) == {0: 0}
    assert seen == {"command": ["python", "train.py"],
                    "discovery": ex.discovery, "np": 2, "min_np": 2,
                    "max_np": 4, "reset_limit": 3, "elastic_timeout": 600,
                    "verbose": 1}


class FakeRay(types.ModuleType):
    """Actors in this process: ``@ray.remote(**options)`` records its
    options; each actor method's ``.remote`` calls it at once."""

    def __init__(self):
        super().__init__("ray")
        self.options = []
        self.killed = []
        self.util = types.SimpleNamespace(
            get_node_ip_address=lambda: "127.0.0.1")

    def remote(self, **options):
        self.options.append(options)

        def decorate(cls):
            def make():
                inst = cls()
                return types.SimpleNamespace(**{
                    name: types.SimpleNamespace(
                        remote=getattr(inst, name))
                    for name in ("hostname", "set_env", "execute")})
            return types.SimpleNamespace(remote=make)
        return decorate

    def get(self, values):
        return values

    def kill(self, actor):
        self.killed.append(actor)


def _world_of_one():
    import horovod_tpu_torch.torch as hvd
    hvd.init()
    try:
        out = (hvd.rank(), hvd.size(),
               float(hvd.allreduce(hvd_tensor(), name="ray.x")))
    finally:
        hvd.shutdown()
    return out


def hvd_tensor():
    import torch
    return torch.tensor([2.0])


def test_ray_executor_hands_workers_the_jax_env(monkeypatch):
    saved = dict(os.environ)
    envs = {}
    try:
        for name, mod in (("jax", jray), ("port", tray)):
            fake = FakeRay()
            monkeypatch.setitem(sys.modules, "ray", fake)
            ex = mod.RayExecutor(1, env_vars={"HOROVOD_EXTRA": "1"})
            ex.start()
            # The env set_env received, read back from this process.
            seen = {k: v for k, v in os.environ.items()
                    if k.startswith("HOROVOD_") and saved.get(k) != v}
            envs[name] = seen
            if name == "port":
                assert fake.options == [{"num_cpus": 1, "num_gpus": 0}]
                assert ex.run(_world_of_one) == [(0, 1, 2.0)]
                assert ex.execute(lambda: "done") == ["done"]
            workers = list(ex.workers)
            ex.shutdown()
            assert fake.killed == workers and ex.workers == []
            os.environ.clear()
            os.environ.update(saved)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    per_run = ("HOROVOD_GLOO_RENDEZVOUS_PORT", "HOROVOD_SECRET_KEY")
    host_port = ("HOROVOD_TPU_COORDINATOR", "HOROVOD_CONTROLLER_ADDR")

    def contract(env):
        out = {k: v for k, v in env.items() if k not in per_run}
        for k in host_port:
            out[k] = env[k].rsplit(":", 1)[0]
        return out
    assert set(per_run) | set(host_port) <= set(envs["port"])
    assert contract(envs["port"]) == contract(envs["jax"])
    assert envs["port"]["HOROVOD_EXTRA"] == "1"
    assert envs["port"]["HOROVOD_RANK"] == "0"


@pytest.mark.parametrize("kwargs,num_gpus", [
    ({}, 0), ({"use_gpu": True}, 1),
    ({"use_gpu": True, "gpus_per_worker": 2}, 2),
    ({"gpus_per_worker": 2}, 0)])
def test_ray_executor_reserves_the_cards_it_uses(monkeypatch, kwargs,
                                                 num_gpus):
    """Ray narrows an actor's CUDA_VISIBLE_DEVICES to what it reserves:
    with ``use_gpu`` a worker reserves ``gpus_per_worker`` (1 unset); the
    JAX package reserves none."""
    saved = dict(os.environ)
    try:
        fake = FakeRay()
        monkeypatch.setitem(sys.modules, "ray", fake)
        ex = tray.RayExecutor(1, cpus_per_worker=3, **kwargs)
        ex.start()
        ex.shutdown()
        assert fake.options == [{"num_cpus": 3, "num_gpus": num_gpus}]
        fake = FakeRay()
        monkeypatch.setitem(sys.modules, "ray", fake)
        jex = jray.RayExecutor(1, cpus_per_worker=3, **kwargs)
        jex.start()
        jex.shutdown()
        assert fake.options == [{"num_cpus": 3}]
    finally:
        os.environ.clear()
        os.environ.update(saved)


def test_mxnet_stub_raises_actionably():
    if "mxnet" in sys.modules:
        pytest.skip("mxnet is importable")
    with pytest.raises(ImportError, match="end-of-life") as got:
        tmxnet.DistributedOptimizer
    assert "horovod_tpu_torch.torch" in str(got.value)
    assert "docs/mxnet_descope.md" in str(got.value)
    for mod in (jmxnet, tmxnet):
        with pytest.raises(ImportError):
            mod.__all__
