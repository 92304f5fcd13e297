"""The port's copy of the networked controller and the data plane's
device rule, in one process on the CPU: what is not ported yet raises a
clear error instead of running something else, rank 0 builds the tuner
the user asked for as the JAX package does, the launcher's
rendezvous env gives the port's KV client, and the transport of
CUDA tensors follows the cards a host has.  The protocol itself runs in
test_torch_port_multiproc.py; the negotiation, cache and relay code is
the JAX package's, copied whole."""

import dataclasses
import threading
import time

import pytest
import torch

from horovod_tpu_torch import kernels
from horovod_tpu_torch.common import controller_net as cn
from horovod_tpu_torch.common import env
from horovod_tpu_torch.common.env import Knobs, RankInfo
from horovod_tpu_torch.ops import dist_ops


@dataclasses.dataclass
class _State:
    rank_info: RankInfo
    knobs: Knobs
    timeline: object = None
    tune_session: object = None
    parameter_manager: object = None


def _rank0_state(**knobs):
    return _State(rank_info=RankInfo(rank=0, size=2, local_size=2),
                  knobs=Knobs(**knobs))


@pytest.mark.parametrize("knob,attr,kind", [
    ("tune", "tune_session", "TuningSession"),
    ("autotune", "parameter_manager", "ParameterManager"),
])
def test_rank0_builds_the_tuner_as_the_jax_package_does(knob, attr, kind):
    """Rank 0's controller builds the tuning session (HOROVOD_TUNE) or
    the legacy parameter manager (HOROVOD_AUTOTUNE), hands it to its
    coordinator server and queues the same first announcement as the
    JAX package's controller."""
    from horovod_tpu.common import controller_net as jcn
    from horovod_tpu.common.env import Knobs as JKnobs
    from horovod_tpu.common.env import RankInfo as JRankInfo
    built = []
    for mod, knobs_cls, info_cls in ((cn, Knobs, RankInfo),
                                     (jcn, JKnobs, JRankInfo)):
        state = _State(rank_info=info_cls(rank=0, size=1, local_size=1),
                       knobs=knobs_cls(**{knob: True}))
        ctl = mod.NetworkController(state)
        try:
            tuner = getattr(state, attr)
            other = "parameter_manager" if attr == "tune_session" \
                else "tune_session"
            assert type(tuner).__name__ == kind
            assert getattr(state, other) is None
            server_attr = "param_manager" if knob == "autotune" \
                else "tune_session"
            assert getattr(ctl.server, server_attr) is tuner
            built.append((tuner.status() if knob == "tune" else
                          (tuner.active, tuner.fusion_threshold_bytes,
                           tuner.categorical_params),
                          ctl.server._synced_params))
        finally:
            ctl.shutdown()
    assert built[0] == built[1]


def test_native_coordinator_is_refused(monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_NATIVE", "1")
    with pytest.raises(NotImplementedError, match="HOROVOD_TPU_NATIVE"):
        cn.NetworkController(_rank0_state())


def test_rendezvous_client_is_refused(monkeypatch):
    # The launcher's rendezvous env gives the port's KV client
    # (runner/http_server.py); without both variables there is none.
    from horovod_tpu_torch.runner.http_server import RendezvousClient
    monkeypatch.setenv(env.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1")
    monkeypatch.setenv(env.HOROVOD_RENDEZVOUS_PORT, "1")
    assert isinstance(cn.NetworkController._rendezvous_client(),
                      RendezvousClient)
    monkeypatch.delenv(env.HOROVOD_RENDEZVOUS_PORT)
    assert cn.NetworkController._rendezvous_client() is None


@pytest.mark.parametrize("available,cards,local_size,want", [
    (False, 0, 1, "gloo"),
    (True, 1, 1, "nccl"),
    (True, 1, 2, "gloo"),     # two ranks on one card: NCCL refuses it
    (True, 4, 4, "nccl"),
    (True, 4, 8, "gloo"),
])
def test_cuda_transport_follows_the_cards_of_a_host(monkeypatch, available,
                                                    cards, local_size,
                                                    want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist_ops.cuda_transport(local_size) == want
    assert dist_ops.process_group_backend(want) == f"cpu:gloo,cuda:{want}"


@pytest.mark.parametrize("proposals,cards,want", [
    (["nccl", "nccl"], ["GPU-a", "GPU-b"], "nccl"),
    # localhost:1 and 127.0.0.1:1 on one machine: each rank counts one
    # local rank and proposes NCCL, but both hold the same card.
    (["nccl", "nccl"], ["GPU-a", "GPU-a"], "gloo"),
    # localhost:2 beside 127.0.0.1:1 on one card: one proposal is gloo.
    (["gloo", "gloo", "nccl"], ["GPU-a", "GPU-a", "GPU-a"], "gloo"),
    (["gloo", "gloo"], ["cpu", "cpu"], "gloo"),
])
def test_world_transport_is_agreed_by_every_rank(proposals, cards, want):
    import threading

    import torch.distributed as dist
    store = dist.HashStore()
    got = [None] * len(proposals)

    def rank(r):
        got[r] = dist_ops.world_transport(store, r, len(proposals),
                                          proposals[r], cards[r])
    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(len(proposals))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert got == [want] * len(proposals)


def test_backend_name_is_the_transport_and_refuses_others():
    state = _State(rank_info=RankInfo(rank=1, size=4, local_rank=1,
                                      local_size=2, cross_rank=0,
                                      cross_size=2), knobs=Knobs())
    assert dist_ops.TorchDistBackend(state, "gloo").name == "gloo"
    with pytest.raises(ValueError, match="transport"):
        dist_ops.TorchDistBackend(state, "xla")
    # Two hosts of two ranks: the hierarchical allreduce is on only when
    # the knob asks for it (its auto value means off for one card per
    # process), and never inside a process set.
    assert not dist_ops.TorchDistBackend(state, "gloo").hierarchical_active()
    state.knobs.hierarchical_allreduce = True
    backend = dist_ops.TorchDistBackend(state, "gloo")
    assert backend.hierarchical_active()
    assert not backend.hierarchical_active((0, 1))


def test_kernel_builds_of_two_sources_run_at_once(tmp_path, monkeypatch):
    # chip_smoke.py starts one nvcc per source together; the loader must
    # not serialise them.
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(kernels, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "nvcc_path", lambda: "nvcc")
    running, peak, lock = [0], [0], threading.Lock()

    class _Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(0.3)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("")
        with lock:
            running[0] -= 1
        return _Done()

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: path)
    threads = [threading.Thread(target=kernels.load, args=(n,))
               for n in ("a.cu", "b.cu")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert peak[0] == 2
    assert sorted(kernels._loaded) == ["a.cu", "b.cu"]
