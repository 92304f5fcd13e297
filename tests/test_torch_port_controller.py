"""The port's copy of the networked controller and the data plane's
device rule, in one process on the CPU: rank 0 hosts the coordinator
the JAX package's rank 0 would host for the same environment (native or
Python) or raises its error, rank 0 builds the tuner
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


# Each knob that pins the Python coordinator, as the state of rank 0
# carries it: a Knobs field, the timeline, a tuner, or an armed plane.
_PYTHON_ONLY = {
    "none": {},
    "timeline": {"timeline": True},
    "tune": {"tune": True},
    "autotune": {"autotune": True},
    "metrics_aggregation": {"metrics_agg_interval_s": 1.0},
    "failpoints": {"failpoints": "coord.broadcast=delay(0)"},
    "liveness": {"liveness_interval_s": 1.0},
    "reconnect_grace": {"reconnect_grace_s": 1.0},
    "fanout": {"coord_fanout": 2},
    "straggler": {"straggler": True},
}


def _packages():
    """(name, controller_net, env, failpoints, straggler, timeline,
    TuningSession, ParameterManager, native) of each package."""
    from horovod_tpu import native as jnative
    from horovod_tpu.common import controller_net as jcn
    from horovod_tpu.common import env as jenv
    from horovod_tpu.common import failpoints as jfp
    from horovod_tpu.common import parameter_manager as jpm
    from horovod_tpu.common import straggler as jsg
    from horovod_tpu.common import timeline as jtl
    from horovod_tpu.tune import session as jts
    from horovod_tpu_torch import native
    from horovod_tpu_torch.common import failpoints, parameter_manager
    from horovod_tpu_torch.common import straggler, timeline
    from horovod_tpu_torch.tune import session
    return {"port": (cn, env, failpoints, straggler, timeline,
                     session.TuningSession,
                     parameter_manager.ParameterManager, native),
            "jax": (jcn, jenv, jfp, jsg, jtl, jts.TuningSession,
                    jpm.ParameterManager, jnative)}


def _select(pkg, setting, tmp_path):
    """What rank 0 of a two-rank world hosts under ``setting``: the
    server's class name, or the type and message of what it raised."""
    cn_mod, env_mod, fp, sg, tl, session_cls, pm_cls, _ = _packages()[pkg]
    setting = dict(setting)
    timeline = tl.Timeline(str(tmp_path / f"{pkg}.json")) \
        if setting.pop("timeline", False) else None
    if "failpoints" in setting:
        fp.configure(setting.pop("failpoints"))
    if setting.pop("straggler", False):
        sg.configure(True)
    try:
        knobs = env_mod.Knobs(**setting)
        state = _State(rank_info=env_mod.RankInfo(rank=0, size=2,
                                                  local_size=2),
                       knobs=knobs, timeline=timeline)
        ctl = cn_mod.NetworkController.__new__(cn_mod.NetworkController)
        ctl.size = 2
        tune_session = session_cls(knobs, 2) if knobs.tune else None
        param_manager = pm_cls() if knobs.autotune else None
        try:
            server = ctl._make_server(state, 0, param_manager, tune_session)
        except Exception as e:  # the outcome under test
            return type(e).__name__, str(e)
        server.stop()
        return type(server).__name__
    finally:
        fp.reset()
        sg.reset()
        if timeline is not None:
            timeline.close()


@pytest.mark.parametrize("knob", sorted(_PYTHON_ONLY))
@pytest.mark.parametrize("native", [None, "0", "1"])
def test_server_selection_matches_the_jax_package(monkeypatch, tmp_path,
                                                  native, knob):
    """For each HOROVOD_TPU_NATIVE value and each knob that needs the
    Python coordinator, rank 0 of the port hosts the server the JAX
    package's rank 0 hosts, or raises its error: native when nothing
    pins Python and g++ builds the library, Python otherwise, and a
    config error for strict native beside a Python-only knob."""
    if native is None:
        monkeypatch.delenv("HOROVOD_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TPU_NATIVE", native)
    for pkg in ("port", "jax"):
        # Each package's loader reads HOROVOD_TPU_NATIVE once.
        monkeypatch.setattr(_packages()[pkg][-1], "_tried", False)
        monkeypatch.setattr(_packages()[pkg][-1], "_lib", None)
    got = _select("port", _PYTHON_ONLY[knob], tmp_path)
    want = _select("jax", _PYTHON_ONLY[knob], tmp_path)
    assert got == want
    strict = native == "1"
    if knob == "none":
        assert got == ("CoordinatorServer" if native == "0"
                       else "NativeCoordinatorServer")
    elif strict and knob != "timeline":
        assert got[0] == "RuntimeError" and "HOROVOD_TPU_NATIVE=1 is " \
            "incompatible" in got[1], got
    else:
        # A timeline pins Python without a refusal, in both packages.
        assert got == "CoordinatorServer"


@pytest.mark.parametrize("native", [None, "1"])
def test_build_failure_without_gxx(monkeypatch, tmp_path, native):
    """With g++ hidden from PATH and no library built: strict native
    raises the JAX package's error at init; auto-selection falls back to
    the Python server, in both packages."""
    if native is None:
        monkeypatch.delenv("HOROVOD_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TPU_NATIVE", native)
    monkeypatch.setenv("PATH", str(tmp_path))
    port_native, jax_native = _packages()["port"][-1], _packages()["jax"][-1]
    for mod in (port_native, jax_native):
        monkeypatch.setattr(mod, "_tried", False)
        monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(port_native, "BUILD_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_native, "_BUILD_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jax_native, "_LIB",
                        str(tmp_path / "jax" / "libhvdtpu_coord.so"))
    got = _select("port", {}, tmp_path)
    want = _select("jax", {}, tmp_path)
    assert got == want
    if native == "1":
        assert got == ("RuntimeError", "HOROVOD_TPU_NATIVE is set but the "
                       "native coordinator could not be built/loaded")
    else:
        assert got == "CoordinatorServer"
    assert port_native.unavailable_reason() == "g++ not found"


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
