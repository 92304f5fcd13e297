"""Elastic runs of the port end to end on the CPU: real torch worker
processes started by the port's elastic launcher, gloo for the data,
scripted discovery churn (the counterparts of tests/test_elastic_run.py,
whose JAX workers are the reference's):

* the world grows 2 -> 3 when the discovery script reports a slot;
* a worker dies hard (``os._exit``) and the world shrinks 3 -> 2;
* a whole host of two slots is lost: 2 hosts x 2 slots re-form as one
  host x 2 with the local/cross ranks recomputed and the hierarchical
  allreduce's subgroups made anew;
* a tiny GPT trains through ``DistributedOptimizer`` (SGD with
  momentum), ``TorchState`` and ``ElasticSampler`` at 2, then 3, then 2
  ranks, the joiner dying inside its backward with fused allreduces in
  flight: the survivors restore the last commit, and their final
  parameters are equal to each other and to a serial replay of the
  committed steps.

Each runs with the launcher's defaults, on which rank 0 hosts the native
coordinator (a death reaches the survivors through its departure
handling), and again pinned to the Python coordinator.

Beside them, one in-process test shows the optimizer faults the port
repairs: the JAX package's ``horovod_tpu.torch`` optimizer trips after a
step that died in the middle and after a shrink to one rank; the port's
recovers.  Every wait is bounded.
"""

import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from multiproc import REPO

pytestmark = pytest.mark.multiproc

WAIT_S = 120

# The production defaults of a launched job: no liveness probes and no
# reconnect grace, so a dead rank is lost the moment its socket closes,
# and rank 0 hosts the native coordinator (g++ builds it here).  The
# ``*_on_the_python_coordinator`` tests pin HOROVOD_TPU_NATIVE=0 to run
# the same cases on the Python server.
_ENV = {"HOROVOD_STEADY_STATE_REPLAY": "0", "HOROVOD_LIVENESS_INTERVAL": "0",
        "HOROVOD_RECONNECT_GRACE": "0", "HOROVOD_START_TIMEOUT": "60"}

_EAGER_WORKER = """
import os, time
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.elastic import ObjectState
from horovod_tpu_torch.torch.elastic import run

hvd.init()
state = ObjectState(bcast_object=lambda o: hvd.broadcast_object(o, 0),
                    get_rank=hvd.rank, epoch=0)
STOP = os.environ["TEST_STOP_FILE"]
DOOMED = os.environ["HOROVOD_HOSTNAME"] == os.environ.get("TEST_DOOMED_HOST")
DIE_AT = int(os.environ.get("TEST_DIE_AT", "0"))

@run
def train(state):
    if hvd.rank() == 0:
        server = basics._state().runtime.controller.server
        print(f"SERVER {type(server).__name__} size={hvd.size()}",
              flush=True)
    while True:
        stop = hvd.allreduce(torch.tensor([float(os.path.exists(STOP))]),
                             op=hvd.Sum, name="stopflag")
        if stop.item() > 0:
            return state.epoch
        if DOOMED and state.epoch >= DIE_AT:
            print("DYING", flush=True)
            os._exit(1)
        val = hvd.allreduce(torch.ones(4), op=hvd.Sum, name="t")
        assert val[0].item() == hvd.size(), (val, hvd.size())
        ri = basics._state().rank_info
        if ri.size == ri.cross_size * ri.local_size:
            # The two-tier contract, where every host has as many slots.
            assert ri.rank == ri.cross_rank * ri.local_size + ri.local_rank
        hier = basics._state().backend.hierarchical_active()
        print(f"EPOCH {state.epoch} rank={hvd.rank()} size={hvd.size()} "
              f"lr={ri.local_rank} ls={ri.local_size} cr={ri.cross_rank} "
              f"cs={ri.cross_size} hier={hier}", flush=True)
        state.epoch += 1
        state.commit()
        time.sleep(0.05)

train(state)
print(f"DONE rank={hvd.rank()} epoch={state.epoch} size={hvd.size()}",
      flush=True)
"""

_GPT_WORKER = """
import hashlib, json, os, time
import numpy as np
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import gpt
from horovod_tpu_torch.torch.elastic import ElasticSampler, TorchState, run

hvd.init()
B, S = 2, 16
cfg = gpt.gpt_tiny_config(dtype=torch.float32, attention_impl="flash",
                          vocab_size=64, max_position_embeddings=S)
tokens = torch.from_numpy(np.random.RandomState(0).randint(
    0, cfg.vocab_size, size=(256, S)).astype(np.int64))
model = gpt.GPTLMHeadModel(cfg, device="cpu", seed=0)
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
    named_parameters=model.named_parameters())
sampler = ElasticSampler(tokens, shuffle=True, seed=0)
state = TorchState(model, opt, sampler, step=0)
STOP = os.environ["TEST_STOP_FILE"]
OUT = os.environ["TEST_OUT_DIR"]
DOOMED = os.environ["HOROVOD_HOSTNAME"] == "127.0.0.1"
joined = []

if DOOMED:
    # Dies inside its fourth backward at the size it joined: the hooks
    # of the layers above have fired, so fused allreduces are in flight
    # on the survivors.
    def die(_):
        if state.step >= joined[0] + 3:
            print("DYING", flush=True)
            os._exit(1)
    model.layers[0].attention.query.weight \\
        .register_post_accumulate_grad_hook(die)

def digest():
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.numpy().tobytes())
    for k, v in sorted(opt.state_dict()["state"].items()):
        h.update(v["momentum_buffer"].numpy().tobytes())
    return h.hexdigest()

@run
def train(state):
    joined.append(state.step)
    if hvd.rank() == 0:
        server = basics._state().runtime.controller.server
        print(f"SERVER {type(server).__name__} size={hvd.size()}",
              flush=True)
    print("SYNCED " + json.dumps({"step": state.step, "rank": hvd.rank(),
                                  "size": hvd.size(), "sha": digest()}),
          flush=True)
    batch = 0
    while True:
        stop = hvd.allreduce(torch.tensor([float(os.path.exists(STOP))]),
                             op=hvd.Sum, name="stopflag")
        if stop.item() > 0:
            return state.step
        idx = sampler.indices[batch * B:(batch + 1) * B]
        ids = tokens[idx]
        opt.zero_grad()
        loss = gpt.lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        sampler.record_batch(batch, B)
        batch += 1
        state.step += 1
        print("STEP " + json.dumps({"step": state.step, "rank": hvd.rank(),
                                    "size": hvd.size(),
                                    "idx": [int(i) for i in idx],
                                    "loss": loss.item()}), flush=True)
        state.commit()
        time.sleep(0.05)

train(state)
torch.save(model.state_dict(), os.path.join(OUT, f"rank{hvd.rank()}.pt"))
print("DONE " + json.dumps({"rank": hvd.rank(), "size": hvd.size(),
                            "step": state.step, "sha": digest()}), flush=True)
"""


class ElasticRun:
    """The port's elastic launcher in a thread, over a discovery script
    that cats a hosts file the test rewrites."""

    def __init__(self, tmp_path, worker_src, hosts, np_, min_np, max_np,
                 extra_env=None):
        from horovod_tpu_torch.runner.elastic.discovery import \
            HostDiscoveryScript
        from horovod_tpu_torch.runner.elastic_run import launch_elastic
        self.hosts_file = tmp_path / "hosts.txt"
        self.hosts_file.write_text(hosts)
        disc = tmp_path / "discover.sh"
        disc.write_text(f"#!/bin/sh\ncat {self.hosts_file}\n")
        disc.chmod(0o755)
        self.stop_file = tmp_path / "stop"
        worker = tmp_path / "worker.py"
        worker.write_text(worker_src)
        self.outdir = tmp_path / "out"
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(_ENV, PYTHONPATH=REPO)
        self.result = {}

        def target():
            try:
                self.result["codes"] = launch_elastic(
                    [sys.executable, str(worker)],
                    discovery=HostDiscoveryScript(str(disc), 1),
                    np=np_, min_np=min_np, max_np=max_np,
                    elastic_timeout=60, output_filename=str(self.outdir),
                    env=env, extra_worker_env=dict(
                        extra_env or {}, TEST_STOP_FILE=str(self.stop_file)))
            except Exception as e:
                self.result["error"] = e

        self.thread = threading.Thread(target=target, daemon=True)
        self.thread.start()

    def logs(self) -> str:
        text = ""
        for root, _, files in os.walk(self.outdir):
            for f in sorted(files):
                with open(os.path.join(root, f), errors="replace") as fh:
                    text += fh.read()
        return text

    def wait_for(self, pattern, count=1):
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            if len(re.findall(pattern, self.logs())) >= count:
                return
            if not self.thread.is_alive():
                raise AssertionError(f"launcher exited early: {self.result}"
                                     f"\n{self.logs()[-3000:]}")
            time.sleep(0.2)
        raise AssertionError(f"{pattern!r} x{count} never appeared:\n"
                             f"{self.logs()[-3000:]}")

    def finish(self):
        self.stop_file.write_text("")
        self.thread.join(timeout=WAIT_S)
        assert not self.thread.is_alive(), "the launcher did not finish"
        assert "error" not in self.result, self.result["error"]
        return self.result["codes"]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # A failed check still stops the workers (the stop flag is
        # collective) and waits for the launcher, bounded.
        self.stop_file.write_text("")
        self.thread.join(timeout=WAIT_S)


def _servers(logs):
    """(server class, world size) of every sync rank 0 reported."""
    return re.findall(r"SERVER (\w+) size=(\d+)", logs)


def _resize_case(case, tmp_path, native):
    """Grow, death or two-tier host loss, with HOROVOD_TPU_NATIVE
    unset (auto-selection) or pinned to ``native``; rank 0 must host the
    matching server at every size."""
    env = {} if native is None else {"HOROVOD_TPU_NATIVE": native}
    want = "CoordinatorServer" if native == "0" else \
        "NativeCoordinatorServer"
    if case == "grow":
        with ElasticRun(tmp_path, _EAGER_WORKER, "localhost:2\n", 2, 2,
                        3, extra_env=env) as run:
            run.wait_for(r"EPOCH \d+ rank=\d size=2")
            run.hosts_file.write_text("localhost:3\n")
            run.wait_for(r"EPOCH \d+ rank=2 size=3")
            codes = run.finish()
        assert set(codes.values()) == {0}
        assert len(re.findall(r"DONE rank=\d epoch=\d+ size=3",
                              run.logs())) == 3
    else:
        two_tier = case == "two_tier_host_loss"
        with ElasticRun(
                tmp_path, _EAGER_WORKER,
                "localhost:2\n127.0.0.1:2\n" if two_tier else
                "localhost:2\n127.0.0.1:1\n",
                4 if two_tier else 3, 2, 4 if two_tier else 3,
                extra_env=dict(env, TEST_DOOMED_HOST="127.0.0.1",
                               TEST_DIE_AT="3",
                               HOROVOD_HIERARCHICAL_ALLREDUCE="1")) as run:
            _death_case(run, two_tier)
    servers = _servers(run.logs())
    assert servers and {cls for cls, _ in servers} == {want}, servers


@pytest.mark.parametrize("case", ["grow", "death", "two_tier_host_loss"])
def test_world_resizes_through_the_port_launcher(case, tmp_path):
    _resize_case(case, tmp_path, None)


@pytest.mark.parametrize("case", ["grow", "death", "two_tier_host_loss"])
def test_world_resizes_on_the_python_coordinator(case, tmp_path):
    _resize_case(case, tmp_path, "0")


def _death_case(run, two_tier):
    if two_tier:
        run.wait_for(r"EPOCH \d+ rank=\d size=4 lr=\d ls=2 cr=\d cs=2 "
                     r"hier=True")
    else:
        run.wait_for(r"EPOCH \d+ rank=\d size=3")
    run.wait_for(r"DYING")
    # The survivors re-form from a committed epoch >= 3; two hosts of two
    # slots become one tier, where the hierarchical path still runs (its
    # cross-host subgroup is one rank).
    run.wait_for(r"EPOCH [3-9]\d* rank=\d size=2 lr=\d ls=2 cr=0 cs=1 "
                 r"hier=True", count=2)
    codes = run.finish()
    logs = run.logs()
    assert len(re.findall(r"DONE rank=\d epoch=\d+ size=2", logs)) == 2
    assert codes["localhost:0"] == codes["localhost:1"] == 0
    assert 1 in [codes[k] for k in codes if k.startswith("127.0.0.1")]


def _json_lines(logs, tag):
    return [json.loads(m) for m in re.findall(tag + r" (\{.*\})", logs)]


def _serial_replay(steps):
    """The committed steps of a run replayed in one process: the same
    initial model, each step's gradient the mean over its ranks'
    batches (Average), one SGD-with-momentum step each.  (Adam would
    turn the rounding noise of gradients that are zero in exact
    arithmetic, such as the key bias's, into full-size steps.)"""
    from horovod_tpu_torch.models import gpt
    S = 16
    cfg = gpt.gpt_tiny_config(dtype=torch.float32, attention_impl="flash",
                              vocab_size=64, max_position_embeddings=S)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(256, S)).astype(np.int64))
    model = gpt.GPTLMHeadModel(cfg, device="cpu", seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for _, by_rank in sorted(steps.items()):
        opt.zero_grad()
        grads = None
        for rank in sorted(by_rank):
            model.zero_grad()
            ids = tokens[by_rank[rank]]
            gpt.lm_loss(model(ids), ids).backward()
            g = [p.grad.clone() for p in model.parameters()]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        for p, g in zip(model.parameters(), grads):
            p.grad = g / len(by_rank)
        opt.step()
    return model.state_dict()


def test_tiny_gpt_survives_a_death_inside_the_backward(tmp_path):
    _tiny_gpt_death(tmp_path, None)


def test_tiny_gpt_survives_a_death_on_the_python_coordinator(tmp_path):
    _tiny_gpt_death(tmp_path, "0")


def _tiny_gpt_death(tmp_path, native):
    out = tmp_path / "params"
    out.mkdir()
    env = {} if native is None else {"HOROVOD_TPU_NATIVE": native}
    with ElasticRun(tmp_path, _GPT_WORKER, "localhost:2\n", 2, 2, 3,
                    extra_env=dict(env, TEST_OUT_DIR=str(out))) as run:
        _gpt_case(run, out)
    want = "CoordinatorServer" if native == "0" else \
        "NativeCoordinatorServer"
    servers = _servers(run.logs())
    assert [size for _, size in servers] == ["2", "3", "2"], servers
    assert {cls for cls, _ in servers} == {want}, servers


def _gpt_case(run, out):
    run.wait_for(r'STEP \{"step": 3, "rank": \d, "size": 2', count=2)
    run.hosts_file.write_text("localhost:2\n127.0.0.1:1\n")
    run.wait_for(r"DYING")
    run.wait_for(r'"size": 2', count=1)
    logs = run.logs()
    death_step = max(s["step"] for s in _json_lines(logs, "STEP")
                     if s["size"] == 3)
    # Three more steps at size 2 after the recovery, on both survivors.
    run.wait_for(r'STEP \{"step": %d, "rank": \d, "size": 2'
                 % (death_step + 3), count=2)
    codes = run.finish()
    logs = run.logs()
    assert codes == {"localhost:0": 0, "localhost:1": 0, "127.0.0.1:0": 1}

    steps, sizes = {}, {0: [], 1: []}
    for s in _json_lines(logs, "STEP"):
        steps.setdefault(s["step"], {})[s["rank"]] = s["idx"]
    synced = _json_lines(logs, "SYNCED")
    for s in synced:
        if s["rank"] in sizes and (not sizes[s["rank"]] or
                                   sizes[s["rank"]][-1] != s["size"]):
            sizes[s["rank"]].append(s["size"])
    assert sizes == {0: [2, 3, 2], 1: [2, 3, 2]}
    # The joiner was synced to rank 0's parameters and AdamW state, and
    # the survivors resumed from the last commit (the step the joiner
    # died in never committed).
    at3 = [s for s in synced if s["size"] == 3]
    assert len({s["sha"] for s in at3}) == 1 and len(at3) == 3
    resumed = [s for s in synced if s["size"] == 2 and s["step"] > 0]
    assert [s["step"] for s in resumed] == [death_step, death_step]
    assert all(len(by_rank) == (3 if at3[0]["step"] < k <= death_step
                                else 2)
               for k, by_rank in steps.items())
    done = _json_lines(logs, "DONE")
    assert len(done) == 2 and done[0]["sha"] == done[1]["sha"]

    final = [torch.load(out / f"rank{r}.pt") for r in (0, 1)]
    want = _serial_replay(steps)
    for name, ref in want.items():
        assert torch.equal(final[0][name], final[1][name]), name
        # Only the order of the gradient sums differs from the replay.
        torch.testing.assert_close(final[0][name], ref, atol=1e-5,
                                   rtol=1e-4, msg=name)


# ---------------------------------------------------------------------------
# the optimizer faults under elastic, in one process
# ---------------------------------------------------------------------------
class _FailingHandle:
    def wait(self, timeout=None):
        raise RuntimeError("collective failed: rank 2 left the job")


class _Handle:
    def __init__(self, t):
        self.t = t

    def wait(self, timeout=None):
        return self.t


def _drive_optimizer(pkg, monkeypatch, plan):
    """Steps of a Linear model through ``pkg``'s DistributedOptimizer
    under ``HOROVOD_ELASTIC=1``, with the world faked: ``plan`` is a list
    of (world size, the step's collectives fail, run()'s reset before
    it).  Returns what each step raised and the allreduces it started."""
    if pkg == "jax":
        import horovod_tpu.torch.optimizer as optmod
        from horovod_tpu.common.basics import global_process_set as ps
        reset = None
    else:
        import horovod_tpu_torch.torch.optimizer as optmod
        from horovod_tpu_torch.common.basics import global_process_set as ps
        reset = optmod.reset_optimizers
    world = {"size": plan[0][0], "fail": False, "calls": 0}
    monkeypatch.setattr(type(ps), "size", lambda self: world["size"])

    def allreduce_async(t, name=None, op=None, prescale_factor=1.0,
                        postscale_factor=1.0, process_set=None):
        world["calls"] += 1
        if world["fail"]:
            return _FailingHandle()
        return _Handle(t if isinstance(t, np.ndarray) else
                       t.detach().clone())
    monkeypatch.setattr(optmod._ops, "allreduce_async", allreduce_async)
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")

    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = optmod.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    x = torch.randn(4, 3)
    seen = []
    for size, fail, do_reset in plan:
        world.update(size=size, fail=fail, calls=0)
        if do_reset and reset is not None:
            reset()
        try:
            opt.zero_grad()
            model(x).sum().backward()
            opt.step()
            seen.append(("ok", world["calls"]))
        except Exception as e:
            seen.append((type(e).__name__, world["calls"]))
    return seen


@pytest.mark.parametrize("fault", ["death_mid_step", "shrink_to_one",
                                   "grow_from_one"])
def test_port_optimizer_recovers_where_the_jax_one_trips(fault,
                                                          monkeypatch):
    plan = {
        # A peer dies after the hooks fired; run() restores and resets.
        "death_mid_step": [(2, True, False), (2, False, True),
                           (2, False, False)],
        # The world shrinks to one rank between two steps.
        "shrink_to_one": [(2, False, False), (1, False, True),
                          (1, False, False)],
        # A world of one grows to two.
        "grow_from_one": [(1, False, False), (2, False, True),
                          (2, False, False)],
    }[fault]
    with monkeypatch.context() as m:
        jax_seen = _drive_optimizer("jax", m, plan)
    with monkeypatch.context() as m:
        port_seen = _drive_optimizer("port", m, plan)
    if fault == "death_mid_step":
        # The failed step's handles outlive synchronize's raise: the next
        # backward's hooks assert in the JAX package.
        assert [s for s, _ in jax_seen] == ["RuntimeError",
                                            "AssertionError",
                                            "AssertionError"]
        assert port_seen == [("RuntimeError", 2), ("ok", 2), ("ok", 2)]
    elif fault == "shrink_to_one":
        # At size 1 synchronize returns without clearing the handles the
        # hooks left: the JAX package's second step at size 1 asserts.
        assert [s for s, _ in jax_seen] == ["ok", "ok", "AssertionError"]
        assert port_seen == [("ok", 2), ("ok", 0), ("ok", 0)]
    else:
        # Hooks only registered at size > 1: the JAX package never
        # averages once the world grows.
        assert jax_seen == [("ok", 0), ("ok", 0), ("ok", 0)]
        assert port_seen == [("ok", 0), ("ok", 2), ("ok", 2)]
