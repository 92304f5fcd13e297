"""The port's elastic half against the JAX package's, in one process on
the CPU: the same fake discovery sequences, worker exits and injected
clocks go to both packages' ``HostManager``, blacklist, ``ElasticPolicy``,
``WorkerStateRegistry`` and ``ElasticDriver``, and each scenario's trace
of decisions must be equal (the scenarios mirror
``tests/test_elastic_discovery.py``, ``test_elastic_policy.py`` and
``test_elastic_driver.py``, less the TPU-pod case).  Beside them:

* the elastic rendezvous handler's replies are the same bytes;
* ``ElasticSampler`` gives the same indices across sizes and resets;
* ``State``, ``ObjectState`` and ``run_fn`` take the same control flow
  (``tests/test_elastic_state.py``);
* ``TorchState`` save, restore and sync in a world of one give equal
  tensors in both packages;
* the launcher hands ``launch_elastic`` what the JAX launcher hands its
  own.

The end-to-end runs through the port's elastic launcher are in
test_torch_port_elastic_run.py.
"""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu.common.basics as jax_basics
import horovod_tpu.common.elastic as jax_elastic
import horovod_tpu.common.env as jax_env
import horovod_tpu.common.exceptions as jax_exc
import horovod_tpu.runner.elastic.discovery as jax_discovery
import horovod_tpu.runner.elastic.driver as jax_driver
import horovod_tpu.runner.elastic.policy as jax_policy
import horovod_tpu.runner.elastic.rendezvous as jax_rendezvous
import horovod_tpu.runner.hosts as jax_hosts
import horovod_tpu.runner.http_server as jax_http
import horovod_tpu.runner.launch as jax_launch
import horovod_tpu.torch.elastic as jax_torch_elastic
import horovod_tpu_torch.common.basics as port_basics
import horovod_tpu_torch.common.elastic as port_elastic
import horovod_tpu_torch.common.env as port_env
import horovod_tpu_torch.common.exceptions as port_exc
import horovod_tpu_torch.runner.elastic.discovery as port_discovery
import horovod_tpu_torch.runner.elastic.driver as port_driver
import horovod_tpu_torch.runner.elastic.policy as port_policy
import horovod_tpu_torch.runner.elastic.rendezvous as port_rendezvous
import horovod_tpu_torch.runner.hosts as port_hosts
import horovod_tpu_torch.runner.http_server as port_http
import horovod_tpu_torch.runner.launch as port_launch
import horovod_tpu_torch.torch.elastic as port_torch_elastic

PKGS = {
    "jax": types.SimpleNamespace(
        discovery=jax_discovery, driver=jax_driver, policy=jax_policy,
        rendezvous=jax_rendezvous, hosts=jax_hosts, http=jax_http,
        env=jax_env, elastic=jax_elastic, exc=jax_exc, basics=jax_basics,
        torch_elastic=jax_torch_elastic),
    "port": types.SimpleNamespace(
        discovery=port_discovery, driver=port_driver, policy=port_policy,
        rendezvous=port_rendezvous, hosts=port_hosts, http=port_http,
        env=port_env, elastic=port_elastic, exc=port_exc,
        basics=port_basics, torch_elastic=port_torch_elastic),
}


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` for both packages; their traces must
    be equal.  Returns the port's."""
    want = scenario(PKGS["jax"], *args)
    got = scenario(PKGS["port"], *args)
    assert got == want
    return got


def mutable_discovery(pkg, host_slots):
    class MutableDiscovery(pkg.discovery.FixedHosts):
        def set(self, host_slots):
            self._host_slots = dict(host_slots)
    return MutableDiscovery(host_slots)


# ---------------------------------------------------------------------------
# HostManager, HostDiscoveryScript, the blacklist ladder
# ---------------------------------------------------------------------------
def hm_ordering_and_blacklist(pkg, tmp_path):
    disc = mutable_discovery(pkg, {"a": 2, "b": 2})
    hm = pkg.discovery.HostManager(disc)
    trace = [hm.update_available_hosts(), list(hm.current_hosts)]
    disc.set({"c": 1, "a": 2, "b": 2})
    trace += [hm.update_available_hosts(), list(hm.current_hosts)]
    hm.blacklist("b")
    trace += [list(hm.current_hosts), hm.update_available_hosts(),
              list(hm.current_hosts), hm.available_slots()]
    assert trace == [True, ["a", "b"], True, ["a", "b", "c"], ["a", "c"],
                     False, ["a", "c"], 3]
    return trace


def script(pkg, tmp_path, lines, default_slots=2):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("\n".join(lines) + ("\n" if lines else ""))
    return hosts, pkg.discovery.HostDiscoveryScript("cat %s" % hosts,
                                                    default_slots)


def script_parses(pkg, tmp_path):
    _, disc = script(pkg, tmp_path, ["a", "a", "b:3", "", "c:bogus", "d"])
    got = dict(disc.find_available_hosts_and_slots())
    assert got == {"a": 2, "b": 3, "d": 2}
    return got


def script_slot_change_and_readd(pkg, tmp_path):
    hosts, disc = script(pkg, tmp_path, ["a:2", "b:2"])
    hm = pkg.discovery.HostManager(disc)
    trace = [hm.update_available_hosts(), dict(hm.current_hosts)]
    for text in ("a:4\nb:2\n", "a:4\n", "b:2\na:4\n"):
        hosts.write_text(text)
        trace += [hm.update_available_hosts(), list(hm.current_hosts),
                  hm.available_slots()]
    assert trace[-3:] == [True, ["a", "b"], 6]
    return trace


def script_glitches_keep_last_good(pkg, tmp_path):
    hosts, disc = script(pkg, tmp_path, ["a:2", "b:2"])
    trace = [dict(disc.find_available_hosts_and_slots())]
    hosts.write_text("")                  # empty output: a glitch
    trace.append(dict(disc.find_available_hosts_and_slots()))
    hosts.write_text("a:2\n")             # a real removal applies
    trace.append(dict(disc.find_available_hosts_and_slots()))
    hosts.unlink()                        # cat fails: last good
    trace.append(dict(disc.find_available_hosts_and_slots()))
    assert trace == [{"a": 2, "b": 2}, {"a": 2, "b": 2}, {"a": 2},
                     {"a": 2}]
    with pytest.raises(RuntimeError):
        pkg.discovery.HostDiscoveryScript("true", 2) \
            .find_available_hosts_and_slots()
    return trace


def blacklist_ladder(pkg, tmp_path):
    clock = [0.0]
    disc = mutable_discovery(pkg, {"a": 1, "b": 1})
    hm = pkg.discovery.HostManager(disc, cooldown_s=10.0,
                                   now=lambda: clock[0])
    hm.update_available_hosts()
    trace = []
    for t in (0.0, 10.0):
        clock[0] = t
        hm.blacklist("a")
        trace.append(hm.blacklist_info("a"))
        clock[0] = t + 9.0 + 10.0 * (t > 0)
        trace.append(hm.is_blacklisted("a"))
        clock[0] = t + 10.0 + 10.0 * (t > 0)
        trace.append(hm.is_blacklisted("a"))
        hm.update_available_hosts()
        trace.append(list(hm.current_hosts))
    assert trace[0] == (1, 10.0) and trace[4] == (2, 20.0)
    # The cap: the sit-out stops doubling.
    hm2 = pkg.discovery.HostManager(mutable_discovery(pkg, {"a": 1}),
                                    cooldown_s=1.0, now=lambda: clock[0])
    for _ in range(pkg.env.BLACKLIST_MAX_STRIKE_DOUBLINGS + 3):
        hm2.blacklist("a")
        _, remaining = hm2.blacklist_info("a")
        trace.append(remaining)
        clock[0] += remaining
    hm3 = pkg.discovery.HostManager(mutable_discovery(pkg, {"a": 1}),
                                    cooldown_s=0.0, now=lambda: clock[0])
    hm3.blacklist("a")
    clock[0] += 1e9
    trace += [hm3.blacklist_info("a"), hm3.is_blacklisted("a")]
    assert trace[-2:] == [(1, None), True]
    return trace


def pending_admission(pkg, tmp_path):
    disc = mutable_discovery(pkg, {"a": 2, "b": 2})
    hm = pkg.discovery.HostManager(disc)
    hm.update_available_hosts()
    disc.set({"a": 4, "c": 2, "d": 2, "e": 2})
    trace = [hm.update_available_hosts(admit_new=False),
             dict(hm.current_hosts), list(hm.pending_hosts())]
    trace.append(hm.admit_pending(max_slots=2))
    hm.blacklist("d")
    trace += [list(hm.pending_hosts()), hm.admit_pending(),
              list(hm.current_hosts), hm.available_slots()]
    assert trace == [True, {"a": 4}, ["c", "d", "e"], ["c"], ["e"], ["e"],
                     ["a", "c", "e"], 8]
    return trace


@pytest.mark.parametrize("scenario", [
    hm_ordering_and_blacklist, script_parses, script_slot_change_and_readd,
    script_glitches_keep_last_good, blacklist_ladder, pending_admission,
], ids=lambda f: f.__name__)
def test_host_manager_and_discovery_match_jax(scenario, tmp_path):
    both(scenario, tmp_path)


def test_hung_discovery_script_is_cut_in_both(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_DISCOVERY_TIMEOUT", "0.2")

    def hung(pkg):
        flag = tmp_path / "hang"
        if flag.exists():
            flag.unlink()
        hosts = tmp_path / "hosts.txt"
        hosts.write_text("a:2\n")
        disc = pkg.discovery.HostDiscoveryScript(
            "if [ -f %s ]; then sleep 5; fi; cat %s" % (flag, hosts), 2)
        trace = [dict(disc.find_available_hosts_and_slots())]
        flag.write_text("")
        t0 = time.monotonic()
        trace.append(dict(disc.find_available_hosts_and_slots()))
        assert time.monotonic() - t0 < 4
        return trace

    assert both(hung) == [{"a": 2}, {"a": 2}]


def test_tpu_pod_discovery_is_left_out():
    assert hasattr(jax_discovery, "TPUPodDiscovery")
    assert not hasattr(port_discovery, "TPUPodDiscovery")


# ---------------------------------------------------------------------------
# ElasticPolicy: the same signals and clock give the same decisions
# ---------------------------------------------------------------------------
def _decisions(pkg, ticks, policy_kw=None, dt=1.0):
    """Feed ``ticks`` (dicts of Signals fields, or ("at", t) clock jumps,
    or ("external",) resizes) to a policy; return its decisions."""
    clock = [0.0]
    kw = dict(window=3, cooldown_s=30.0, migrate_after_s=10.0, min_np=2,
              max_np=8)
    kw.update(policy_kw or {})
    p = pkg.policy.ElasticPolicy(now=lambda: clock[0], **kw)
    out = []
    for tick in ticks:
        if isinstance(tick, tuple) and tick[0] == "at":
            clock[0] = tick[1]
            continue
        if tick == ("external",):
            p.note_external_resize()
            out.append(("cooldown", p.in_cooldown()))
            continue
        d = p.observe(pkg.policy.Signals(**tick))
        clock[0] += dt
        out.append(None if d is None else
                   (d.kind, d.trigger, d.rank, d.reason))
    return out


def _pending(n=1, size=4, **kw):
    return dict(world_size=size, pending_hosts=n, **kw)


POLICY_CASES = {
    "hysteresis": [_pending()] * 3,
    "noisy_tick_resets": [_pending(), _pending(), _pending(0)] +
                         [_pending()] * 3,
    "cooldown": [_pending()] * 13 + [("at", 40.0), _pending()],
    "external_resize": [("external",)] + [_pending()] * 5,
    "max_np_caps": [_pending(size=8)] * 6,
    "cycle_instability": [_pending(cycle_time_s=0.1)] * 2 +
                         [_pending(cycle_time_s=0.5)] +
                         [_pending(cycle_time_s=0.1)] * 3,
    "migrate_persistence": [dict(world_size=4,
                                 straggler_scores={3: 7.0})] * 11,
    "flag_gap": [dict(world_size=4, straggler_scores={3: 7.0})] * 8 +
                [dict(world_size=4)] +
                [dict(world_size=4, straggler_scores={3: 7.0})] * 11,
    "min_np_floor": [dict(world_size=2, straggler_scores={1: 9.0})] * 20,
    "longest_flagged": [dict(world_size=4, straggler_scores={5: 3.0})] +
                       [dict(world_size=4,
                             straggler_scores={5: 3.0, 2: 9.0})] * 12,
    "migrate_outranks_scale_up": [_pending(straggler_scores={3: 7.0})] * 10,
}


@pytest.mark.parametrize("migrate", ["0", "1"])
@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_decisions_match_jax(case, migrate, monkeypatch):
    monkeypatch.setenv("HOROVOD_STRAGGLER_MIGRATE", migrate)
    kw = {"migrate_after_s": 2.0} if case == "migrate_outranks_scale_up" \
        else {}
    got = both(_decisions, POLICY_CASES[case], kw)
    decided = [d for d in got if d is not None and d[0] != "cooldown"]
    if case in ("hysteresis", "noisy_tick_resets", "cycle_instability"):
        assert [d[0] for d in decided] == ["scale_up"]
    if case == "cooldown":
        assert [d[0] for d in decided] == ["scale_up", "scale_up"]
    if case in ("external_resize", "max_np_caps", "min_np_floor"):
        assert decided == []
    if migrate == "1" and case == "longest_flagged":
        assert decided[0][:3] == ("migrate", "straggler_migration", 5)


# ---------------------------------------------------------------------------
# WorkerStateRegistry + ElasticDriver with fake workers
# ---------------------------------------------------------------------------
class FakeWorkers:
    """create_worker_fn whose workers block until released with a code."""

    def __init__(self):
        self.lock = threading.Lock()
        self.events = {}
        self.spawned = []

    def create(self, slot):
        key = (slot.hostname, slot.local_rank)
        ev, box = threading.Event(), [0]
        with self.lock:
            self.events[key] = (ev, box)
            self.spawned.append(key)
        ev.wait(timeout=30)
        return box[0]

    def release(self, host, local_rank, code=0):
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with self.lock:
                if (host, local_rank) in self.events:
                    ev, box = self.events.pop((host, local_rank))
                    box[0] = code
                    ev.set()
                    return
            time.sleep(0.01)
        raise AssertionError(f"worker {(host, local_rank)} never spawned")

    def release_all(self, code=0):
        with self.lock:
            items = list(self.events.values())
            self.events.clear()
        for ev, box in items:
            box[0] = code
            ev.set()


def _slot(s):
    return None if s is None else [s.hostname, s.rank, s.local_rank,
                                   s.cross_rank, s.size, s.local_size,
                                   s.cross_size]


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


def _make(pkg, discovery, min_np, max_np=None, rendezvous=None, **kw):
    return pkg.driver.ElasticDriver(rendezvous=rendezvous,
                                    discovery=discovery, min_np=min_np,
                                    max_np=max_np, timeout=5, **kw)


def driver_start(pkg):
    workers = FakeWorkers()
    d = _make(pkg, pkg.discovery.FixedHosts({"a": 2, "b": 2}), min_np=4)
    d.start(4, workers.create)
    _wait(lambda: len(workers.spawned) == 4)
    slot, world, epoch = d.get_slot_info("b", 1, last_epoch=0)
    trace = [sorted(workers.spawned), _slot(slot), epoch, world]
    workers.release_all(0)
    trace += [d.join(timeout=10), d.error_message, d.get_results()]
    d.stop()
    assert trace[1] == ["b", 3, 1, 1, 4, 2, 2]
    assert "coordinator" not in world and "rank0_addr" in world
    return trace


def driver_failure_replans(pkg, reset_limit=None):
    workers = FakeWorkers()
    d = _make(pkg, pkg.discovery.FixedHosts({"a": 2, "b": 2}), min_np=2,
              reset_limit=reset_limit)
    d.start(4, workers.create)
    _wait(lambda: len(workers.spawned) == 4)
    workers.release("b", 0, code=1)
    _wait(lambda: "b:0" in d.registry.get_recorded("FAILURE"))
    for host, lr in (("a", 0), ("a", 1), ("b", 1)):
        d.record_ready(host, lr)
    trace = [d.finished(), d.error_message]
    if not d.finished():
        slot, _, epoch = d.get_slot_info("a", 1, last_epoch=1)
        retired, _, _ = d.get_slot_info("b", 1, last_epoch=1)
        trace += [_slot(slot), epoch, _slot(retired),
                  d.host_manager.is_blacklisted("b"),
                  d.registry.reset_count]
        assert trace[2] == ["a", 1, 1, 0, 2, 2, 1]
        assert retired == pkg.hosts.INVALID_SLOT_INFO
    else:
        assert "reset limit" in d.error_message
    workers.release_all(0)
    d.stop()
    return trace


def driver_reset_limit(pkg):
    return driver_failure_replans(pkg, reset_limit=0)


def driver_growth(pkg, env=None):
    workers = FakeWorkers()
    disc = mutable_discovery(pkg, {"a": 2})
    d = _make(pkg, disc, min_np=2)
    d.start(2, workers.create)
    disc.set({"a": 2, "b": 2})
    policy = env is None or env.get("HOROVOD_ELASTIC_POLICY") != "0"
    gated = env is not None and env.get("HOROVOD_ELASTIC_SCALE_UP") == "0"
    if gated:
        _wait(lambda: "b" in d.host_manager.pending_hosts())
        trace = [list(d.host_manager.pending_hosts()),
                 d.host_manager.available_slots(), d.epoch]
    else:
        _wait(lambda: d.host_manager.available_slots() == 4)
        trace = [d.host_manager.available_slots(),
                 list(d.host_manager.pending_hosts())]
        d.record_ready("a", 0)
        d.record_ready("a", 1)
        slot, _, epoch = d.get_slot_info("a", 0, last_epoch=1)
        _wait(lambda: len(workers.spawned) == 4)
        trace += [_slot(slot), epoch, sorted(workers.spawned), policy]
    workers.release_all(0)
    d.stop()
    return trace


def driver_migration(pkg):
    workers = FakeWorkers()
    rdv = pkg.http.RendezvousServer(secret="")
    rdv.start()
    try:
        d = _make(pkg, pkg.discovery.FixedHosts({"a": 2}), min_np=1,
                  rendezvous=rdv)
        d.start(2, workers.create)
        rdv.kvstore.put("elastic", "slow-1", json.dumps(
            {"rank": 1, "score": 7.5, "wall": time.time()}).encode())
        d._poll_slow_ranks()
        trace = [dict(d._slow_active), d._policy_tick(),
                 d._migration["rank"],
                 sorted(d.registry.get_recorded("FAILURE")),
                 d._tick_migration(),
                 sorted(d.registry.get_recorded("FAILURE"))]
        d.record_ready("a", 1)
        trace.append(sorted(d.registry.get_recorded("FAILURE")))
        # A slow notice past its staleness bound is ignored.
        rdv.kvstore.put("elastic", "slow-1", json.dumps(
            {"rank": 1, "score": 7.5, "wall": time.time() -
             pkg.driver.SLOW_NOTICE_STALE_S - 1}).encode())
        d._poll_slow_ranks()
        trace.append(dict(d._slow_active))
        d.stop()
        workers.release_all(0)
    finally:
        rdv.stop()
    assert trace == [{1: 7.5}, False, 1, [], True, ["a:1"], ["a:1"], {}]
    return trace


def driver_kv_notices(pkg):
    workers = FakeWorkers()
    rdv = pkg.http.RendezvousServer(secret="")
    rdv.start()
    try:
        d = _make(pkg, pkg.discovery.FixedHosts({"a": 2}), min_np=2,
                  rendezvous=rdv)
        d.start(2, workers.create)
        snap = json.loads(rdv.kvstore.get("metrics", "driver").decode())
        trace = [snap["counters"]["hvd_elastic_epochs_total"] >= 1,
                 snap["gauges"]["hvd_elastic_world_size"]]
        epoch = d.epoch
        for e in (epoch + 7, epoch, epoch):   # stale, current, repeat
            rdv.kvstore.put("elastic", "lost-1", json.dumps(
                {"rank": 1, "reason": "liveness timeout",
                 "epoch": e}).encode())
            d._poll_lost_ranks()
            trace.append(sorted(d.registry.get_recorded("FAILURE")))
        workers.release_all(0)
        d.stop()
    finally:
        rdv.stop()
    assert trace == [True, 2, [], ["a:1"], ["a:1"]]
    return trace


def driver_all_success(pkg):
    workers = FakeWorkers()
    d = _make(pkg, pkg.discovery.FixedHosts({"a": 2}), min_np=2)
    d.start(2, workers.create)
    _wait(lambda: len(workers.spawned) == 2)
    workers.release_all(0)
    trace = [d.join(timeout=10), d.finished(), d.error_message,
             d.get_results()]
    assert trace == [True, True, None, {"a:0": 0, "a:1": 0}]
    return trace


@pytest.mark.parametrize("scenario,env", [
    (driver_start, None),
    (driver_failure_replans, None),
    (driver_reset_limit, None),
    (driver_growth, None),
    (driver_growth, {"HOROVOD_ELASTIC_SCALE_UP": "0"}),
    (driver_growth, {"HOROVOD_ELASTIC_POLICY": "0"}),
    (driver_migration, {"HOROVOD_STRAGGLER_MIGRATE": "1",
                        "HOROVOD_STRAGGLER_MIGRATE_AFTER": "0",
                        "HOROVOD_STRAGGLER_MIGRATE_CKPT_WAIT": "0"}),
    (driver_kv_notices, None),
    (driver_all_success, None),
], ids=lambda v: v.__name__ if callable(v) else
    ",".join(f"{k}={x}" for k, x in (v or {}).items()) or "default")
def test_driver_and_registry_match_jax(scenario, env, monkeypatch):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    if scenario is driver_growth:
        both(scenario, env)
    else:
        both(scenario)


# ---------------------------------------------------------------------------
# the elastic rendezvous handler: the same bytes
# ---------------------------------------------------------------------------
class _FakeDriver:
    def __init__(self, pkg, answer):
        self.pkg, self.answer, self.ready = pkg, answer, []

    def record_ready(self, host, slot):
        self.ready.append((host, slot))

    def get_slot_info(self, host, local_rank, last_epoch):
        kind = self.answer
        world = {"epoch": 3, "size": 4, "rank0_addr": "10.0.0.1",
                 "generation": 5, "ckpt_latest_step": 40,
                 "not_forwarded": 1}
        if kind == "pending":
            return None, {}, 2
        if kind == "invalid":
            return self.pkg.hosts.INVALID_SLOT_INFO, world, 3
        slots = self.pkg.hosts.get_host_assignments(
            [self.pkg.hosts.HostInfo("h0", 2), self.pkg.hosts.HostInfo(
                host, 2)], 4, 4)
        if kind == "legacy":
            world = dict(world, coordinator="10.0.0.1:1",
                         controller_addr="10.0.0.1:2")
        slot = next(s for s in slots if s.hostname == host and
                    s.local_rank == local_rank)
        return slot, world, 3


def _rendezvous_reply(pkg, answer, last_epoch):
    server = pkg.http.RendezvousServer(
        handler_cls=pkg.rendezvous.ElasticRendezvousHandler, secret="")
    port = server.start()
    driver = _FakeDriver(pkg, answer)
    server._httpd.elastic_driver = driver
    try:
        url = (f"http://127.0.0.1:{port}/"
               f"{pkg.env.GET_RANK_AND_SIZE}/w1:1?last_epoch={last_epoch}")
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read(), driver.ready
    finally:
        server.stop()


@pytest.mark.parametrize("answer", ["slot", "legacy", "pending", "invalid"])
@pytest.mark.parametrize("last_epoch", [0, 2])
def test_rendezvous_replies_are_the_same_bytes(answer, last_epoch):
    status, body, ready = both(_rendezvous_reply, answer, last_epoch)
    assert status == 200
    reply = json.loads(body)
    # A survivor's re-rendezvous is its arrival at the reset barrier.
    assert ready == ([] if last_epoch == 0 else [("w1", 1)])
    if answer in ("slot", "legacy"):
        assert (reply["rank"], reply["size"], reply["epoch"]) == (3, 4, 3)
        assert "not_forwarded" not in reply
        assert ("coordinator" in reply) == (answer == "legacy")


# ---------------------------------------------------------------------------
# ElasticSampler
# ---------------------------------------------------------------------------
def _sampler_trace(pkg, shuffle, plan):
    """Indices of every rank of a sampler through ``plan``: a list of
    (size, batches processed before the next resize)."""
    basics = pkg.basics
    world = {"size": 1, "rank": 0}
    saved = (basics.size, basics.rank, basics.is_initialized)
    basics.size = lambda: world["size"]
    basics.rank = lambda: world["rank"]
    basics.is_initialized = lambda: True
    try:
        class DS:
            def __len__(self):
                return 23
        trace = []
        state = None
        for size, batches in plan:
            per_rank = []
            for rank in range(size):
                world.update(size=size, rank=rank)
                s = pkg.torch_elastic.ElasticSampler(DS(), shuffle=shuffle,
                                                     seed=7)
                if state is not None:
                    s.load_state_dict(state)
                per_rank.append((list(iter(s)), len(s)))
            trace.append(per_rank)
            # Every rank records its first ``batches`` batches of 2.
            merged = None
            for rank in range(size):
                world.update(size=size, rank=rank)
                s = pkg.torch_elastic.ElasticSampler(DS(), shuffle=shuffle,
                                                     seed=7)
                if state is not None:
                    s.load_state_dict(state)
                for b in range(batches):
                    s.record_batch(b, 2)
                merged = s.state_dict() if merged is None else {
                    "epoch": merged["epoch"],
                    "processed_indices": sorted(
                        set(merged["processed_indices"]) |
                        set(s.state_dict()["processed_indices"]))}
            state = merged
        return trace
    finally:
        basics.size, basics.rank, basics.is_initialized = saved


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("plan", [[(2, 2), (3, 1), (2, 1)],
                                  [(1, 3), (4, 1), (3, 0)]])
def test_elastic_sampler_indices_match_jax(shuffle, plan):
    trace = both(_sampler_trace, shuffle, plan)
    # No index is lost across resizes: every rank's share at the first
    # size covers the dataset.
    first = trace[0]
    assert sorted({i for idx, _ in first for i in idx}) == list(range(23))


# ---------------------------------------------------------------------------
# State / ObjectState / run_fn control flow
# ---------------------------------------------------------------------------
def _state_flow(pkg):
    el, exc = pkg.elastic, pkg.exc
    log = []

    class Simple(el.State):
        def __init__(self):
            super().__init__()
            self.value, self.committed = 10, None

        def save(self):
            log.append(("save", self.value))
            self.committed = self.value

        def restore(self):
            log.append(("restore", self.committed))
            self.value = self.committed

        def sync(self):
            log.append(("sync", self.value))

        def reset(self):
            log.append(("reset",))

    el.set_host_update_source(None)
    src = el.QueueHostUpdateSource()
    el.set_host_update_source(src)
    try:
        s = Simple()
        s.register_reset_callbacks([lambda: log.append(("callback",))])
        calls = []

        def train(state):
            calls.append(1)
            if len(calls) == 1:
                state.commit()
                state.value = 55
                raise exc.HorovodInternalError("collective failed")
            if len(calls) == 2:
                state.value = 7
                src.put()
                state.commit()          # raises HostsUpdatedInterrupt
            if len(calls) == 3:
                raise exc.HostsUpdatedInterrupt(skip_sync=True)
            return state.value

        result = el.run_fn(train, lambda: log.append(("world_reset",)))(s)
        log.append(("result", result))

        o = el.ObjectState(bcast_object=lambda obj: dict(obj, batch=0),
                           get_rank=lambda: 0, epoch=5, batch=2)
        o.epoch = 6
        o.save()
        o.epoch = 99
        o.restore()
        log.append(("object", o.epoch, o.batch))
        o.sync()
        log.append(("object_synced", o.epoch, o.batch))
        log.append(("durable", o.durable_state_dict()))
    finally:
        el.set_host_update_source(None)
    return log


def test_state_object_state_and_run_fn_match_jax():
    log = both(_state_flow)
    assert ("restore", 10) in log and ("result", 7) in log
    # skip_sync: the third attempt's HostsUpdatedInterrupt(skip_sync=True)
    # resets without a sync before the fourth.
    assert [e[0] for e in log].count("sync") == 3


# ---------------------------------------------------------------------------
# TorchState in a world of one
# ---------------------------------------------------------------------------
def _torch_state(pkg):
    basics = pkg.basics
    was_initialized = basics.is_initialized()
    basics.init()
    try:
        rng = np.random.RandomState(3)
        model = torch.nn.Sequential(torch.nn.Linear(5, 4),
                                    torch.nn.Linear(4, 2))
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(
                    rng.randn(*p.shape).astype(np.float32)))
        opt = torch.optim.AdamW(model.parameters(), lr=0.1)
        x = torch.from_numpy(rng.randn(6, 5).astype(np.float32))

        def step():
            opt.zero_grad()
            model(x).square().sum().backward()
            opt.step()

        step()
        state = pkg.torch_elastic.TorchState(model, opt, epoch=1)
        committed = {k: v.clone() for k, v in model.state_dict().items()}
        committed_opt = opt.state_dict()["state"][0]["exp_avg"].clone()
        step()
        state.epoch = 2
        state.restore()
        out = [model.state_dict(), opt.state_dict()["state"][0]["exp_avg"],
               state.epoch]
        assert all(torch.equal(out[0][k], committed[k]) for k in committed)
        assert torch.equal(out[1], committed_opt)
        step()
        state.commit()
        state.sync()
        out.append({k: v.clone() for k, v in model.state_dict().items()})
        out.append(opt.state_dict()["state"][1]["exp_avg_sq"].clone())
        return out
    finally:
        if not was_initialized:
            basics.shutdown()


def test_torch_state_save_restore_sync_match_jax():
    want = _torch_state(PKGS["jax"])
    got = _torch_state(PKGS["port"])
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
    assert got[2] == want[2] == 1


# ---------------------------------------------------------------------------
# the launcher's elastic path
# ---------------------------------------------------------------------------
def test_launcher_hands_launch_elastic_what_the_jax_launcher_does(
        monkeypatch):
    seen = {}

    def capture(pkg):
        def fake(command, **kw):
            disc = kw.pop("discovery")
            seen[pkg] = dict(kw, command=command,
                             discovery=(type(disc).__name__, disc._script,
                                        disc._default_slots))
            return {"h:0": 0}
        return fake

    import horovod_tpu.runner.elastic_run as jax_er
    import horovod_tpu_torch.runner.elastic_run as port_er
    monkeypatch.setattr(jax_er, "launch_elastic", capture("jax"))
    monkeypatch.setattr(port_er, "launch_elastic", capture("port"))
    argv = ["-np", "2", "--min-np", "2", "--max-np", "3",
            "--host-discovery-script", "./discover.sh", "--slots-per-host",
            "2", "--reset-limit", "4", "--elastic-timeout", "30",
            "--cycle-time-ms", "2", "--verbose", "python", "train.py"]
    assert jax_launch._run(jax_launch.parse_args(argv)) == {"h:0": 0}
    assert port_launch._run(port_launch.parse_args(argv)) == {"h:0": 0}
    assert seen["port"] == seen["jax"]
    assert seen["port"]["min_np"] == 2 and seen["port"]["max_np"] == 3
    # --network-interface binds the data plane of elastic workers too.
    port_launch._run(port_launch.parse_args(
        ["--network-interface", "lo"] + argv))
    assert seen["port"]["extra_worker_env"]["GLOO_SOCKET_IFNAME"] == "lo"
