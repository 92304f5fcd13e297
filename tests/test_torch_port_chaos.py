"""The port's chaos soak (``horovod_tpu_torch/tools/chaos_soak.py``), held
against the JAX package's ``tools/chaos_soak.py`` on the CPU: the
harness (tags, the simulated data plane, the world's device), the seeded
schedules, the soak and its CLI, and the replay-kill and serve drills.

Each drill runs with the JAX tier-1 tests' arguments
(tests/test_chaos_smoke.py), asserts their gates, and its deterministic
fields equal the JAX drill's on the same seed.  The checkpoint, MTTR,
relay, straggler, tune and autoscale drills are in
test_torch_port_chaos_drills.py.  The data plane runs on the CPU here
(``device="cpu"``); ``chip_smoke.py``'s ``chaos`` phase runs it on the
card.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common import failpoints
from horovod_tpu_torch.common import lockwitness
from horovod_tpu_torch.tools import chaos_soak as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's ``tools/chaos_soak.py`` under a name of its own
    (other test files import it by its plain name)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_chaos_soak", os.path.join(REPO, "tools",
                                             "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def lock_witness():
    """The port's lock-order witness armed around a test, which fails on
    any recorded cycle (the JAX suite's fixture, on the port's module)."""
    lockwitness.reset()
    lockwitness.enable(package_filter="horovod_tpu_torch")
    try:
        yield lockwitness
        lockwitness.assert_no_cycles()
    finally:
        lockwitness.disable()
        lockwitness.reset()


def _triggers(rec):
    """{site: [triggers of each rule]}: the part of a record's failpoint
    counts that the schedule fixes (``evals`` counts polls, which follow
    the timing)."""
    return {site: [r["triggers"] for r in rules]
            for site, rules in rec["failpoint_triggers"].items()}


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def test_tag_rides_a_new_tensor_object_over_the_same_data():
    value = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = cs.tagged(value, ("w", 3))
    assert out is not value and out.tag == ("w", 3)
    assert not hasattr(value, "tag")
    assert out.data_ptr() == value.data_ptr()
    strided = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()
    out = cs.tagged(strided, ("s", 0))
    assert out.is_contiguous() and out.tag == ("s", 0)
    torch.testing.assert_close(out, strided, rtol=0, atol=0)


def test_runtime_hands_the_tagged_tensor_to_the_backend():
    """The runtime passes each entry's own tensor object to the backend,
    so the logical tag the exchanger pairs by arrives intact (nothing on
    the way makes it contiguous or views it)."""
    seen = []
    world = cs.ChaosWorld(2, stall_shutdown_s=4.0, device=CPU)
    try:
        for rt in world.runtimes:
            backend = rt.state.backend
            inner = backend.allreduce

            def spy(tensors, *a, _inner=inner, **k):
                seen.extend((type(t), getattr(t, "tag", None))
                            for t in tensors)
                return _inner(tensors, *a, **k)
            backend.allreduce = spy
        outs = {}

        def go(r):
            outs[r] = world.collective(
                r, "allreduce", "tag.w", np.full((5,), r + 1.0,
                                                 np.float32), 7, 15.0)
        ts = [threading.Thread(target=go, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
    finally:
        world.close()
    assert seen and all(tag == ("tag.w", 7) for _, tag in seen), seen
    assert all(issubclass(cls, torch.Tensor) for cls, _ in seen)
    for r in range(2):
        assert world.correct(outs[r], np.full((5,), 3.0, np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
@pytest.mark.parametrize("reduce_op,prescale,postscale",
                         [("Sum", 1.0, 1.0), ("Average", 0.5, 3.0)])
def test_sim_backend_computes_what_the_reference_sim_computes(
        dtype, reduce_op, prescale, postscale):
    """Three ranks' allreduce and broadcast through each package's
    simulated data plane, on the same values: equal results in the
    input's dtype (values on a 1/8 grid, so every float64 sum is exact
    in any arrival order)."""
    jcs = _jax()
    size = 3
    rng = np.random.RandomState(5)
    vals = [[(rng.randint(-64, 64, size=n) / 8.0).astype(dtype)
             for n in (7, 1, 33)] for _ in range(size)]

    def run(make_backend, wrap):
        outs = {}
        backends = [make_backend(r, size) for r in range(size)]

        def go(r):
            arrays = [wrap(v, ("t%d" % i, 0))
                      for i, v in enumerate(vals[r])]
            ar = backends[r].allreduce(arrays, reduce_op, prescale,
                                       postscale)
            bc = backends[r].broadcast(
                [wrap(v, ("b%d" % i, 0)) for i, v in enumerate(vals[r])],
                1)
            outs[r] = (ar, bc)
        ts = [threading.Thread(target=go, args=(r,)) for r in range(size)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
        return outs

    jex = jcs.SimExchanger(size, 10.0)
    ref = run(lambda r, n: jcs.SimBackend(r, n, jex), jcs.tagged)
    pex = cs.SimExchanger(size, 10.0)
    got = run(lambda r, n: cs.SimBackend(r, n, pex),
              lambda v, tag: cs.tagged(torch.from_numpy(v), tag))
    for r in range(size):
        for ours, theirs in zip(got[r][0] + got[r][1],
                                ref[r][0] + ref[r][1]):
            assert ours.dtype == torch.from_numpy(theirs).dtype
            np.testing.assert_array_equal(ours.numpy(), theirs)


def test_world_device_defaults_to_the_card_and_never_falls_back(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.ChaosWorld(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.run_schedule(cs.generate_schedule(0, 0, 2), 2, 2)
    assert cs.resolve_device("cpu") == torch.device("cpu")


def test_misplaced_result_is_not_correct():
    world = cs.ChaosWorld(2, device=CPU)
    try:
        good = torch.full((3,), 2.0)
        assert world.correct(good, np.full((3,), 2.0, np.float32))
        assert not world.correct(good.double(),
                                 np.full((3,), 2.0, np.float32))
        assert not world.correct(good.numpy(),
                                 np.full((3,), 2.0, np.float32))
        assert not world.correct(good, np.full((3,), 2.5, np.float32))
    finally:
        world.close()


def _lonely_then_kill(module, **kw):
    """Rank 2 of a three-rank world submits a name no peer submits, then
    the harness kills it: (the error its caller got, seconds it waited)."""
    world = module.ChaosWorld(3, stall_shutdown_s=4.0, **kw)
    box = {}

    def go():
        t = time.monotonic()
        try:
            world.collective(2, "allreduce", "lonely",
                             np.ones(4, np.float32), 0, 3.0)
        except Exception as e:   # the outcome under test
            box["err"] = e
        box["s"] = time.monotonic() - t
    try:
        th = threading.Thread(target=go)
        th.start()
        time.sleep(0.3)          # queued: no peer will ever match it
        world.kill_rank(2)
        th.join(timeout=15)
        assert not th.is_alive()
    finally:
        world.close()
    return box["err"], box["s"]


@pytest.mark.chaos
def test_killed_rank_leaves_no_caller_waiting():
    """A rank killed between its submit and its response: the dead
    rank's own caller ends at once with ``SimCrash``.  The JAX harness
    leaves it waiting to the hang budget, which failed the relay
    matrix's kill-during-negotiation cell (the victim's thread, not a
    survivor, raised ``HangError``)."""
    err, waited = _lonely_then_kill(cs, device=CPU)
    assert isinstance(err, cs.SimCrash), err
    assert waited < 2.0, waited
    jax_err, jax_waited = _lonely_then_kill(_jax())
    assert isinstance(jax_err, _jax().HangError), jax_err
    assert jax_waited >= 3.0


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [4, 8, 16])
def test_generate_schedule_equals_reference(ranks):
    jcs = _jax()
    assert cs.BASELINE_SPEC == jcs.BASELINE_SPEC
    for seed in range(50):
        for i in range(6):
            assert cs.generate_schedule(seed, i, ranks) == \
                jcs.generate_schedule(seed, i, ranks), (seed, i)


def test_schedule_generation_deterministic():
    a = [cs.generate_schedule(5, i, 8)["spec"] for i in range(6)]
    b = [cs.generate_schedule(5, i, 8)["spec"] for i in range(6)]
    c = [cs.generate_schedule(6, i, 8)["spec"] for i in range(6)]
    assert a == b
    assert a != c
    assert a[0] == cs.BASELINE_SPEC


def test_soak_closed_forms_equal_reference():
    jcs = _jax()
    for n_ops in (0, 1, 8, 12, 25, 30, 77):
        assert cs._op_list(n_ops) == jcs._op_list(n_ops)
    for ranks in (2, 4, 8, 16):
        for op in range(0, 40):
            assert cs._rank_value(ranks - 1, op) == \
                jcs._rank_value(ranks - 1, op)
            for shape in ((257,), (129,), (65,), (64,), (33,)):
                ours = cs._expected_allreduce(shape, op, ranks)
                theirs = jcs._expected_allreduce(shape, op, ranks)
                assert ours.dtype == theirs.dtype
                np.testing.assert_array_equal(ours, theirs)
    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 5, 9):
        vals = list(rng.uniform(0, 3, size=n))
        for q in (50, 90):
            assert cs._percentile(vals, q) == jcs._percentile(vals, q)


# ---------------------------------------------------------------------------
# the three tier-1 schedules (tests/test_chaos_smoke.py), beside the JAX
# package's run on the same schedule
# ---------------------------------------------------------------------------

_BASELINE = {"index": 0, "spec": cs.BASELINE_SPEC, "seed": 7,
             "kind": "baseline"}
_DROP = {"index": 1, "spec": "worker.frame_send=drop(1,after=4,rank=3)",
         "seed": 3, "kind": "fault"}
_CRASH = {"index": 2, "spec": "runtime.submit=crash(after=3,times=1,rank=5)",
          "seed": 11, "kind": "fault"}


def _schedule_pair(schedule):
    kw = dict(ranks=8, n_ops=12, hang_timeout_s=30.0, stall_shutdown_s=2.0)
    ours = cs.run_schedule(dict(schedule), device=CPU, **kw)
    theirs = _jax().run_schedule(dict(schedule), **kw)
    for key in ("outcome", "ops_ok", "index", "kind", "spec", "seed",
                "ops_per_rank"):
        assert ours[key] == theirs[key], (key, ours[key], theirs[key])
    assert _triggers(ours) == _triggers(theirs)
    assert sorted(ours) == sorted(theirs)
    return ours


@pytest.mark.chaos
def test_chaos_smoke_baseline_8_ranks(lock_witness):
    """No-fault control lane under the port's lock-order witness: every
    collective completes and reduces correctly, on the CPU here."""
    rec = _schedule_pair(_BASELINE)
    assert rec["outcome"] == "ok", rec
    assert rec["ops_ok"] == [12] * 8
    assert not rec["hangs"] and not rec["incorrect"]
    assert lock_witness.edge_count() > 0, \
        "lock witness recorded no acquisition edges — wrapping broke"


@pytest.mark.chaos
def test_chaos_smoke_drop_recovers_8_ranks():
    rec = _schedule_pair(_DROP)
    assert rec["outcome"] == "recovered", rec
    assert not rec["hangs"] and not rec["incorrect"]
    assert rec["failures"], "the drop must surface as a detected error"
    assert rec["recovery_latency_s"] is not None
    assert rec["recovery_latency_s"] < 30.0
    trig = rec["failpoint_triggers"]["worker.frame_send"][0]
    assert trig["triggers"] == 1


@pytest.mark.chaos
def test_chaos_smoke_injected_crash_recovers_8_ranks():
    rec = _schedule_pair(_CRASH)
    assert rec["outcome"] == "recovered", rec
    assert any(f.get("crashed") for f in rec["failures"]), rec
    assert rec["recovery_latency_s"] is not None


@pytest.mark.chaos
def test_worlds_leak_no_env_or_armed_failpoints():
    """A port world and a JAX world, one after the other in one process,
    each with a fault armed: neither leaves a HOROVOD_* variable or an
    armed failpoint behind, in its own package or the other's."""
    from horovod_tpu.common import failpoints as jax_failpoints
    before = {k: v for k, v in os.environ.items()
              if k.startswith("HOROVOD_")}
    spec = {"index": 1, "spec": "runtime.submit=delay(2ms,times=2)",
            "seed": 1, "kind": "fault"}
    ours = cs.run_schedule(dict(spec), 4, 4, stall_shutdown_s=2.0,
                           device=CPU)
    assert {k: v for k, v in os.environ.items()
            if k.startswith("HOROVOD_")} == before
    assert failpoints.snapshot() == {} == jax_failpoints.snapshot()
    theirs = _jax().run_schedule(dict(spec), 4, 4, stall_shutdown_s=2.0)
    assert {k: v for k, v in os.environ.items()
            if k.startswith("HOROVOD_")} == before
    assert failpoints.snapshot() == {} == jax_failpoints.snapshot()
    assert ours["outcome"] == theirs["outcome"] == "ok"
    assert _triggers(ours) == _triggers(theirs)


# ---------------------------------------------------------------------------
# replay-kill and serve drills
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_replay_kill_drill_bounded_recovery_8_ranks(lock_witness):
    rec = cs.run_replay_kill_drill(ranks=8, seed=3, hang_timeout_s=20.0,
                                   stall_shutdown_s=2.0, device=CPU)
    assert rec["ok"], {k: rec[k] for k in
                       ("hangs", "incorrect", "recovery_error",
                        "replay_entries", "survivors_engaged")}
    assert not rec["hangs"] and not rec["incorrect"]
    assert rec["replay_entries"] >= 8, \
        "replay never engaged on all ranks"
    assert rec["cycles_replayed"] >= 1
    assert rec["survivors_engaged"]
    assert len(rec["failures"]) >= 2
    assert rec["recovery_latency_s"] is not None
    assert rec["recovery_latency_s"] < 30.0
    # The seeded victim is the JAX drill's (random.Random on the same
    # seed string); no time-dependent field is compared.
    assert rec["victim"] == random.Random(
        "%d|replay-kill" % 3).randrange(1, 8)


@pytest.mark.chaos
def test_serve_drill_trainer_kill_smoke():
    """Trainer killed mid-delta-commit while the port's replica, its
    snapshot on the given device, reads concurrently; the same schedule
    and served steps as the JAX drill."""
    kw = dict(ranks=3, seed=5, steps=15, commit_every=3,
              commit_timeout_s=1.0)
    rec = cs.run_serve_drill(device=CPU, **kw)
    assert rec["ok"], rec
    assert rec["torn_reads"] == 0
    assert rec["committed_before_kill"] == \
        rec["kill_commit"] - rec["commit_every"]
    assert rec["served_during_gap"] == rec["committed_before_kill"]
    assert rec["resumed_to"] == rec["steps"]
    assert rec["reads"] > 0
    theirs = _jax().run_serve_drill(**kw)
    assert theirs["ok"], theirs
    for key in ("victim", "kill_commit", "committed_before_kill",
                "served_during_gap", "resumed_to"):
        assert rec[key] == theirs[key], key
    assert sorted(rec) == sorted(theirs)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _main(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("CHAOSJSON ")]
    assert len(lines) == 1, buf.getvalue()
    return rc, json.loads(lines[0][len("CHAOSJSON "):])


@pytest.mark.chaos
def test_cli_chaosjson_and_artifact_keys_equal_reference(tmp_path):
    argv = ["--ranks", "4", "--schedules", "2", "--ops", "8",
            "--no-ckpt-drill"]
    rc, ours = _main(cs, argv + ["--device", "cpu", "--out",
                                 str(tmp_path / "port.json")])
    jrc, theirs = _main(_jax(), argv + ["--out",
                                        str(tmp_path / "jax.json")])
    assert rc == jrc == 0
    assert sorted(ours) == sorted(theirs)
    assert sorted(ours["recovery_latency"]) == \
        sorted(theirs["recovery_latency"])
    assert ours["outcomes"] == theirs["outcomes"]
    assert ours["ok"] is True
    with open(tmp_path / "port.json") as f:
        port_art = json.load(f)
    with open(tmp_path / "jax.json") as f:
        jax_art = json.load(f)
    assert sorted(port_art) == sorted(jax_art)
    assert [sorted(r) for r in port_art["schedules"]] == \
        [sorted(r) for r in jax_art["schedules"]]
    assert [r["spec"] for r in port_art["schedules"]] == \
        [r["spec"] for r in jax_art["schedules"]]
    # Every result of the run sat on the CPU in its input's dtype.
    placed = port_art["metrics"]["counters"]["hvd_chaos_results_total"]
    assert placed and all(k.startswith("device=cpu,") and
                          k.endswith("placed=yes") for k in placed)


def _run_module(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.chaos_soak"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.chaos
def test_module_runs_on_the_host_only_when_asked():
    """``python -m`` with ``--device cpu`` prints one CHAOSJSON line and
    exits 0; without it, on a machine with no card, it exits non-zero
    naming the missing device (``CUDA_VISIBLE_DEVICES=""`` hides a card
    where there is one)."""
    out = _run_module(["--ranks", "4", "--schedules", "1", "--ops", "4",
                       "--no-ckpt-drill", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("CHAOSJSON ")]
    assert len(lines) == 1
    assert json.loads(lines[0][len("CHAOSJSON "):])["outcomes"] == \
        {"ok": 1}
    env_hide = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env_hide.pop("PYTHONPATH", None)
    env_hide["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.chaos_soak",
         "--ranks", "4", "--schedules", "1"], cwd=REPO, env=env_hide,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "CHAOSJSON" not in out.stdout


# ---------------------------------------------------------------------------
# slow mirrors of the JAX suite's full soaks
# ---------------------------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_soak_full():
    report = cs.run_soak(ranks=8, schedules=6, seed=21, n_ops=25,
                         stall_shutdown_s=2.0, device=CPU)
    assert report["ok"], report["outcomes"]
    assert report["schedules"][0]["kind"] == "baseline"
    assert any(r["outcome"] == "recovered" for r in report["schedules"])
    assert report["recovery_latency"]["count"] >= 1
    assert report["recovery_latency"]["max_s"] < 60.0
    assert report["recovery_latency"]["p50_s"] is not None
    assert report["recovery_latency"]["p50_s"] <= \
        report["recovery_latency"]["max_s"]
    assert "hvd_negotiation_rounds_total" in \
        report["metrics"]["counters"]


@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_soak_16_ranks():
    report = cs.run_soak(ranks=16, schedules=4, seed=11, n_ops=20,
                         stall_shutdown_s=2.0, device=CPU)
    assert report["ok"], report["outcomes"]


@pytest.mark.chaos
@pytest.mark.slow
def test_serve_drill_heavy():
    for seed in (0, 1, 2):
        rec = cs.run_serve_drill(ranks=6, seed=seed, steps=36,
                                 commit_every=3, device=CPU)
        assert rec["ok"], rec
        assert rec["torn_reads"] == 0
