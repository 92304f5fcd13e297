"""The port's operator tools (``horovod_tpu_torch/tools/``) held against
the JAX package's ``tools/`` scripts on the same inputs, on the CPU:

* ``validate_trace``: the same errors on the same events, valid and
  malformed, the port's timeline and its device trace among them (the
  device trace is Chrome's object form, which the port reads as its
  ``traceEvents``; torch.profiler's own export breaks the metadata rule,
  the port's ``stop_xla_trace`` output does not);
* ``blackbox_merge``: the same merged trace and verdict from seeded dumps
  and from the dumps the port's workers write after a real kill;
* ``tune_report``, ``hvdtop`` and ``flame``: the same output, files and
  exit codes;
* ``measure_torch_staging``, ``measure_elastic`` and ``profile_resnet``
  with ``--device cpu`` at small sizes: the JAX tools' keys, exact sums,
  the post-resize world size and the analytic FLOPs; without a card and
  without ``--device cpu`` each exits 1 naming the missing device.

Their twins on the card are in test_torch_port_cuda.py.  Every process a
test starts has a timeout.
"""

import contextlib
import importlib.util
import io
import json
import os
import random
import re
import subprocess
import sys

import pytest
import torch

from horovod_tpu_torch.common import metrics
from horovod_tpu_torch.tools import (blackbox_merge, flame, hvdtop,
                                     measure_elastic, measure_torch_staging,
                                     profile_resnet, tune_report,
                                     validate_trace)
from horovod_tpu_torch.tune import profile as pprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL_TIMEOUT_S = 120


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py``, under a name of its own
    (other test files import the same files by their plain names)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = {name: _jax_tool(name) for name in (
    "validate_trace", "blackbox_merge", "tune_report", "hvdtop", "flame",
    "measure_torch_staging", "measure_elastic")}


def _main(mod, argv):
    """``mod.main(argv)`` -> (exit code, stdout, stderr); argparse's
    usage errors exit through SystemExit."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _run_tool(name, *args, env=None):
    """``python -m horovod_tpu_torch.tools.<name> *args`` -> (exit code,
    stdout, stderr)."""
    p = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.tools.{name}", *args],
        cwd=REPO, env=dict(os.environ, **(env or {})), capture_output=True,
        text=True, timeout=TOOL_TIMEOUT_S)
    return p.returncode, p.stdout, p.stderr


def _last_json(out: str) -> dict:
    start = out.rfind("\n{\n")
    return json.loads(out[start + 1:] if start >= 0 else out)


def _keys(d) -> object:
    """The key structure of a JSON value: dicts by their keys, lists by
    their first element."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_keys(d[0])] if d else []
    return None


# ---------------------------------------------------------------------------
# validate_trace
# ---------------------------------------------------------------------------

_EVENT_CASES = {
    "ok": [
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 1,
         "args": {"name": "t"}},
        {"ph": "B", "name": "NEGOTIATE_ALLREDUCE", "pid": 0, "tid": 1,
         "ts": 1.0},
        {"ph": "E", "pid": 0, "tid": 1, "ts": 2.0},
        {"ph": "C", "name": "queue_depth", "pid": 0, "tid": 0, "ts": 2.5,
         "args": {"pending": 3}},
        {"ph": "X", "name": "kernel", "pid": 0, "tid": 7, "ts": 3.0,
         "dur": 1.0}],
    "unbalanced": [{"ph": "B", "name": "x", "pid": 0, "tid": 1, "ts": 1.0}],
    "e_without_b": [{"ph": "E", "pid": 0, "tid": 1, "ts": 1.0}],
    "backwards_ts": [
        {"ph": "B", "name": "x", "pid": 0, "tid": 1, "ts": 5.0},
        {"ph": "E", "pid": 0, "tid": 1, "ts": 2.0}],
    "negative_ts": [{"ph": "B", "name": "x", "pid": 0, "tid": 1, "ts": -1.0},
                    {"ph": "E", "pid": 0, "tid": 1, "ts": 1.0}],
    "bool_ts": [{"ph": "i", "name": "x", "pid": 0, "tid": 1, "ts": True}],
    "b_without_name": [{"ph": "B", "pid": 0, "tid": 1, "ts": 1.0},
                       {"ph": "E", "pid": 0, "tid": 1, "ts": 2.0}],
    "unnamed_metadata": [{"ph": "M", "name": "process_sort_index",
                          "pid": 0, "args": {"sort_index": 3}}],
    "counter_not_numeric": [{"ph": "C", "name": "q", "pid": 0, "ts": 1.0,
                             "args": {"pending": "3"}}],
    "unknown_phase": [{"ph": "Z", "pid": 0, "ts": 1.0}],
    "no_phase": [{"name": "x", "ts": 1.0}, 7],
    "not_a_list": {"ph": "B"},
    "merged_cross_rank": [
        {"ph": "B", "name": "x", "pid": 0, "tid": 1, "ts": 1.0},
        {"ph": "E", "pid": 1, "tid": 1, "ts": 2.0}],
    "merged_backwards_instant": [
        {"ph": "i", "name": "a", "pid": 0, "tid": 1, "ts": 5.0, "s": "t"},
        {"ph": "i", "name": "b", "pid": 0, "tid": 1, "ts": 4.0, "s": "t"},
        {"ph": "i", "name": "c", "pid": 1, "tid": 1, "ts": 1.0, "s": "t"}],
    "merged_one_pid": [
        {"ph": "i", "name": "a", "pid": 0, "tid": 1, "ts": 1.0, "s": "t"}],
}


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("case", sorted(_EVENT_CASES))
def test_validate_trace_gives_the_jax_errors(case, merged, tmp_path):
    events = _EVENT_CASES[case]
    want = JAX["validate_trace"].validate_events(events, merged=merged)
    assert validate_trace.validate_events(events, merged=merged) == want
    path = tmp_path / "t.json"
    path.write_text(json.dumps(events))
    assert validate_trace.validate_file(str(path), merged=merged) == \
        JAX["validate_trace"].validate_file(str(path), merged=merged)
    argv = (["--merged"] if merged else []) + [str(path)]
    assert _main(validate_trace, argv)[:2] == \
        _main(JAX["validate_trace"], argv)[:2]
    if case == "ok" and not merged:
        assert want == []
    elif case != "ok":
        assert want != [] or (case.startswith("merged") and not merged)


def test_validate_trace_reads_the_port_timeline(tmp_path):
    import horovod_tpu_torch.torch as hvd
    path = tmp_path / "timeline.json"
    hvd.init()
    try:
        hvd.start_timeline(str(path))
        for i in range(3):
            hvd.allreduce(torch.ones(3), name=f"tools.tl.{i}", op=hvd.Sum)
        hvd.broadcast(torch.ones(2), 0, name="tools.tl.b")
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    assert validate_trace.validate_file(str(path)) == []
    assert JAX["validate_trace"].validate_file(str(path)) == []
    assert _main(validate_trace, [str(path)])[0] == 0


def test_validate_trace_reads_the_port_device_trace(tmp_path):
    """``stop_xla_trace`` writes Chrome's object form; the port reads its
    events, which pass the JAX rules.  torch.profiler's own export has
    metadata without ``args.name`` (``*_sort_index``, ``process_labels``),
    which the JAX rules refuse and the port's writer drops."""
    from torch.profiler import ProfilerActivity, profile
    from horovod_tpu_torch.common import timeline
    model = torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(2, 3, 8, 8)
    timeline.start_xla_trace(str(tmp_path / "port"))
    try:
        model(x).sum().backward()
    finally:
        path = timeline.stop_xla_trace()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert validate_trace.validate_file(path) == []
    assert JAX["validate_trace"].validate_events(events) == []
    assert JAX["validate_trace"].validate_file(path) == [
        "top-level JSON must be an array of trace events"]
    assert _main(validate_trace, [path])[0] == 0

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x).sum().backward()
    raw = str(tmp_path / "raw.json")
    prof.export_chrome_trace(raw)
    errors = validate_trace.validate_file(raw)
    assert errors and all(e.endswith("metadata without args.name")
                          for e in errors), errors
    with open(raw) as f:
        assert JAX["validate_trace"].validate_events(
            json.load(f)["traceEvents"]) == errors


# ---------------------------------------------------------------------------
# blackbox_merge
# ---------------------------------------------------------------------------

def _seeded_dumps(seed: int) -> list:
    """A coordinator (rank 0) and workers 1 and 2 on clocks skewed by up to
    50 ms, exchanging HBs with jittered delays; rank 2 goes silent, is
    parked and promoted, rank 1 unwinds, restores a checkpoint and
    resumes, the driver evicts rank 2 and plans the next epoch.  Rank 1
    writes two dumps whose rings overlap."""
    rng = random.Random(seed)
    base = 1_700_000_000.0 + rng.random() * 1e3
    skew = {0: 0.0, 1: rng.uniform(-0.05, 0.05), 2: rng.uniform(-0.05, 0.05)}
    ev = {0: [], 1: [], 2: []}

    def add(rank, t, kind, **f):
        ev[rank].append(dict(f, mono=t - base + 100.0 * rank,
                             wall=t + skew[rank], kind=kind, rank=rank))

    beats = 12 + rng.randrange(6)
    for i in range(beats):
        t = base + i * 0.3
        add(0, t, "frame_tx", role="coord", frame="HB", nbytes=0)
        for r in (1, 2):
            if r == 2 and i >= beats - 3:
                continue
            d = rng.uniform(0.0005, 0.003)
            add(r, t + d, "hb_rx", role="worker")
            up = t + 0.15 + rng.uniform(0, 0.01)
            add(r, up, "frame_tx", role="worker", frame="HB", nbytes=6)
            add(0, up + rng.uniform(0.0005, 0.003), "hb_rx", role="coord",
                peer=r)
            add(r, t + 0.05, "submit", name="grad.%d" % i, type="ALLREDUCE")
    t_fault = base + (beats - 3) * 0.3 + 0.2
    add(2, t_fault - 0.01, "note", note="drill.fault", victim=2)
    add(0, t_fault + 0.6, "limbo", role="coord", peer=2, grace_s=0.6)
    add(0, t_fault + 1.2, "promote", role="coord", peer=2, clean=False,
        reason="grace expired")
    add(0, t_fault + 1.21, "elastic", event="evict", victim=2)
    add(1, t_fault + 1.25, "fatal", role="worker", error="peer lost")
    add(1, t_fault + 1.6, "ckpt", phase="restore", step=7)
    add(0, t_fault + 1.9, "elastic", event="epoch_plan", trigger="death",
        epoch=2)
    add(1, t_fault + 2.2, "note", note="drill.resumed")
    dumps = []
    for rank, events in ev.items():
        events.sort(key=lambda e: e["mono"])
        dumps.append((rank, "promotion", events))
    cut = len(ev[1]) // 2
    dumps.append((1, "drill.end", ev[1][cut - 5:]))
    dumps[1] = (1, "fatal", ev[1][:cut])
    return [{"version": 1, "reason": reason, "rank": rank, "pid": 1000 + rank,
             "mono_at_dump": events[-1]["mono"],
             "wall_at_dump": events[-1]["wall"] + i * 1e-3,
             "events": events} for i, (rank, reason, events) in
            enumerate(dumps)]


def _write_dumps(directory, dumps):
    os.makedirs(directory, exist_ok=True)
    for i, d in enumerate(dumps):
        with open(os.path.join(directory, "blackbox-rank%s-%s-%d.json"
                               % (d["rank"], d["reason"], i)), "w") as f:
            json.dump(d, f)


def _both_merges(path) -> tuple:
    """(trace, verdict) of each package's merge of ``path``, JSON-normal
    (tuples become lists as in the written files)."""
    got = [json.loads(json.dumps(mod.merge(path)))
           for mod in (blackbox_merge, JAX["blackbox_merge"])]
    return got[0], got[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blackbox_merge_gives_the_jax_trace_and_verdict(seed, tmp_path):
    _write_dumps(str(tmp_path), _seeded_dumps(seed))
    port, ref = _both_merges(str(tmp_path))
    assert port == ref
    trace, verdict = port
    assert verdict["failed_rank"] == 2 and verdict["resize_trigger"] == \
        "death"
    assert set(verdict["spans"]) == {"detect", "promote", "restore",
                                     "resume", "total"}
    assert verdict["spans"]["total"] > 0
    assert validate_trace.validate_events(trace, merged=True) == []
    for mod in (blackbox_merge, JAX["blackbox_merge"]):
        out = tmp_path / ("%s.json" % mod.__name__)
        rc, stdout, _ = _main(mod, [str(tmp_path), "-o", str(out)])
        assert rc == 0 and json.loads(stdout)["failed_rank"] == 2
        assert json.loads(out.read_text()) == trace


def test_blackbox_merge_exit_codes_are_the_jax_ones(tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "blackbox-rank0-x-1.json").write_text("{not json")
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "blackbox-rank0-x-1.json").write_text(json.dumps(
        {"events": [{"kind": "note"}]}))
    empty = tmp_path / "empty"
    empty.mkdir()
    for path, want in ((bad, 2), (foreign, 2), (empty, 2),
                       (tmp_path / "missing", 2)):
        port = _main(blackbox_merge, [str(path)])
        ref = _main(JAX["blackbox_merge"], [str(path)])
        assert port[0] == ref[0] == want
        assert port[2] == ref[2]


# ---------------------------------------------------------------------------
# tune_report
# ---------------------------------------------------------------------------

def _profile(fusion_mb, cycle_ms, score, world=2):
    return pprof.TunedProfile(
        world_size=world, strategy="coordinate", frozen_at_unix=1.7e9,
        classes={"dense": {"knobs": {"fusion_mb": fusion_mb,
                                     "cycle_time_ms": cycle_ms},
                           "score_bytes_per_s": score, "samples": 12,
                           "rounds": 3},
                 "sparse": {"knobs": {"fusion_mb": 8.0},
                            "score_bytes_per_s": 900.0, "samples": 4,
                            "rounds": 1}},
        worker={"cycle_time_ms": cycle_ms, "coalesce": True})


@pytest.mark.parametrize("argv,rc", [
    (["A"], 0), (["--json", "A"], 0), (["--diff", "A", "B"], 0),
    (["--diff", "--json", "A", "B"], 0), (["--diff", "A", "EMPTY"], 0),
    (["MISSING"], 2), (["JUNK"], 2), (["--diff", "A"], 2), (["A", "B"], 2)])
def test_tune_report_prints_what_the_jax_tool_prints(argv, rc, tmp_path):
    """Plain, ``--json`` and ``--diff`` print the same bytes; an
    unreadable profile exits 2 in both, and so does a usage error
    (argparse's code)."""
    paths = {"A": str(tmp_path / "a.json"), "B": str(tmp_path / "b.json"),
             "EMPTY": str(tmp_path / "empty.json"),
             "MISSING": str(tmp_path / "missing.json"),
             "JUNK": str(tmp_path / "junk.json")}
    pprof.save_profile(_profile(32.0, 1.0, 3e6), paths["A"])
    pprof.save_profile(_profile(64.0, 2.5, 1.5e6, world=4), paths["B"])
    pprof.save_profile(pprof.TunedProfile(world_size=2), paths["EMPTY"])
    (tmp_path / "junk.json").write_text('{"kind": "other"}')
    argv = [paths.get(a, a) for a in argv]
    port = _main(tune_report, argv)
    assert port[:2] == _main(JAX["tune_report"], argv)[:2]
    assert port[0] == rc and (rc != 0 or port[1].strip())


# ---------------------------------------------------------------------------
# hvdtop
# ---------------------------------------------------------------------------

def _status(with_cluster: bool, profile: bool = False) -> dict:
    status = {"rank": 0, "size": 3, "replay": {"enabled": True,
                                                "cycles_replayed": 12},
              "tune": {"phase": "frozen"}, "queue_depth": 2,
              "ops_dispatched": 340,
              "phases": {"negotiate": 0.0021, "execute": 0.0104}}
    if with_cluster:
        status["cluster"] = {
            "size": 3, "formed": True, "broken": False,
            "pending_tensors": 1,
            "straggler": {"threshold": 4.0, "flagged": [2]},
            "ranks": {"0": {"state": "alive", "score": 0.1,
                            "last_heard_age_s": 0.2},
                      "1": {"state": "limbo", "score": 1.5,
                            "via_relay": 0},
                      "2": {"state": "alive", "score": 6.0, "slow": True,
                            "hot_frame": "runtime:_run_once [cycle]",
                            "last_heard_age_s": 1.25}},
            "profile": {"2": [{"lane": "cycle", "frame": "runtime:_run_once",
                               "share": 0.7}]} if profile else {}}
    return status


@pytest.mark.parametrize("with_cluster,profile", [
    (False, False), (True, False), (True, True)])
def test_hvdtop_renders_the_jax_frame(with_cluster, profile):
    status = _status(with_cluster, profile)
    assert hvdtop.render(status, now=1.7e9, show_profile=profile) == \
        JAX["hvdtop"].render(status, now=1.7e9, show_profile=profile)


def test_hvdtop_once_against_a_live_status(tmp_path):
    """Both tools fetch the same ``/status`` from the port's metrics
    server under a job secret: the same frame (its clock masked) signed,
    the same refusal (exit 2) unsigned."""
    status = _status(True, True)
    srv = metrics.serve(port=0, registry=metrics.MetricsRegistry(),
                        secret="s3cret", status_provider=lambda: status)
    url = "http://127.0.0.1:%d" % srv.port
    try:
        got = {}
        for name, mod in (("port", hvdtop), ("jax", JAX["hvdtop"])):
            got[name] = (
                _main(mod, ["--once", "--profile", "--url", url, "--secret",
                            "s3cret"]),
                _main(mod, ["--once", "--url", url, "--secret", ""]))
    finally:
        srv.stop()
    clock = re.compile(r"\d\d:\d\d:\d\d")
    (p_signed, p_unsigned), (j_signed, j_unsigned) = got["port"], got["jax"]
    assert p_signed[0] == j_signed[0] == 0
    assert clock.sub("T", p_signed[1]) == clock.sub("T", j_signed[1])
    assert "profile digest" in p_signed[1] and "SLOW" in p_signed[1]
    assert p_unsigned[0] == j_unsigned[0] == 2
    assert "403" in p_unsigned[2] and p_unsigned[2] == j_unsigned[2]


# ---------------------------------------------------------------------------
# flame
# ---------------------------------------------------------------------------

def _payload(rank, stacks):
    return {"enabled": True, "rank": rank,
            "thread_samples": sum(n for n in stacks.values()
                                  if isinstance(n, int)),
            "collapsed": stacks}


_PAYLOADS = [
    _payload(0, {"MainThread;train:step;runtime:_run_once": 40,
                 "MainThread;train:step;ops:allreduce": 17,
                 "hvd-bg;runtime:_loop;controller:compute_response_list": 9,
                 "MainThread;<idle>": 0}),
    _payload(1, {"MainThread;train:step;runtime:_run_once": 22,
                 "MainThread;train:step;failpoints:maybe_fail": 61,
                 "hvd-bg;runtime:_loop": "x"}),
    {"enabled": True, "thread_samples": 3,
     "collapsed": {"MainThread;a<b>&\"c\"": 3}},
]


def test_flame_writes_the_jax_files(tmp_path):
    inputs = []
    for i, p in enumerate(_PAYLOADS):
        path = tmp_path / ("prof-%d.json" % i)
        path.write_text(json.dumps(p))
        inputs.append(str(path))
    got = {}
    for name, mod in (("port", flame), ("jax", JAX["flame"])):
        out, svg = tmp_path / (name + ".collapsed"), tmp_path / (name + ".svg")
        rc, stdout, _ = _main(mod, inputs + ["-o", str(out), "--svg",
                                             str(svg), "--width", "900"])
        got[name] = (rc, stdout.replace(name + ".", "X."), out.read_text(),
                     svg.read_text())
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0
    assert "rank 1;MainThread;train:step;failpoints:maybe_fail 61" in \
        got["port"][2]


def test_flame_fetches_the_live_profiles(tmp_path):
    """Signed fetches of two ranks' ``/profile`` from the port's metrics
    servers give both tools the same collapsed file."""
    servers = [metrics.serve(port=0, registry=metrics.MetricsRegistry(),
                             secret="s3cret",
                             profile_provider=lambda p=p: p)
               for p in _PAYLOADS[:2]]
    urls = ["http://127.0.0.1:%d" % s.port for s in servers]
    try:
        got = {}
        for name, mod in (("port", flame), ("jax", JAX["flame"])):
            out = tmp_path / (name + ".collapsed")
            rc, _, _ = _main(mod, urls + ["-o", str(out), "--secret",
                                          "s3cret"])
            got[name] = (rc, out.read_text())
    finally:
        for s in servers:
            s.stop()
    assert got["port"] == got["jax"] and got["port"][0] == 0
    assert {line.split(";")[0] for line in got["port"][1].splitlines()} == \
        {"rank 0", "rank 1"}


@pytest.mark.parametrize("case", ["missing", "junk", "not_a_dict",
                                  "no_samples", "bad_url"])
def test_flame_exit_codes_are_the_jax_ones(case, tmp_path):
    path = str(tmp_path / "p.json")
    if case == "junk":
        open(path, "w").write("{nope")
    elif case == "not_a_dict":
        open(path, "w").write(json.dumps({"collapsed": [1, 2]}))
    elif case == "no_samples":
        open(path, "w").write(json.dumps(_payload(0, {"a;b": 0})))
    elif case == "bad_url":
        path = "http://127.0.0.1:9/profile"
    port = _main(flame, [path])
    ref = _main(JAX["flame"], [path])
    assert port[0] == ref[0] == 2
    assert port[2] == ref[2]


# ---------------------------------------------------------------------------
# the job-driving tools, on the CPU
# ---------------------------------------------------------------------------

def test_staging_on_the_cpu_has_the_jax_keys_and_exact_sums(monkeypatch,
                                                               capsys):
    sizes = ["0.25", "1"]
    rc, out, err = _run_tool("measure_torch_staging", "--device", "cpu",
                             "--sizes", *sizes)
    assert rc == 0, err + out[-3000:]
    port = json.loads(out)
    # The JAX tool at the same sizes (its own are fixed at 1/16/64).
    real_popen = subprocess.Popen

    def popen(*args, **kw):
        kw["env"] = dict(kw["env"], BENCH_SIZES_MB=json.dumps(
            [json.loads(s) for s in sizes]))
        return real_popen(*args, **kw)

    monkeypatch.setattr(subprocess, "Popen", popen)
    JAX["measure_torch_staging"].main()
    monkeypatch.undo()
    ref = json.loads(capsys.readouterr().out)
    assert "error" not in ref, ref
    assert set(ref) <= set(port)
    for lane in ("allreduce", "conversion_only"):
        assert set(ref[lane][0]) <= set(port[lane][0])
        assert [(r["size_mb"], r.get("input")) for r in port[lane]] == \
            [(r["size_mb"], r.get("input")) for r in ref[lane]]
    assert _keys(port["paired"]) == _keys(ref["paired"])
    assert port["exact"] is True and port["results_checked"] >= 2 * 2 * 2 * 8
    assert {r["backend"] for r in port["allreduce"]} == {"gloo"}
    assert port["fusion_launches"] == {"pack": 0, "unpack": 0}


def test_elastic_on_the_cpu_has_the_jax_keys_and_merges_its_dumps(
        monkeypatch, capsys, tmp_path):
    """``measure_elastic --paths torch --device cpu`` with the flight
    recorder armed as the real-kill test arms it: the world shrinks to 2,
    the output has the JAX tool's keys (its aggregation run over this
    sample), and both packages merge the dumps into the same trace and
    verdict, which names the dead rank."""
    bb = str(tmp_path / "bb")
    rc, out, err = _run_tool(
        "measure_elastic", "--paths", "torch", "--runs", "1", "--device",
        "cpu", env={"HOROVOD_BLACKBOX_DIR": bb,
                    "HOROVOD_BLACKBOX_EVENTS": "4096",
                    "HOROVOD_LIVENESS_INTERVAL": "0.3",
                    "HOROVOD_RECONNECT_GRACE": "0.6",
                    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "4"})
    assert rc == 0, err[-3000:]
    port = _last_json(out)
    sample = port["torch_reinit"]["samples"][0]
    assert "error" not in sample, sample
    assert sample["post_resize_size"] == 2
    assert 0 < sample["death_to_first_post_resize_step_s"] < 60

    jax_tool = JAX["measure_elastic"]
    monkeypatch.setattr(jax_tool, "run_scenario",
                        lambda *a: dict(sample))
    monkeypatch.setattr(sys, "argv", ["measure_elastic.py", "--paths",
                                      "jax", "--runs", "1"])
    jax_tool.main()
    ref = json.loads(capsys.readouterr().out)
    assert set(ref) - {"jax_reinit"} <= set(port) - {"torch_reinit"}
    assert _keys(ref["jax_reinit"]) == _keys(port["torch_reinit"])

    names = sorted(os.listdir(bb))
    assert any("promotion" in n for n in names), names
    assert any("drill.fault" in n for n in names), names
    port, ref = _both_merges(bb)
    assert port == ref
    merged, v = port
    assert v["failed_rank"] == 2, v
    assert v["spans"]["total"] > 0 and v["spans"]["resume"] > 0, v
    assert validate_trace.validate_events(merged, merged=True) == []


def test_elastic_tf_context_reset_on_the_cpu():
    """The ``tf_context_reset`` scenario on the port's TensorFlow binding
    (``HOROVOD_TF_ELASTIC_GRAPH=1``), where TensorFlow is installed."""
    pytest.importorskip("tensorflow")
    rc, out, err = _run_tool("measure_elastic", "--paths", "tf", "--runs",
                             "1", "--device", "cpu")
    assert rc == 0, err[-3000:]
    agg = _last_json(out)["tf_context_reset"]
    sample = agg["samples"][0]
    assert "error" not in sample, sample
    assert sample["post_resize_size"] == 2
    assert agg["death_to_first_post_resize_step_s_median"] == \
        sample["death_to_first_post_resize_step_s"]


def test_profile_resnet_on_the_cpu_has_the_jax_keys():
    args = ["--batch-size", "2", "--image-size", "32", "--iters", "1",
            "--warmup", "1"]
    rc, out, err = _run_tool("profile_resnet", "--device", "cpu", *args)
    assert rc == 0, err[-3000:]
    port = _last_json(out)
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "profile_resnet.py"),
         "--cpu", *args], cwd=REPO, capture_output=True, text=True,
        timeout=TOOL_TIMEOUT_S, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    ref = _last_json(p.stdout)
    # XLA's HLO histogram has the device trace's kernel histogram in
    # its place (under --trace).
    hlo = {k for k in ref if k.startswith("hlo_")}
    assert hlo and set(ref) - hlo <= set(port)
    assert port["flops_per_step"] == 3 * 4.1e9 * 2
    assert port["flops_source"] == "analytic"
    assert port["bytes_accessed_per_step"] is None
    assert port["peak_bf16_tflops"] is None and port["mfu"] is None
    assert port["step_ms"] > 0 and port["images_per_sec"] > 0


def test_profile_resnet_reads_its_trace(tmp_path):
    """``--trace`` on the CPU: a device trace that validates and, with no
    card, no device kernels."""
    rc, out, err = _run_tool(
        "profile_resnet", "--device", "cpu", "--batch-size", "1",
        "--image-size", "32", "--iters", "1", "--warmup", "1", "--trace",
        str(tmp_path))
    assert rc == 0, err[-3000:]
    rep = _last_json(out)
    assert os.path.dirname(rep["trace_path"]) == str(tmp_path)
    assert validate_trace.validate_file(rep["trace_path"]) == []
    assert rep["trace_steps"] == profile_resnet.TRACE_STEPS
    assert rep["kernel_histogram"] == {} and rep["top_kernels"] == []


def test_kernel_categories_and_peak_table():
    cat = profile_resnet.category
    assert cat("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc"
               "_nhwc_tilesize128x128x64") == "convolution"
    assert cat("sm80_xmma_wgrad_implicit_gemm_indexed_bf16") == "convolution"
    assert cat("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>") == \
        "copy/transpose"
    assert cat("void at::native::elementwise_kernel<128, 4, "
               "direct_copy_kernel_cuda>") == "copy/transpose"
    assert cat("void at::native::reduce_kernel<512, 1>") == "reduction"
    assert cat("void at::native::vectorized_elementwise_kernel<4, "
               "MulFunctor>") == "elementwise"
    assert cat("void at::native::multi_tensor_apply_kernel<SGD>") == \
        "optimizer"
    assert cat("nvjet_tst_128x64_64x4_1x2_h_bz_TNT") == "matmul"
    assert profile_resnet.peak_of("NVIDIA H100 80GB HBM3") == {
        "peak_bf16_tflops": 989.4, "hbm_gbps": 3350.0,
        "source": profile_resnet.PEAKS[0][1]["source"]}
    assert profile_resnet.peak_of("NVIDIA A100-SXM4-80GB") is None
    assert profile_resnet.resnet50_analytic_flops(128) == 3 * 4.1e9 * 128


@pytest.mark.parametrize("tool", [measure_torch_staging, measure_elastic,
                                  profile_resnet])
def test_job_tools_without_a_card_exit_1_naming_it(tool, monkeypatch):
    """No CPU fallback: without ``--device cpu`` and without a card each
    exits 1 and says that no CUDA device is available."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _main(tool, ["--paths", "torch"] if tool is
                         measure_elastic else [])
    assert rc == 1 and out == ""
    assert "no CUDA device is available" in err
