"""Real launches by the port's launcher on the CPU, each held against the
JAX package's launcher where the JAX package can run the same thing:

* a two-rank launch whose workers take the remote-rank-0 branch of
  ``init`` (no ``HOROVOD_TPU_COORDINATOR``, ``HOROVOD_RANK0_ADDR`` set),
  with ``--network-interface`` and ``HOROVOD_METRICS_PORT``: rank 0
  publishes the endpoints, both ranks reach the same ones, an allreduce
  is exact, and each rank's /metrics answers 200 signed and 403 unsigned;
* a failed rank fails the launch and the other rank is killed within the
  grace time, through ``launch_static`` of both packages and the CLI;
* ``run(func, np=2)`` returns the ranks' results in rank order;
* a terminated worker gets its event's grace (a preempted one the
  preemption hook's), with ``psutil`` and without.

The launched training (eager ops, MLP and tiny GPT against the JAX
package) is in test_torch_port_multiproc.py, beside the JAX run it
reuses.  Every launch has a timeout of its own.
"""

import json
import os
import sys
import textwrap
import threading
import time

import pytest

from horovod_tpu.runner import tpu_run as jax_run
from horovod_tpu_torch.runner import gpu_run as port_run
from horovod_tpu_torch.runner import safe_shell_exec
from test_torch_port_multiproc import launcher_env, run_port_launcher

pytestmark = pytest.mark.multiproc

LAUNCH_TIMEOUT_S = 120


def _results(out: str):
    """The ``RESULT {...}`` lines of a launch's console output, by rank,
    with the launcher's ``[rank]<stdout>:`` prefix stripped."""
    got = {}
    for line in out.splitlines():
        _, sep, rest = line.partition("<stdout>:")
        if sep and rest.startswith("RESULT "):
            r = json.loads(rest[len("RESULT "):])
            got[r["rank"]] = r
    return got


_ENDPOINT_WORKER = """
import json, os, time, urllib.error, urllib.request
launcher_coordinator = os.environ.pop("HOROVOD_TPU_COORDINATOR")
os.environ.pop("HOROVOD_CONTROLLER_ADDR")
os.environ["HOROVOD_RANK0_ADDR"] = "127.0.0.1"
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runner import job_secret
hvd.init()
x = hvd.allreduce(torch.arange(4.0) * (hvd.rank() + 1), op=hvd.Sum, name="x")
port = basics._state().metrics_server.port

def read(signed):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics")
    if signed:
        ts = repr(time.time())
        req.add_header(job_secret.TS_HEADER, ts)
        req.add_header(job_secret.HEADER, job_secret.sign(
            os.environ[job_secret.ENV], "GET", "/metrics", b"", ts))
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""

signed, text = read(True)
unsigned, _ = read(False)
print("RESULT " + json.dumps({
    "rank": hvd.rank(), "x": x.tolist(),
    "coordinator": os.environ["HOROVOD_TPU_COORDINATOR"],
    "controller": os.environ["HOROVOD_CONTROLLER_ADDR"],
    "launcher_coordinator": launcher_coordinator,
    "signed": signed, "unsigned": unsigned,
    "gloo_series": 'hvd_collective_seconds_count{backend="gloo"' in text,
    "nics": [os.environ.get(k) for k in ("HOROVOD_GLOO_IFACE",
                                         "GLOO_SOCKET_IFNAME",
                                         "NCCL_SOCKET_IFNAME")],
    "transport": basics._state().transport}), flush=True)
hvd.shutdown()
"""


def test_remote_rank0_endpoints_and_metrics_under_the_job_secret(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_ENDPOINT_WORKER)
    rc, out = run_port_launcher(
        ["-np", "2", "-H", "localhost:2", "--network-interface", "lo",
         "--output-filename", str(tmp_path / "logs"), sys.executable,
         str(script)],
        launcher_env({"HOROVOD_METRICS_PORT": "0"}),
        timeout=LAUNCH_TIMEOUT_S)
    assert rc == 0, out[-3000:]
    res = _results(out)
    assert sorted(res) == [0, 1], out[-3000:]
    for r in res.values():
        assert r["x"] == [0.0, 3.0, 6.0, 9.0]
        # Rank 0 chose both ports; every rank reached the same ones.
        assert r["coordinator"] == res[0]["coordinator"]
        assert r["controller"] == res[0]["controller"]
        assert r["coordinator"].startswith("127.0.0.1:")
        assert r["coordinator"] != r["controller"]
        assert r["launcher_coordinator"] == res[0]["launcher_coordinator"]
        assert (r["signed"], r["unsigned"]) == (200, 403)
        assert r["gloo_series"]
        assert r["nics"] == ["lo", "lo", "lo"]
        assert r["transport"] == "gloo"
    # --output-filename keeps each rank's console lines.
    for rank in (0, 1):
        with open(tmp_path / "logs" / f"rank.{rank}" / "stdout") as f:
            assert f"[{rank}]<stdout>:RESULT " in f.read()


_FAILING = textwrap.dedent("""
    import os, sys, time
    if os.environ["HOROVOD_RANK"] == "1":
        time.sleep(0.5)
        sys.exit(1)
    print("rank 0 waits", flush=True)
    time.sleep(60)
""")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_failed_rank_fails_the_launch_and_kills_the_other(pkg, tmp_path):
    launch_static = {"port": port_run.launch_static,
                     "jax": jax_run.launch_static}[pkg]
    outcome = {}

    def launch():
        t0 = time.monotonic()
        try:
            launch_static([sys.executable, "-c", _FAILING], "localhost:2", 2,
                          env=launcher_env(),
                          output_filename=str(tmp_path / "logs"))
        except RuntimeError as e:
            outcome["error"] = str(e)
        outcome["seconds"] = time.monotonic() - t0

    t = threading.Thread(target=launch, daemon=True)
    t.start()
    t.join(timeout=LAUNCH_TIMEOUT_S)
    assert not t.is_alive()
    # Rank 1 is named first.  Rank 0's code is named too unless it reads 0:
    # in the JAX package psutil's wait in terminate_process_tree may reap
    # the killed shell before subprocess does, and subprocess then records
    # 0 (test_a_killed_rank_keeps_its_exit_code).
    assert outcome["error"].startswith(
        "Horovod run failed: non-zero exit codes {1: 1")
    # Rank 0 would sleep 60 s: it was killed within the grace time.
    assert outcome["seconds"] < safe_shell_exec.GRACEFUL_TERMINATION_TIME_S + 15
    with open(tmp_path / "logs" / "rank.0" / "stdout") as f:
        assert "rank 0 waits" in f.read()


def test_cli_exits_1_naming_the_failed_rank(tmp_path):
    script = tmp_path / "failing.py"
    script.write_text(_FAILING)
    t0 = time.monotonic()
    rc, out = run_port_launcher(
        ["-np", "2", "-H", "localhost:2", sys.executable, str(script)],
        launcher_env(), timeout=LAUNCH_TIMEOUT_S)
    assert rc == 1, out[-3000:]
    assert "horovodrun: Horovod run failed: non-zero exit codes {1: 1" in out
    assert time.monotonic() - t0 < \
        safe_shell_exec.GRACEFUL_TERMINATION_TIME_S + 20


_TRAPS_TERM = textwrap.dedent("""
    import signal, sys, time
    def on_term(signum, frame):
        time.sleep(float(sys.argv[1]))
        open(sys.argv[2], "w").write("finished")
        sys.exit(3)
    signal.signal(signal.SIGTERM,
                  signal.SIG_IGN if sys.argv[1] == "ignore" else on_term)
    print("ready", flush=True)
    time.sleep(60)
""")


def _wait_ready(path, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path) and "ready" in open(path).read():
            return
        time.sleep(0.05)
    raise AssertionError(f"{path}: the worker never got ready")


def test_preemption_grace_covers_the_hook():
    """The launcher waits for a preempted worker at least as long as the
    preemption hook may take: its grace and the 5 s its join allows."""
    from horovod_tpu_torch.checkpoint import preemption
    assert safe_shell_exec.PREEMPTION_TERMINATION_TIME_S >= \
        preemption.DEFAULT_GRACE_S + 5.0


@pytest.mark.parametrize("psutil_present", [True, False])
def test_event_grace_outlasts_the_default(psutil_present, monkeypatch,
                                          tmp_path):
    """A worker whose SIGTERM handler runs past the default grace (a final
    checkpoint commit) finishes it when its event's grace allows, with
    psutil and without."""
    if not psutil_present:
        monkeypatch.setitem(sys.modules, "psutil", None)
    script, out = tmp_path / "w.py", tmp_path / "out"
    finished = tmp_path / "finished"
    script.write_text(_TRAPS_TERM)
    handler_s = safe_shell_exec.GRACEFUL_TERMINATION_TIME_S + 1
    ev, box = threading.Event(), {}

    def run():
        with open(out, "w") as sink:
            box["rc"] = safe_shell_exec.execute(
                f"{sys.executable} {script} {handler_s} {finished}",
                stdout=sink,
                events=[ev], event_grace_s={ev: handler_s + 10})

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _wait_ready(out)
    t0 = time.monotonic()
    ev.set()
    t.join(timeout=60)
    assert not t.is_alive()
    # The shell may die of the SIGTERM at once: its code is not the
    # worker's, but execute returned only once the worker had finished.
    assert finished.read_text() == "finished"
    assert handler_s <= time.monotonic() - t0 < handler_s + 10


@pytest.mark.parametrize("handler", ["finishes", "ignores"])
def test_terminate_without_psutil_waits_for_the_group(handler, monkeypatch,
                                                      tmp_path):
    """Without psutil the process group gets SIGTERM, is waited for up to
    the grace, and what is left then gets SIGKILL."""
    import subprocess
    monkeypatch.setitem(sys.modules, "psutil", None)
    script, out = tmp_path / "w.py", tmp_path / "out"
    script.write_text(_TRAPS_TERM)
    arg, grace_s = {"finishes": ("1.0", 10.0), "ignores": ("ignore", 1.0)}[
        handler]
    with open(out, "w") as sink:
        p = subprocess.Popen([sys.executable, str(script), arg,
                              str(tmp_path / "finished")], stdout=sink,
                             start_new_session=True)
    # The parent reaps its child, as execute's proc.wait() does.
    reaper = threading.Thread(target=p.wait, daemon=True)
    reaper.start()
    try:
        _wait_ready(out)
        t0 = time.monotonic()
        safe_shell_exec.terminate_process_tree(p.pid, grace_s=grace_s)
        seconds = time.monotonic() - t0
        reaper.join(timeout=10)
    finally:
        if p.poll() is None:
            p.kill()
    if handler == "finishes":
        assert p.returncode == 3 and 1.0 <= seconds < grace_s
    else:
        assert p.returncode == -9 and seconds >= grace_s


def test_a_killed_rank_keeps_its_exit_code():
    """A rank that ``terminate_process_tree`` kills keeps its real exit
    code in the port: psutil waits on its descendants only, and the
    ``Popen`` reaps the rank. The JAX package's copy lets psutil reap it,
    and ``Popen.wait`` then reads 0."""
    import subprocess
    from horovod_tpu.runner import safe_shell_exec as ref_exec
    pytest.importorskip("psutil")
    codes = {}
    for name, mod in (("port", safe_shell_exec), ("jax", ref_exec)):
        p = subprocess.Popen("sleep 60", shell=True, start_new_session=True)
        try:
            t0 = time.monotonic()
            mod.terminate_process_tree(p.pid, grace_s=10.0)
            assert time.monotonic() - t0 < 10.0
            codes[name] = p.wait(timeout=10)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == {"port": -15, "jax": 0}


def _call_with_timeout(fn, timeout=LAUNCH_TIMEOUT_S):
    box = {}

    def target():
        box["value"] = fn()

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout=timeout)
    assert not t.is_alive() and "value" in box
    return box["value"]


def test_run_func_returns_results_in_rank_order():
    pytest.importorskip("cloudpickle")
    from horovod_tpu.runner import run as jax_run_func
    from horovod_tpu_torch.runner import run

    def identity():
        return (int(os.environ["HOROVOD_RANK"]),
                int(os.environ["HOROVOD_SIZE"]),
                int(os.environ["HOROVOD_LOCAL_RANK"]))

    def train(scale):
        import torch
        import horovod_tpu_torch.torch as hvd
        hvd.init()
        try:
            x = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)]),
                              op=hvd.Sum, name="run.x")
            return hvd.rank(), hvd.size(), x.item() * scale
        finally:
            hvd.shutdown()

    env = launcher_env()
    want = _call_with_timeout(lambda: jax_run_func(identity, np=2, env=env))
    assert want == [(0, 2, 0), (1, 2, 1)]
    got = _call_with_timeout(lambda: run(train, args=(2.0,), np=2, env=env))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert got == [(0, 2, 6.0), (1, 2, 6.0)]


def test_run_func_without_cloudpickle_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    with pytest.raises(ImportError, match="cloudpickle"):
        port_run.run_func(lambda: 0, "localhost:1", 1)
