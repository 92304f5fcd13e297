"""The port's launcher modules in one process, held against the JAX
package's on the same inputs: slot plans and the worker env contract,
the CLI's flags and their env, the rendezvous KV wire both ways with
and without a job secret, the rank-0 endpoints protocol, the /metrics
endpoint's status codes, and ``--check-build``.  Launches of real
worker processes are in test_torch_port_launch.py."""

import dataclasses
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import pytest

from horovod_tpu.common import metrics as jax_metrics
from horovod_tpu.runner import config_parser as jax_config
from horovod_tpu.runner import endpoints as jax_endpoints
from horovod_tpu.runner import hosts as jax_hosts
from horovod_tpu.runner import http_server as jax_http
from horovod_tpu.runner import job_secret as jax_secret
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner import tpu_run as jax_run
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.common import metrics as port_metrics
from horovod_tpu_torch.runner import config_parser as port_config
from horovod_tpu_torch.runner import endpoints as port_endpoints
from horovod_tpu_torch.runner import gpu_run as port_run
from horovod_tpu_torch.runner import hosts as port_hosts
from horovod_tpu_torch.runner import http_server as port_http
from horovod_tpu_torch.runner import job_secret as port_secret
from horovod_tpu_torch.runner import launch as port_launch

HTTP = {"jax": jax_http, "port": port_http}


def _outcome(fn, *args):
    """(result, None) or (None, (exception type, message))."""
    try:
        return fn(*args), None
    except ValueError as e:
        return None, (type(e), str(e))


# ---------------------------------------------------------------------------
# slot plans and the env contract
# ---------------------------------------------------------------------------
_PLANS = [
    ("localhost:2", 2, 2),
    ("localhost:1", 1, 1),
    ("a:2,b:2", 4, 4),
    ("a:4,b:4", 2, 3),
    ("a:4,b:2", 6, 6),
    ("node-1.cluster:8,node-2.cluster:8", 16, 16),
    ("a:1,b:1,c:1", 3, None),
    ("a:2", 4, 4),              # more processes than slots
    ("a:2,b:1", 5, None),
]


@pytest.mark.parametrize("hosts,min_np,max_np", _PLANS)
def test_slot_plan_and_env_match_jax(hosts, min_np, max_np):
    got, got_err = _outcome(
        lambda: port_hosts.get_host_assignments(
            port_hosts.parse_hosts(hosts), min_np, max_np))
    want, want_err = _outcome(
        lambda: jax_hosts.get_host_assignments(
            jax_hosts.parse_hosts(hosts), min_np, max_np))
    assert got_err == want_err
    if want_err:
        assert "available slots" in want_err[1]
        return
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert [port_hosts.slot_env_vars(s) for s in got] == \
        [jax_hosts.slot_env_vars(s) for s in want]
    assert [s.to_response_string() for s in got] == \
        [s.to_response_string() for s in want]


@pytest.mark.parametrize("hosts", ["worker-0", "worker 0:2", "a:2,,b:2",
                                   "a:x"])
def test_invalid_host_strings_raise_as_in_jax(hosts):
    got = _outcome(port_hosts.parse_hosts, hosts)[1]
    want = _outcome(jax_hosts.parse_hosts, hosts)[1]
    assert want is not None and got == want


def test_hostfile_matches_jax(tmp_path):
    f = tmp_path / "hostfile"
    f.write_text("# comment\nhost-a slots=4\n\nhost-b slots=2\nhost-c\n")
    assert port_hosts.parse_host_files(str(f)) == \
        jax_hosts.parse_host_files(str(f)) == "host-a:4,host-b:2,host-c:1"


# ---------------------------------------------------------------------------
# the CLI: the same flags give the same args and the same worker env
# ---------------------------------------------------------------------------
_ARGVS = [
    ["-np", "4", "-H", "h1:2,h2:2", "python", "train.py"],
    ["-np", "2", "--fusion-threshold-mb", "32", "--cycle-time-ms", "2.5",
     "--autotune", "--timeline-filename", "/tmp/tl.json", "x"],
    ["-np", "2", "--min-np", "2", "--max-np", "4",
     "--host-discovery-script", "./d.sh", "x"],
    ["-np", "2", "--fusion-threshold-mb", "32", "--no-stall-check", "x"],
    ["-np", "2", "--cache-capacity", "64", "--hierarchical-allreduce",
     "--no-hierarchical-allgather", "--timeline-mark-cycles",
     "--stall-check-warning-time-seconds", "9",
     "--stall-check-shutdown-time-seconds", "20", "--log-level", "DEBUG",
     "--log-hide-timestamp", "x"],
    ["-np", "2", "--tune", "--tune-profile", "p.json", "--tune-strategy",
     "grid", "--tune-max-samples", "7", "x"],
    ["-np", "3", "--hostfile", "hf", "--start-timeout", "30",
     "--network-interface", "eth0,eth1", "--output-filename", "out",
     "--verbose", "-p", "2222", "-i", "key", "--", "python", "t.py", "-a"],
    ["-np", "2", "--gloo", "--disable-cache", "x"],
    ["-np", "2", "--tpu-pod", "x"],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=range(len(_ARGVS)))
def test_parse_args_and_env_match_jax(argv):
    got, want = port_launch.parse_args(argv), jax_launch.parse_args(argv)
    assert vars(got) == vars(want)
    assert port_config.env_from_args(got) == jax_config.env_from_args(want)


def test_config_file_then_cli_override_match_jax(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent("""
        params:
          fusion_threshold_mb: 16
          cycle_time_ms: 3.0
        autotune:
          enabled: true
        stall_check:
          disabled: true
        """))
    argv = ["-np", "2", "--config-file", str(cfg), "--cycle-time-ms", "7.0",
            "x"]
    got, want = port_launch.parse_args(argv), jax_launch.parse_args(argv)
    assert vars(got) == vars(want)
    assert got.cycle_time_ms == 7.0 and got.fusion_threshold_mb == 16
    assert port_config.env_from_args(got) == jax_config.env_from_args(want)


def _static_call(launch_mod, run_mod, argv, monkeypatch):
    """The keyword arguments ``_run`` hands to ``launch_static``."""
    calls = []
    monkeypatch.setattr(run_mod, "launch_static",
                        lambda *a, **kw: calls.append((a, kw)) or {0: 0})
    launch_mod._run(launch_mod.parse_args(argv))
    (args, kwargs), = calls
    return args, kwargs


@pytest.mark.parametrize("nics", ["eth0", "eth0,ib0"])
def test_network_interface_binds_both_planes(monkeypatch, nics):
    argv = ["-np", "2", "-H", "localhost:2", "--network-interface", nics,
            "--fusion-threshold-mb", "8", "--start-timeout", "45", "python",
            "t.py"]
    got_args, got = _static_call(port_launch, port_run, argv, monkeypatch)
    want_args, want = _static_call(jax_launch, jax_run, argv, monkeypatch)
    assert got_args == want_args
    extra = got.pop("extra_worker_env")
    want_extra = want.pop("extra_worker_env")
    assert got == want
    # The JAX package's env, plus the two variables torch.distributed's
    # gloo and NCCL read.
    names = nics.split(",")
    assert extra == {**want_extra, "GLOO_SOCKET_IFNAME": names[0],
                     "NCCL_SOCKET_IFNAME": ",".join(names)}
    assert extra["HOROVOD_GLOO_IFACE"] == nics


def test_tpu_pod_and_elastic_are_refused(monkeypatch):
    with pytest.raises(ValueError, match="no TPU pod metadata on a GPU"):
        port_launch._run(port_launch.parse_args(["-np", "2", "--tpu-pod",
                                                 "x"]))
    # Elastic runs are ported: --host-discovery-script reaches
    # launch_elastic (tests/test_torch_port_elastic.py holds its
    # arguments against the JAX launcher's); only a missing -np or
    # --min-np is refused, as in the JAX package.
    import horovod_tpu_torch.runner.elastic_run as port_er
    seen = []
    monkeypatch.setattr(port_er, "launch_elastic",
                        lambda command, **kw: seen.append(kw) or {})
    port_launch._run(port_launch.parse_args(
        ["-np", "2", "--host-discovery-script", "./d.sh", "x"]))
    assert seen and seen[0]["min_np"] == 2
    with pytest.raises(ValueError, match="-np"):
        port_launch._run(port_launch.parse_args(
            ["--host-discovery-script", "./d.sh", "x"]))
    with pytest.raises(ValueError, match="-np"):
        port_launch._run(port_launch.parse_args(["x"]))


def test_slot_command_and_secret_transport_match_jax():
    slot = port_hosts.get_host_assignments(
        port_hosts.parse_hosts("localhost:2"), 2, 2)[1]
    jslot = jax_hosts.get_host_assignments(
        jax_hosts.parse_hosts("localhost:2"), 2, 2)[1]
    env = {"PATH": "/usr/bin", "HOROVOD_SECRET_KEY": "SECRET123",
           "WITH_SPACE": "a b", "BASH_FUNC_x%%": "() { :; }",
           "MULTI": "a\nb"}
    common = {"HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
              "HOROVOD_SECRET_KEY": "SECRET123"}
    got = port_run.slot_command("python t.py", slot, env, common)
    assert got == jax_run.slot_command("python t.py", jslot, env, common)
    assert "SECRET123" not in got and "HOROVOD_RANK=1" in got
    for local in (True, False):
        cmd, exec_env, stdin = port_run.secret_transport("echo hi", "K",
                                                         local)
        jcmd, jenv, jstdin = jax_run.secret_transport("echo hi", "K", local)
        assert (cmd, stdin) == (jcmd, jstdin) and "K" not in cmd.split()
        assert exec_env == jenv


# ---------------------------------------------------------------------------
# the rendezvous KV: the same wire, both ways
# ---------------------------------------------------------------------------
def _signed_get(port, path, secret):
    ts = repr(time.time())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    req.add_header(port_secret.TS_HEADER, ts)
    req.add_header(port_secret.HEADER,
                   port_secret.sign(secret, "GET", path, b"", ts))
    return req


def _status(req) -> int:
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_kv_wire_interop_with_a_secret(server, client, monkeypatch):
    monkeypatch.delenv(port_secret.ENV, raising=False)
    key = port_secret.make_secret_key()
    srv = HTTP[server].RendezvousServer(secret=key)
    port = srv.start()
    try:
        c = HTTP[client].RendezvousClient("127.0.0.1", port, secret=key)
        assert c.get("s", "k") is None
        c.put("s", "k", b"hello")
        c.put("s", "k2", bytes(range(256)))
        assert c.get("s", "k") == b"hello"
        assert c.get("s", "k2") == bytes(range(256))
        assert sorted(c.keys("s")) == ["k", "k2"]

        def put_later():
            time.sleep(0.3)
            c.put("late", "v", b"late")

        t = threading.Thread(target=put_later, daemon=True)
        t.start()
        assert c.wait_get("late", "v", timeout=10.0) == b"late"
        t.join(timeout=10)
        with pytest.raises(TimeoutError):
            c.wait_get("s", "never", timeout=0.3)
        c.delete("s")
        assert srv.kvstore.is_finalized("s")

        # A wrong key, no signature and a stale timestamp are refused
        # with 403, and the store is untouched.
        bad = HTTP[client].RendezvousClient(
            "127.0.0.1", port, secret=port_secret.make_secret_key())
        with pytest.raises(urllib.error.HTTPError) as e:
            bad.put("s", "evil", b"x")
        assert e.value.code == 403
        assert srv.kvstore.get("s", "evil") is None
        with pytest.raises(urllib.error.HTTPError) as e:
            bad.get("s", "k")
        assert e.value.code == 403
        assert _status(urllib.request.Request(
            f"http://127.0.0.1:{port}/s/k")) == 403
        stale = _signed_get(port, "/s/k", key)
        ts = repr(time.time() - 2 * port_secret.MAX_SKEW_S)
        stale.add_header(port_secret.TS_HEADER, ts)
        stale.add_header(port_secret.HEADER,
                         port_secret.sign(key, "GET", "/s/k", b"", ts))
        assert _status(stale) == 403
        assert _status(_signed_get(port, "/s/k", key)) == 200
    finally:
        srv.stop()


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_kv_serves_openly_without_a_secret(server, client, monkeypatch):
    monkeypatch.delenv(port_secret.ENV, raising=False)
    srv = HTTP[server].RendezvousServer()
    port = srv.start()
    try:
        c = HTTP[client].RendezvousClient("127.0.0.1", port, secret="")
        c.put("s", "k", b"v")
        assert c.get("s", "k") == b"v"
        assert _status(urllib.request.Request(
            f"http://127.0.0.1:{port}/s/k")) == 200
    finally:
        srv.stop()


def test_job_secret_signs_as_in_jax(monkeypatch):
    for args in (("k", "PUT", "/s/k", b"v", "1.5"),
                 ("k", "GET", "/metrics", b"", repr(time.time()))):
        assert port_secret.sign(*args) == jax_secret.sign(*args)
    assert port_secret.ENV == jax_secret.ENV
    assert port_secret.MAX_SKEW_S == jax_secret.MAX_SKEW_S
    monkeypatch.delenv(port_secret.ENV, raising=False)
    assert port_secret.for_job(None) != port_secret.for_job(None)
    assert port_secret.for_job({port_secret.ENV: "pinned"}) == "pinned"
    monkeypatch.setenv(port_secret.ENV, "from-env")
    assert port_secret.for_job(None) == "from-env"


# ---------------------------------------------------------------------------
# rank-0 endpoints through the KV
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("publisher", ["port", "jax"])
def test_rank1_resolves_what_rank0_published(publisher, monkeypatch):
    monkeypatch.delenv(port_secret.ENV, raising=False)
    key = port_secret.make_secret_key()
    srv = port_http.RendezvousServer(secret=key)
    port = srv.start()
    resolve = {"port": port_endpoints.resolve_endpoints,
               "jax": jax_endpoints.resolve_endpoints}
    try:
        got = {}

        def rank1(pkg):
            client = HTTP[pkg].RendezvousClient("127.0.0.1", port,
                                                secret=key)
            got[pkg] = resolve[pkg](client, 1, "10.0.0.7",
                                    port_endpoints.STATIC_KEY, timeout=20)

        readers = [threading.Thread(target=rank1, args=(pkg,), daemon=True)
                   for pkg in ("port", "jax")]
        for t in readers:
            t.start()
        time.sleep(0.2)
        published = resolve[publisher](
            HTTP[publisher].RendezvousClient("127.0.0.1", port, secret=key),
            0, "10.0.0.7", port_endpoints.STATIC_KEY, timeout=20)
        for t in readers:
            t.join(timeout=20)
            assert not t.is_alive()
        assert got == {"port": published, "jax": published}
        assert sorted(published) == ["controller_addr", "coordinator"]
        assert published["coordinator"].startswith("10.0.0.7:")
        assert published["coordinator"] != published["controller_addr"]
        assert port_endpoints.ENDPOINTS_SCOPE == jax_endpoints.ENDPOINTS_SCOPE
    finally:
        srv.stop()


def test_elastic_rendezvous_names_the_elastic_slice(monkeypatch):
    # With the elastic slice ported, an elastic worker asks the driver
    # for its rank at init; a driver that never answers ends the init
    # with an error that names the elastic rendezvous, bounded by the
    # start timeout, and leaves the process uninitialized.
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setenv(env_mod.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1")
    monkeypatch.setenv(env_mod.HOROVOD_RENDEZVOUS_PORT, "1")
    monkeypatch.setenv(env_mod.HOROVOD_START_TIMEOUT, "1")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="elastic rendezvous"):
        basics.init()
    assert time.monotonic() - t0 < 10
    assert not basics.is_initialized()


# ---------------------------------------------------------------------------
# /metrics under the job secret: the JAX package's status codes
# ---------------------------------------------------------------------------
def _metrics_codes(metrics_mod, secret):
    reg = metrics_mod.MetricsRegistry()
    reg.counter("sec_total").inc(5)
    srv = metrics_mod.serve(port=0, registry=reg, secret=secret,
                            status_provider=lambda: {"rank": 0})
    try:
        base = f"http://127.0.0.1:{srv.port}"
        codes = {}
        for path in ("/metrics", "/status", "/profile", "/other"):
            codes[path, "unsigned"] = _status(
                urllib.request.Request(base + path))
            req = _signed_get(srv.port, path, secret or "x")
            codes[path, "signed"] = _status(req)
            wrong = _signed_get(srv.port, path, "not-the-secret")
            codes[path, "wrong"] = _status(wrong)
        with urllib.request.urlopen(_signed_get(srv.port, "/metrics",
                                                secret or "x"),
                                    timeout=10) as r:
            body = r.read().decode()
        ts = repr(time.time())
        put = urllib.request.Request(base + "/metrics", data=b"x",
                                     method="PUT")
        put.add_header(port_secret.TS_HEADER, ts)
        put.add_header(port_secret.HEADER, port_secret.sign(
            secret or "x", "PUT", "/metrics", b"x", ts))
        codes["/metrics", "put"] = _status(put)
        return codes, body
    finally:
        srv.stop()


@pytest.mark.parametrize("secret", ["a-job-secret", ""])
def test_metrics_endpoint_status_codes_match_jax(secret):
    got, body = _metrics_codes(port_metrics, secret)
    want, jax_body = _metrics_codes(jax_metrics, secret)
    assert got == want
    assert "sec_total 5.0" in body and "sec_total 5.0" in jax_body
    if secret:
        assert got["/metrics", "signed"] == 200
        assert got["/metrics", "unsigned"] == 403
        assert got["/metrics", "wrong"] == 403
        assert got["/other", "signed"] == 404
        assert got["/profile", "signed"] == 404   # no provider wired
    else:
        assert got["/metrics", "unsigned"] == 200
    assert got["/metrics", "put"] == 405


def test_metrics_port_starts_the_endpoint_at_init(monkeypatch):
    key = port_secret.make_secret_key()
    monkeypatch.setenv(env_mod.HOROVOD_METRICS_PORT, "0")
    monkeypatch.setenv(port_secret.ENV, key)
    basics.init()
    try:
        srv = basics._state().metrics_server
        assert srv is not None and srv.port > 0
        with urllib.request.urlopen(_signed_get(srv.port, "/metrics", key),
                                    timeout=10) as r:
            assert "hvd_" in r.read().decode()
        assert _status(urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/metrics")) == 403
        with urllib.request.urlopen(_signed_get(srv.port, "/status", key),
                                    timeout=10) as r:
            assert b'"rank": 0' in r.read()
    finally:
        basics.shutdown()
    assert basics._state().metrics_server is None


# ---------------------------------------------------------------------------
# --check-build
# ---------------------------------------------------------------------------
def test_check_build_lists_pytorch_and_no_jax(capsys):
    with mock.patch.object(sys, "argv", ["horovodrun", "--check-build"]):
        port_launch.run_commandline()
    out = capsys.readouterr().out
    assert "[X] PyTorch" in out
    assert "JAX" not in out and "XLA" not in out
    for row in ("TCP (Python coordinator)", "NCCL", "Gloo", "CUDA cards",
                "nvcc"):
        assert row in out, row
    assert "[X] TCP (native C++ coordinator)\n" in out


def test_check_build_says_why_the_native_coordinator_is_missing(
        capsys, monkeypatch, tmp_path):
    from horovod_tpu_torch import native
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with mock.patch.object(sys, "argv", ["horovodrun", "--check-build"]):
        port_launch.run_commandline()
    out = capsys.readouterr().out
    assert "[ ] TCP (native C++ coordinator): g++ not found\n" in out
