"""The port's native C++ coordinator on the CPU, held against the JAX
package's (the counterparts of tests/test_native_coordinator.py and of
the ``[1]`` cases of tests/test_response_cache.py).

Each multi-process case runs one body, written against the torch
binding both packages share (bound to ``T``), in a world of port workers
and in a world of JAX-package workers, each with
``HOROVOD_TPU_NATIVE=1`` unless the case says otherwise: the body's own
checks hold in both, rank 0 hosts each package's native server, and the
outputs and rank 0's response-cache rounds (``cache_stats()``: fast and
full) are equal across the two packages.  One case puts the JAX
package's ``NativeCoordinatorServer`` under a world of port workers:
the two speak one wire.  The port's ``coordinator.cc`` is the JAX
package's file, byte for byte.
"""

import json
import os

import pytest

from multiproc import REPO, assert_all_ok, run_workers
from test_torch_port_multiproc import WORKER_TIMEOUT_S, run_port_workers

pytestmark = pytest.mark.multiproc

_HEAD = {
    "jax": "import torch\nimport horovod_tpu.torch as T\n"
           "from horovod_tpu.common import basics\nPKG = 'jax'\n",
    "port": "T = hvd\nfrom horovod_tpu_torch.common import basics\n"
            "PKG = 'port'\n",
}

_PRE = """
ctrl = basics._state().runtime.controller
out = {}

def cache_stats():
    srv = ctrl.server
    if hasattr(srv, "cache_stats"):
        return tuple(srv.cache_stats())
    return srv.stats["fast_rounds"], srv.stats["full_rounds"]

def _under(lock_wait, what, deadline_s=60.0):
    import threading
    t = threading.Thread(target=lock_wait, daemon=True)
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        raise AssertionError(f"{what} still held after {deadline_s} s")

# Returns once rank 0's server has counted every round whose response
# this rank holds.  Both servers broadcast a round and then count it
# (cache rounds, byte history) under their round lock, so a round's
# response can reach a rank before its count lands.  The native server's
# stall_report() takes that lock (coordinator.cc StallReport), and the
# Python server's is its _lock.
def settle():
    srv = ctrl.server
    if hasattr(srv, "cache_stats"):
        _under(srv.stall_report, "the native server's round lock")
    else:
        def wait():
            with srv._lock:
                pass
        _under(wait, "the Python server's round lock")

# ctrl.stats[key] for an uplink frame kind once the frame in flight, if
# any, is counted: a worker counts a frame under its send lock just
# after the send returns, so the frame's response can reach this rank
# before the count lands.
def sent(key):
    got = {}

    def read():
        with ctrl._send_lock:
            got["n"] = ctrl.stats[key]
    _under(read, "the worker's send lock")
    return got["n"]
"""

# Written by every rank at the end of a body: its outputs, and on rank 0
# the server it hosted and the server's cache rounds.
_POST = """
import json
def enc(v):
    if isinstance(v, torch.Tensor):
        return {"dtype": str(v.dtype), "shape": list(v.shape),
                "values": v.tolist()}
    if isinstance(v, (list, tuple)):
        return [enc(x) for x in v]
    return v
rec = {"out": {k: enc(v) for k, v in out.items()}}
if RANK == 0:
    rec["server"] = [type(ctrl.server).__module__,
                     type(ctrl.server).__name__]
    settle()
    rec["cache_stats"] = list(cache_stats())
with open(os.path.join(os.environ["RESULT_DIR"], f"{PKG}-{RANK}.json"),
          "w") as f:
    json.dump(rec, f)
print("CASE DONE", RANK, flush=True)
"""

_PROTOCOL = """
out["ar"] = T.allreduce(torch.ones(8) * (RANK + 1), op=T.Sum, name="ar",
                        prescale_factor=0.5)
assert torch.equal(out["ar"], torch.ones(8) * 1.5), out["ar"]
# grouped (fusable) + mixed dtypes exercise fusion look-ahead
out["g0"], out["g1"] = T.grouped_allreduce(
    [torch.ones(4), torch.ones(2, dtype=torch.float64) * 2], op=T.Sum,
    name="g")
assert torch.equal(out["g1"], torch.full((2,), 4.0, dtype=torch.float64))
# allgather of unequal first dims
mine = torch.arange((RANK + 1) * 2, dtype=torch.int64).reshape(RANK + 1, 2)
out["ag"] = T.allgather(mine, name="ag")
assert out["ag"].shape == (3, 2), out["ag"].shape
out["bc"] = T.broadcast(torch.full((3,), float(RANK)), 1, name="bc")
assert torch.equal(out["bc"], torch.ones(3))
T.barrier()
out["join"] = T.join() in (0, 1)
# shape-mismatch must produce a coordinator error
try:
    T.allreduce(torch.ones(3 + RANK), op=T.Sum, name="bad")
    raise SystemExit("expected coordinator error")
except Exception as e:
    assert "mismatch" in str(e).lower(), e
    out["bad"] = type(e).__name__
"""

# The [1] cases of tests/test_response_cache.py: (ranks, env, body).
_CACHE_CASES = {
    "steady_state": (2, {}, """
steps = 30
for step in range(steps):
    y = T.allreduce(torch.full((16,), float(RANK + 1 + step)), op=T.Sum,
                    name="grad/w1")
    assert torch.equal(y, torch.full((16,), 3.0 + 2 * step)), y
    g = T.allgather(torch.full((RANK + 1, 2), float(step)), name="gather/x")
    assert g.shape == (3, 2), g.shape
out["y"], out["g"] = y, g
s = ctrl.stats
# Warm-up negotiates once per tensor; every later step must ride the
# compact cache frames.
assert s["ch_frames"] >= steps - 3, s
assert s["rq_frames"] <= 4, s
assert s["cb_frames"] >= steps - 3, s
if RANK == 0:
    fast, full = cache_stats()
    assert fast >= steps - 3, (fast, full)
    assert full <= 8, (fast, full)
"""),
    "invalidation_on_shape_change": (2, {}, """
for step in range(5):
    y = T.allreduce(torch.ones(8), op=T.Sum, name="t")
    assert torch.equal(y, torch.full((8,), 2.0))
rq_before = ctrl.stats["rq_frames"]
# Shape change on BOTH ranks: must renegotiate, then re-enter the fast
# path.
for step in range(5):
    y = T.allreduce(torch.ones(4), op=T.Sum, name="t")
    assert torch.equal(y, torch.full((4,), 2.0))
s = ctrl.stats
assert s["rq_frames"] >= rq_before + 1, s
assert s["ch_frames"] >= 7, s
out["y"] = y
"""),
    "mismatched_shape_error": (2, {}, """
for step in range(3):
    T.allreduce(torch.ones(8), op=T.Sum, name="t")
shape = (4,) if RANK == 0 else (8,)
try:
    T.allreduce(torch.ones(shape), op=T.Sum, name="t")
except Exception as e:
    out["error"] = type(e).__name__
else:
    raise AssertionError("expected a mismatch error")
"""),
    "grouped_past_threshold": (2, {"HOROVOD_FUSION_THRESHOLD": "4096"}, """
xs = [torch.full((1024,), float(RANK + i)) for i in range(4)]
for rep in range(3):
    ys = T.grouped_allreduce(xs, op=T.Sum, name=f"g{rep}")
    for i, y in enumerate(ys):
        assert torch.equal(y, torch.full((1024,), 2.0 * i + 1.0))
out.update({f"y{i}": y for i, y in enumerate(ys)})
"""),
    "bypassed_while_rank_joined": (2, {}, """
import time
# Steady state: cache the allgather (per-rank rows RANK+1).
for step in range(5):
    g = T.allgather(torch.full((RANK + 1, 2), float(step)), name="jg")
    assert g.shape == (3, 2), g.shape
if RANK == 1:
    T.join()
else:
    time.sleep(1.5)   # let rank 1's join land first
    # Same signature -> this rank submits a cache bit; the coordinator
    # must renegotiate, not serve the cached layout with rank 1's rows.
    g = T.allgather(torch.full((1, 2), 7.0), name="jg")
    assert torch.equal(g, torch.full((1, 2), 7.0)), g
    out["g"] = g
    T.join()
"""),
    "group_invalidation_demotes_whole_group": (2, {}, """
xs = [torch.full((8,), float(i + 1)) for i in range(3)]
for rep in range(6):
    ys = T.grouped_allreduce(xs, op=T.Sum, name="gg")
    for i, y in enumerate(ys):
        assert torch.equal(y, torch.full((8,), 2.0 * (i + 1)))
ch_before = sent("ch_frames")
# Member 1 changes shape; members 0 and 2 still match their cached
# signatures but must be demoted with it.
xs2 = [torch.full((8,), 1.0), torch.full((4,), 2.0), torch.full((8,), 3.0)]
ys = T.grouped_allreduce(xs2, op=T.Sum, name="gg")
out["demoted"] = list(ys)
assert [y.tolist() for y in ys] == [[2.0] * 8, [4.0] * 4, [6.0] * 8]
# No cache bits may have been sent for the demoted round.
assert sent("ch_frames") == ch_before, ctrl.stats
for rep in range(3):
    ys = T.grouped_allreduce(xs2, op=T.Sum, name="gg")
    assert torch.equal(ys[1], torch.full((4,), 4.0))
assert sent("ch_frames") > ch_before, ctrl.stats
out["resumed"] = list(ys)
"""),
    "stall_attribution": (2, {"HOROVOD_STALL_CHECK_TIME_SECONDS": "1"}, """
import time
if RANK == 0:
    h = T.allreduce_async(torch.ones(4), op=T.Sum, name="stall.t")
    deadline = time.time() + 20
    found = ""
    while time.time() < deadline:
        rep = ctrl.server.stall_report()
        if not isinstance(rep, str):
            rep = "; ".join(f"{n}: submitted {s} missing {m} age {a:.0f}"
                            for n, s, m, a in rep)
        if "stall.t" in rep:
            found = rep
            break
        time.sleep(0.25)
    assert "stall.t" in found, f"no stall report: {found!r}"
    assert "1" in found.split("stall.t", 1)[1], found
    print("REPORTED:", found.strip())
    # Unblock: tell rank 1 (via a second collective) to submit.
    T.allreduce(torch.zeros(1), op=T.Sum, name="go")
    out["stalled"] = T.synchronize(h)
else:
    T.allreduce(torch.zeros(1), op=T.Sum, name="go")
    out["stalled"] = T.allreduce(torch.ones(4), op=T.Sum, name="stall.t")
"""),
    "steady_state_nproc4": (4, {}, """
for step in range(20):
    y = T.allreduce(torch.full((32,), 1.0), op=T.Sum, name="t")
    assert torch.equal(y, torch.full((32,), 4.0))
s = ctrl.stats
assert s["ch_frames"] >= 15 and s["rq_frames"] <= 3, s
out["y"] = y
"""),
    "partial_hit_set_nproc4": (4, {}, """
for step in range(5):
    y = T.allreduce(torch.full((16,), float(RANK)), op=T.Sum, name="t")
    assert torch.equal(y, torch.full((16,), 6.0))
rs_before = ctrl.stats["rs_frames"]
if RANK == 3:
    # A cold worker cache: this rank sends a full request while the
    # other three send bits.
    ent = ctrl.cache._entries.get((0, "t"))  # (psid, name)
    assert ent is not None
    ctrl.cache.evict_bits([ent[0]])
y = T.allreduce(torch.full((16,), float(RANK)), op=T.Sum, name="t")
assert torch.equal(y, torch.full((16,), 6.0))
# The degraded round renegotiated (RS frame), not CB-only.
assert ctrl.stats["rs_frames"] >= rs_before + 1, ctrl.stats
ch_before = sent("ch_frames")
for step in range(5):
    y = T.allreduce(torch.full((16,), float(RANK)), op=T.Sum, name="t")
    assert torch.equal(y, torch.full((16,), 6.0))
assert sent("ch_frames") >= ch_before + 4, ctrl.stats
out["y"] = y
"""),
    "tombstone_churn_nproc4": (4, {"HOROVOD_CACHE_CAPACITY": "2"}, """
for step in range(25):
    for j, name in enumerate(("a", "b", "c")):
        y = T.allreduce(torch.full((8,), float(j)), op=T.Sum, name=name)
        assert torch.equal(y, torch.full((8,), 4.0 * j))
        out[name] = y
assert ctrl.stats["ev_frames"] > 0, ctrl.stats
"""),
    "group_demotion_nproc4": (4, {}, """
xs = [torch.full((8,), float(i + 1)) for i in range(3)]
for rep in range(6):
    ys = T.grouped_allreduce(xs, op=T.Sum, name="gg")
    for i, y in enumerate(ys):
        assert torch.equal(y, torch.full((8,), 4.0 * (i + 1)))
ch_before = sent("ch_frames")
xs2 = [torch.full((8,), 1.0), torch.full((4,), 2.0), torch.full((8,), 3.0)]
ys = T.grouped_allreduce(xs2, op=T.Sum, name="gg")
assert [y.tolist() for y in ys] == [[4.0] * 8, [8.0] * 4, [12.0] * 8]
out["demoted"] = list(ys)
assert sent("ch_frames") == ch_before, ctrl.stats
for rep in range(3):
    ys = T.grouped_allreduce(xs2, op=T.Sum, name="gg")
    assert torch.equal(ys[1], torch.full((4,), 8.0))
assert sent("ch_frames") > ch_before, ctrl.stats
"""),
}

_HISTORY = """
# Distinct payload sizes in separate rounds (the barrier forces a round
# boundary between them).
for i, n in enumerate((256, 65536)):
    out[f"rr{i}"] = T.allreduce(torch.ones(n), op=T.Sum, name=f"rr.{i}")
    T.barrier()
if RANK == 0:
    settle()
    vals = [v for v in ctrl.server.drain_round_bytes() if v > 0]
    # Both payload sizes appear verbatim in the history.
    assert 256 * 4 in vals and 65536 * 4 in vals, vals
    out["history"] = vals
"""

# Rank 0 of a port world hosts the JAX package's server class.
_JAX_SERVER_IN_PORT = """
if RANK == 0:
    import horovod_tpu.native
    import horovod_tpu_torch.native
    horovod_tpu_torch.native.NativeCoordinatorServer = \\
        horovod_tpu.native.NativeCoordinatorServer
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """run(pkg, name, nproc, body, env) -> per-rank records of one world,
    made once per (pkg, name) in this module."""
    done = {}

    def run(pkg, name, nproc, body, env, before_init=""):
        key = (pkg, name)
        if key not in done:
            result_dir = str(tmp_path_factory.mktemp(f"{pkg}-{name}"))
            env = dict(env, RESULT_DIR=result_dir)
            code = _HEAD[pkg] + _PRE + body + _POST
            if pkg == "jax":
                results = run_workers(code, nproc=nproc, extra_env=env,
                                      timeout=WORKER_TIMEOUT_S)
            else:
                results = run_port_workers(code, nproc=nproc, extra_env=env,
                                           before_init=before_init)
            assert_all_ok(results)
            recs = []
            for r in range(nproc):
                with open(os.path.join(result_dir, f"{pkg}-{r}.json")) as f:
                    recs.append(json.load(f))
            done[key] = recs
        return done[key]

    return run


def _assert_same(port, jax, server_module):
    """Equal outputs on every rank and equal cache rounds on rank 0; rank
    0 hosted ``server_module``'s native server in the port's world and
    the JAX package's in the JAX world."""
    assert len(port) == len(jax)
    for r, (p, j) in enumerate(zip(port, jax)):
        assert p["out"] == j["out"], f"rank {r}"
    assert port[0]["server"] == [server_module, "NativeCoordinatorServer"]
    assert jax[0]["server"] == ["horovod_tpu.native",
                                "NativeCoordinatorServer"]
    assert port[0]["cache_stats"] == jax[0]["cache_stats"]


@pytest.mark.parametrize("native", ["1", "0"])
def test_coordinator_protocol(worlds, native):
    """The protocol body at native 1 and 0: equal outputs in both
    packages, on the server each package's selection gives."""
    env = {"HOROVOD_TPU_NATIVE": native}
    port = worlds("port", f"protocol{native}", 2, _PROTOCOL, env)
    jax = worlds("jax", f"protocol{native}", 2, _PROTOCOL, env)
    if native == "1":
        _assert_same(port, jax, "horovod_tpu_torch.native")
    else:
        for r in range(2):
            assert port[r]["out"] == jax[r]["out"], f"rank {r}"
        assert port[0]["server"] == ["horovod_tpu_torch.common."
                                     "controller_net", "CoordinatorServer"]
        assert jax[0]["server"][1] == "CoordinatorServer"
    assert port[0]["out"]["bad"] == "HorovodInternalError"


def test_port_world_on_the_jax_native_server(worlds):
    """Port workers, rank 0 hosting the JAX package's
    NativeCoordinatorServer (its own build of coordinator.cc): the
    protocol body gives the JAX world's outputs and cache rounds."""
    env = {"HOROVOD_TPU_NATIVE": "1"}
    mixed = worlds("port", "protocol_on_jax_server", 2, _PROTOCOL, env,
                   before_init=_JAX_SERVER_IN_PORT)
    jax = worlds("jax", "protocol1", 2, _PROTOCOL, env)
    _assert_same(mixed, jax, "horovod_tpu.native")


@pytest.mark.parametrize("case", sorted(_CACHE_CASES))
def test_response_cache_on_the_native_server(worlds, case):
    nproc, env, body = _CACHE_CASES[case]
    env = dict(env, HOROVOD_TPU_NATIVE="1")
    port = worlds("port", case, nproc, body, env)
    jax = worlds("jax", case, nproc, body, env)
    _assert_same(port, jax, "horovod_tpu_torch.native")


def test_native_per_round_byte_history(worlds):
    """The autotune feed carries the true per-round byte values, the
    same in both packages."""
    env = {"HOROVOD_TPU_NATIVE": "1"}
    port = worlds("port", "history", 2, _HISTORY, env)
    jax = worlds("jax", "history", 2, _HISTORY, env)
    _assert_same(port, jax, "horovod_tpu_torch.native")


def test_native_lib_builds_and_binds():
    from horovod_tpu import native as jax_native
    from horovod_tpu_torch import native
    assert native.available(), native.unavailable_reason()
    assert jax_native.available()
    for mod in (native, jax_native):
        srv = mod.NativeCoordinatorServer(2)
        try:
            assert srv.port > 0
            assert srv.drain_round_bytes() == []   # no rounds committed
            assert srv.cache_stats() == (0, 0)
            assert srv.departure_counts() == (0, 0)
            assert srv.stall_report() == ""
        finally:
            srv.stop()
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


def test_coordinator_source_is_the_jax_packages():
    """coordinator.cc is the JAX package's file, byte for byte (ROADMAP
    Queue 3 names any line where they may differ; none does)."""
    with open(os.path.join(REPO, "horovod_tpu_torch", "native",
                           "coordinator.cc"), "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "horovod_tpu", "native",
                           "coordinator.cc"), "rb") as f:
        jax = f.read()
    assert port == jax
