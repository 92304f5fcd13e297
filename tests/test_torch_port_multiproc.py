"""The port's multi-rank data plane on the CPU: worker processes with the
launcher's env contract, gloo for the data, ``controller_net`` for the
negotiation.  The 2-rank port run goes twice, once with the env contract
set here and once started by the port's launcher
(``python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2``);
both are held against the one JAX package run.

* Every eager op at 2 ranks through ``horovod_tpu_torch.torch`` and
  through ``horovod_tpu.torch`` on the same numpy inputs: the two agree
  exactly, and both equal the values computed here.
* The same MLP and the port's tiny GPT (flash attention's plain
  version), trained at 2 ranks through both packages' hook-based
  ``DistributedOptimizer`` from one numpy-made state dict, for Average
  and Adasum: final parameters agree to atol 1e-6, rtol 1e-5 (at two
  ranks a Sum is one addition per element; only Adasum's dot products
  differ in summation order).
* A process set {0, 2} at 3 ranks, and the hierarchical allreduce at 4
  ranks (2 hosts x 2 local ranks).

The port's workers import only torch, numpy and ``horovod_tpu_torch``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from multiproc import REPO, assert_all_ok, free_ports, run_workers

pytestmark = pytest.mark.multiproc

WORKER_TIMEOUT_S = 150

_PORT_PRELUDE = """
import os, sys
import numpy as np
import torch
import horovod_tpu_torch.torch as hvd
hvd.init()
RANK = hvd.rank()
SIZE = hvd.size()
"""


def _pins_native(env) -> bool:
    return env.get("HOROVOD_TPU_NATIVE", "").strip().lower() in \
        ("1", "true", "on", "yes")


def _test_defaults(supplied) -> dict:
    """The test defaults of ``multiproc.run_workers``: replay off, and
    liveness on with test-scale values unless the test pins the native
    coordinator (the self-healing channel is Python-coordinator-only,
    and strict native beside liveness is a config error).  So a test
    that pins nothing runs the Python coordinator, as the JAX package's
    suites do."""
    env = {"HOROVOD_STEADY_STATE_REPLAY": "0"}
    if not _pins_native(supplied):
        env.update({"HOROVOD_LIVENESS_INTERVAL": "3",
                    "HOROVOD_LIVENESS_TIMEOUT": "15",
                    "HOROVOD_RECONNECT_GRACE": "10"})
    return env


def launcher_env(extra_env=None):
    """The environment of a port launcher process: this one's, with the
    test defaults of ``run_port_workers`` (the launcher forwards it to
    every worker)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(_test_defaults(extra_env or {}))
    env.update({"HOROVOD_START_TIMEOUT": "60", "PYTHONPATH": REPO})
    env.update(extra_env or {})
    return env


def run_port_launcher(args, env, timeout=WORKER_TIMEOUT_S):
    """``python -m horovod_tpu_torch.runner.launch *args`` in its own
    session; past ``timeout`` the launcher and its workers are killed.
    Returns (returncode, output)."""
    from horovod_tpu_torch.runner.safe_shell_exec import \
        terminate_process_tree
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        terminate_process_tree(p.pid, grace_s=1.0)
        out, _ = p.communicate()
        return -9, out.decode(errors="replace")
    return p.returncode, out.decode(errors="replace")


def run_port_workers(body: str, nproc: int = 2, per_rank_env=None,
                     extra_env=None, before_init: str = "",
                     timeout: float = WORKER_TIMEOUT_S):
    """``body`` in ``nproc`` port workers (sees RANK/SIZE/np/torch/hvd);
    the env contract and test defaults of ``multiproc.run_workers``;
    a worker still running ``timeout`` seconds into its wait is killed.
    ``before_init`` runs before ``hvd.init()`` (sees RANK from the env
    contract).  Returns [(returncode, output)]."""
    coord_port, ctrl_port = free_ports(2)
    code = _PORT_PRELUDE.replace(
        "hvd.init()\n", "RANK = int(os.environ['HOROVOD_RANK'])\n" +
        textwrap.dedent(before_init) + "hvd.init()\n", 1) + \
        textwrap.dedent(body)
    procs = []
    for rank in range(nproc):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update({
            "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(nproc),
            "HOROVOD_LOCAL_RANK": str(rank),
            "HOROVOD_LOCAL_SIZE": str(nproc),
            "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
            "HOROVOD_TPU_COORDINATOR": f"127.0.0.1:{coord_port}",
            "HOROVOD_CONTROLLER_ADDR": f"127.0.0.1:{ctrl_port}",
            "PYTHONPATH": REPO,
        })
        supplied = dict(extra_env or {})
        if per_rank_env:
            supplied.update({k: str(v)
                             for k, v in per_rank_env(rank).items()})
        env.update(_test_defaults(supplied))
        env.update(supplied)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            results.append((-9, out.decode(errors="replace")))
            continue
        results.append((p.returncode, out.decode(errors="replace")))
    return results


# Inputs of rank RANK, made with numpy from a seed: the workers of both
# packages and this module exec the same source.
_INPUTS = """
def inputs(rank):
    rng = np.random.RandomState(10 + rank)
    return {
        "f32": rng.randn(6, 5).astype(np.float32),
        "i32": rng.randint(-50, 50, size=(7,)).astype(np.int32),
        "i64": rng.randint(-50, 50, size=(3, 2)).astype(np.int64),
        "u8": rng.randint(0, 256, size=(9,)).astype(np.uint8),
        "small": rng.randint(1, 4, size=(5,)).astype(np.int32),
        "rows": rng.randn(rank + 2, 3).astype(np.float32),
        "rows_i64": rng.randint(0, 9, size=(rank + 1, 2)).astype(np.int64),
        "a2a": (np.arange(12, dtype=np.float32).reshape(6, 2) + 100 * rank),
        "rs": rng.randn(5, 2).astype(np.float32),
        "adasum": rng.randn(11).astype(np.float32) * (rank + 1),
    }

A2A_SPLITS = {0: [1, 5], 1: [4, 2]}
"""

# The eager ops and the two trainings, written once against the torch
# binding API both packages share (bound to T).
_BODY = _INPUTS + """
import torch
from horovod_tpu_torch.models import gpt
torch.set_num_threads(1)

def np_(t):
    return t.detach().cpu().numpy()

x = {k: torch.from_numpy(v) for k, v in inputs(RANK).items()}
out = {}
out["sum_f32"] = np_(T.allreduce(x["f32"], op=T.Sum, name="sum_f32"))
out["avg_f32"] = np_(T.allreduce(x["f32"], op=T.Average, name="avg_f32"))
out["scaled_f32"] = np_(T.allreduce(x["f32"], op=T.Sum, name="scaled",
                                    prescale_factor=0.5,
                                    postscale_factor=3.0))
out["min_f32"] = np_(T.allreduce(x["f32"], op=T.Min, name="min_f32"))
out["max_f32"] = np_(T.allreduce(x["f32"], op=T.Max, name="max_f32"))
out["sum_i32"] = np_(T.allreduce(x["i32"], op=T.Sum, name="sum_i32"))
out["min_i32"] = np_(T.allreduce(x["i32"], op=T.Min, name="min_i32"))
out["max_i32"] = np_(T.allreduce(x["i32"], op=T.Max, name="max_i32"))
out["sum_i64"] = np_(T.allreduce(x["i64"], op=T.Sum, name="sum_i64"))
out["min_u8"] = np_(T.allreduce(x["u8"], op=T.Min, name="min_u8"))
out["max_u8"] = np_(T.allreduce(x["u8"], op=T.Max, name="max_u8"))
out["prod_i32"] = np_(T.allreduce(x["small"], op=T.Product, name="prod"))
g = T.grouped_allreduce([x["f32"], x["i32"].float()], op=T.Sum, name="grp")
out["grouped_0"], out["grouped_1"] = np_(g[0]), np_(g[1])
out["allgather_f32"] = np_(T.allgather(x["rows"], name="ag_f32"))
out["allgather_i64"] = np_(T.allgather(x["rows_i64"], name="ag_i64"))
out["bcast_f32"] = np_(T.broadcast(x["f32"], root_rank=1, name="bc_f32"))
out["bcast_i32"] = np_(T.broadcast(x["i32"], root_rank=0, name="bc_i32"))
a2a, splits = T.alltoall(x["a2a"], splits=A2A_SPLITS[RANK], name="a2a")
out["a2a"], out["a2a_splits"] = np_(a2a), np.asarray(splits)
out["rs_sum"] = np_(T.reducescatter(x["rs"], op=T.Sum, name="rs_sum"))
out["rs_avg"] = np_(T.reducescatter(x["rs"], op=T.Average, name="rs_avg"))
out["adasum"] = np_(T.allreduce(x["adasum"], op=T.Adasum, name="adasum"))
out["bcast_object"] = np.asarray(repr(T.broadcast_object(
    {"rank": RANK, "v": [1, 2]}, root_rank=1)))
out["allgather_object"] = np.asarray(repr(T.allgather_object(RANK * 10)))
try:
    T.allreduce(torch.ones(2 + RANK), op=T.Sum, name="mismatch")
    out["mismatch"] = np.asarray("no error")
except Exception as e:
    out["mismatch"] = np.asarray(type(e).__name__ + ": " + str(e))


def mlp():
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 4))


def tiny_gpt():
    cfg = gpt.gpt_tiny_config(dtype=torch.float32, attention_impl="flash")
    return gpt.GPTLMHeadModel(cfg, device="cpu", seed=0), cfg


for kind in ("mlp", "gpt"):
    for op in ("Average", "Adasum"):
        if kind == "mlp":
            model = mlp()
        else:
            model, cfg = tiny_gpt()
        init = np.random.RandomState(0)
        with torch.no_grad():
            for _, p in sorted(model.named_parameters()):
                p.copy_(torch.from_numpy(
                    (init.randn(*p.shape) * 0.1).astype(np.float32)))
        T.broadcast_parameters(model.state_dict(), root_rank=0)
        named = [(f"{kind}.{op}.{n}", p) for n, p in model.named_parameters()]
        opt = T.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=named, op=getattr(T, op))
        T.broadcast_optimizer_state(opt, root_rank=0)
        data = np.random.RandomState(100 + RANK)
        for step in range(3):
            opt.zero_grad()
            if kind == "mlp":
                xb = torch.from_numpy(data.randn(4, 8).astype(np.float32))
                yb = torch.from_numpy(data.randn(4, 4).astype(np.float32))
                loss = ((model(xb) - yb) ** 2).mean()
            else:
                ids = torch.from_numpy(
                    data.randint(0, cfg.vocab_size, (2, 16)).astype(np.int64))
                loss = gpt.lm_loss(model(ids), ids)
            loss.backward()
            opt.step()
        for n, p in model.named_parameters():
            out[f"train/{kind}/{op}/{n}"] = np_(p)

out["join"] = np.asarray(T.join() in (0, 1))
out["after_join"] = np_(T.allreduce(x["i32"], op=T.Sum, name="after_join"))
np.savez(os.path.join(os.environ["RESULT_DIR"], f"{PKG}-{RANK}.npz"), **out)
print("BODY DONE", RANK)
"""


def _load(result_dir, pkg, nproc):
    out = []
    for r in range(nproc):
        with np.load(os.path.join(result_dir, f"{pkg}-{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


@pytest.fixture(scope="module")
def both_packages(tmp_path_factory):
    """The body at 2 ranks through each package, one world after the
    other (the suite runs beside other multi-process tests)."""
    result_dir = str(tmp_path_factory.mktemp("port_multiproc"))
    env = {"RESULT_DIR": result_dir}
    jax_body = ("import horovod_tpu.torch as T\nPKG = 'jax'\n" + _BODY)
    port_body = ("T = hvd\nPKG = 'port'\n" + _BODY)
    jax_results = run_workers(jax_body, nproc=2, timeout=WORKER_TIMEOUT_S,
                              extra_env=env)
    port_results = run_port_workers(port_body, nproc=2, extra_env=env)
    assert_all_ok(jax_results)
    assert_all_ok(port_results)
    return _load(result_dir, "jax", 2), _load(result_dir, "port", 2)


@pytest.fixture(scope="module")
def launched(tmp_path_factory, both_packages):
    """The port's body at 2 ranks started by the port's launcher, after
    the two worlds of ``both_packages``, whose JAX results it is held
    against."""
    tmp = tmp_path_factory.mktemp("port_launched")
    script = tmp / "body.py"
    script.write_text(_PORT_PRELUDE + "T = hvd\nPKG = 'launched'\n" + _BODY)
    rc, out = run_port_launcher(
        ["-np", "2", "-H", "localhost:2", sys.executable, str(script)],
        launcher_env({"RESULT_DIR": str(tmp)}))
    assert rc == 0, out[-3000:]
    assert out.count("BODY DONE") == 2, out[-3000:]
    return _load(str(tmp), "launched", 2)


def _expected():
    ns = {"np": np}
    exec(_INPUTS, ns)
    x = [ns["inputs"](r) for r in range(2)]
    f32 = [v["f32"] for v in x]
    want = {
        "sum_f32": f32[0] + f32[1],
        "avg_f32": (f32[0] + f32[1]) * np.float32(0.5),
        "scaled_f32": (f32[0] * np.float32(0.5) + f32[1] * np.float32(0.5))
        * np.float32(3.0),
        "min_f32": np.minimum(*f32), "max_f32": np.maximum(*f32),
        "sum_i32": x[0]["i32"] + x[1]["i32"],
        "min_i32": np.minimum(x[0]["i32"], x[1]["i32"]),
        "max_i32": np.maximum(x[0]["i32"], x[1]["i32"]),
        "sum_i64": x[0]["i64"] + x[1]["i64"],
        "min_u8": np.minimum(x[0]["u8"], x[1]["u8"]),
        "max_u8": np.maximum(x[0]["u8"], x[1]["u8"]),
        "prod_i32": x[0]["small"] * x[1]["small"],
        "grouped_0": f32[0] + f32[1],
        "grouped_1": (x[0]["i32"] + x[1]["i32"]).astype(np.float32),
        "allgather_f32": np.concatenate([v["rows"] for v in x]),
        "allgather_i64": np.concatenate([v["rows_i64"] for v in x]),
        "bcast_f32": f32[1], "bcast_i32": x[0]["i32"],
        "bcast_object": np.asarray(repr({"rank": 1, "v": [1, 2]})),
        "allgather_object": np.asarray(repr([0, 10])),
        "join": np.asarray(True),
        "after_join": x[0]["i32"] + x[1]["i32"],
    }
    per_rank = [dict(want) for _ in range(2)]
    splits = ns["A2A_SPLITS"]
    for r in range(2):
        pieces, recv = [], []
        for src in range(2):
            start = sum(splits[src][:r])
            pieces.append(x[src]["a2a"][start:start + splits[src][r]])
            recv.append(splits[src][r])
        per_rank[r]["a2a"] = np.concatenate(pieces)
        per_rank[r]["a2a_splits"] = np.asarray(recv)
        rs = x[0]["rs"] + x[1]["rs"]
        mine = rs[:3] if r == 0 else rs[3:]
        per_rank[r]["rs_sum"] = mine
        per_rank[r]["rs_avg"] = mine / np.float32(2)
    return per_rank


_EXACT = sorted(set(_expected()[0]))


@pytest.mark.parametrize("key", _EXACT)
def test_eager_op_matches_jax_exactly(both_packages, key):
    jax_res, port_res = both_packages
    want = _expected()
    for r in range(2):
        got, ref = port_res[r][key], jax_res[r][key]
        assert got.dtype == ref.dtype and got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want[r][key].astype(got.dtype))


def test_adasum_op_matches_jax(both_packages):
    from horovod_tpu.ops.adasum import adasum_reference_numpy
    jax_res, port_res = both_packages
    ns = {"np": np}
    exec(_INPUTS, ns)
    want = adasum_reference_numpy([ns["inputs"](r)["adasum"]
                                   for r in range(2)])
    for r in range(2):
        np.testing.assert_array_equal(port_res[r]["adasum"],
                                      port_res[0]["adasum"])
        np.testing.assert_allclose(port_res[r]["adasum"],
                                   jax_res[r]["adasum"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(port_res[r]["adasum"], want, rtol=1e-5,
                                   atol=1e-6)


def test_shape_mismatch_raises_the_same_error(both_packages):
    jax_res, port_res = both_packages
    for r in range(2):
        for msg in (str(port_res[r]["mismatch"]), str(jax_res[r]["mismatch"])):
            # The coordinator names the ranks in their order of arrival.
            assert msg.startswith("HorovodInternalError"), msg
            assert "rank 0 has (2,)" in msg and "rank 1 has (3,)" in msg, msg


@pytest.mark.parametrize("model", ["mlp", "gpt"])
@pytest.mark.parametrize("op", ["Average", "Adasum"])
def test_training_matches_jax(both_packages, model, op):
    jax_res, port_res = both_packages
    keys = sorted(k for k in port_res[0]
                  if k.startswith(f"train/{model}/{op}/"))
    assert keys and keys == sorted(k for k in jax_res[0]
                                   if k.startswith(f"train/{model}/{op}/"))
    for r in range(2):
        for k in keys:
            # Every rank ends with the same parameters.
            np.testing.assert_array_equal(port_res[r][k], port_res[0][k])
            np.testing.assert_allclose(port_res[r][k], jax_res[r][k],
                                       atol=1e-6, rtol=1e-5, err_msg=k)
    start = np.random.RandomState(0)
    moved = [not np.allclose(port_res[0][k],
                             start.randn(*port_res[0][k].shape) * 0.1)
             for k in sorted(keys)]
    assert any(moved)


@pytest.mark.parametrize("key", _EXACT)
def test_launched_eager_op_matches_jax_exactly(both_packages, launched, key):
    jax_res, _ = both_packages
    want = _expected()
    for r in range(2):
        got, ref = launched[r][key], jax_res[r][key]
        assert got.dtype == ref.dtype and got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want[r][key].astype(got.dtype))


@pytest.mark.parametrize("model", ["mlp", "gpt"])
@pytest.mark.parametrize("op", ["Average", "Adasum"])
def test_launched_training_matches_jax(both_packages, launched, model, op):
    jax_res, _ = both_packages
    keys = sorted(k for k in jax_res[0] if k.startswith(f"train/{model}/{op}/"))
    assert keys and keys == sorted(
        k for k in launched[0] if k.startswith(f"train/{model}/{op}/"))
    for r in range(2):
        for k in keys:
            np.testing.assert_array_equal(launched[r][k], launched[0][k])
            np.testing.assert_allclose(launched[r][k], jax_res[r][k],
                                       atol=1e-6, rtol=1e-5, err_msg=k)


def test_process_set_of_two_ranks_in_a_world_of_three():
    results = run_port_workers("""
        import horovod_tpu_torch
        ps = horovod_tpu_torch.add_process_set([0, 2])
        x = torch.full((4,), float(RANK + 1))
        if RANK in (0, 2):
            s = hvd.allreduce(x, op=hvd.Sum, name="ps.sum", process_set=ps)
            assert s.tolist() == [4.0] * 4, s
            g = hvd.allgather(x[:RANK + 1], name="ps.ag", process_set=ps)
            assert g.tolist() == [1.0, 3.0, 3.0, 3.0], g
            b = hvd.broadcast(x, root_rank=2, name="ps.bc", process_set=ps)
            assert b.tolist() == [3.0] * 4, b
            a = hvd.allreduce(x, op=hvd.Average, name="ps.avg",
                              process_set=ps)
            assert a.tolist() == [2.0] * 4, a
        w = hvd.allreduce(x, op=hvd.Sum, name="world.sum")
        assert w.tolist() == [6.0] * 4, w
        print("PS OK", RANK)
    """, nproc=3)
    assert_all_ok(results)
    assert all("PS OK" in out for _, out in results)


def test_hierarchical_allreduce_two_hosts_of_two():
    results = run_port_workers("""
        from horovod_tpu_torch.common import basics
        backend = basics._state().backend
        assert backend.hierarchical_active()
        # Integer-valued floats: every order of summation is exact.
        x = torch.arange(11, dtype=torch.float32) * (RANK + 1)
        s = hvd.allreduce(x, op=hvd.Sum, name="h.sum")
        assert s.tolist() == (torch.arange(11.) * 10).tolist(), s
        g = hvd.grouped_allreduce([x[:5], x[5:] * 2], op=hvd.Average,
                                  name="h.grp")
        assert g[0].tolist() == (torch.arange(5.) * 2.5).tolist(), g
        assert g[1].tolist() == (torch.arange(5., 11.) * 5).tolist(), g
        assert backend.stats["hierarchical_allreduces"] >= 2, backend.stats
        assert backend.stats["flat_allreduces"] == 0, backend.stats
        print("HIER OK", RANK)
    """, nproc=4, extra_env={"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
        per_rank_env=lambda r: {"HOROVOD_LOCAL_RANK": r % 2,
                                "HOROVOD_LOCAL_SIZE": 2,
                                "HOROVOD_CROSS_RANK": r // 2,
                                "HOROVOD_CROSS_SIZE": 2})
    assert_all_ok(results)
    assert all("HIER OK" in out for _, out in results)
