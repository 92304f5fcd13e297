"""The port's serving plane (``horovod_tpu_torch/serve/``) against the JAX
package's (``horovod_tpu/serve/``), on the CPU.

* On one checkpoint directory (the closed-form trainer of
  ``tests/test_serve.py``: a 32x4 table, a base then row deltas), the
  port's replica bootstraps, tails and answers lookups and bags (sum and
  mean, empty bags) exactly as the JAX replica does, step stamps and
  freshness included.
* Across packages: a DLRM-shaped pair of ``ShardedEmbedding`` tables at
  two ranks commits a base and deltas through one package's
  ``CheckpointManager`` and is served by the other package's replica;
  every served row equals the writer's table at the served step.
* The torn-apply failpoint (``serve.delta_apply`` error and drop), the
  staleness bound (``StalenessError``, ``hvd_serve_rejects_total``),
  HTTP 503 on staleness, the job-secret HMAC contract (403 unsigned,
  200 signed, 404 bare) and a concurrent train-commit-serve smoke, as
  the JAX package's tests hold its replica.
* Without a card, a replica or ``serve.start`` with no ``device``
  raises.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.checkpoint import CheckpointManager as JManager
from horovod_tpu.checkpoint import LocalCommitCoordinator as JCoord
from horovod_tpu.checkpoint import RowDelta as JRowDelta
from horovod_tpu.serve import ServingReplica as JReplica
from horovod_tpu.sparse import ShardedEmbedding as JTable

import horovod_tpu_torch.serve as tserve
from horovod_tpu_torch.checkpoint import CheckpointManager as TManager
from horovod_tpu_torch.checkpoint import LocalCommitCoordinator as TCoord
from horovod_tpu_torch.common import env as tenv
from horovod_tpu_torch.common import failpoints, metrics
from horovod_tpu_torch.runner import job_secret
from horovod_tpu_torch.serve import (ServeServer, ServingReplica,
                                     StalenessError)
from horovod_tpu_torch.sparse import ShardedEmbedding as TTable


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    failpoints.set_crash_handler(None)
    yield
    failpoints.reset()
    failpoints.set_crash_handler(None)


def _rep(directory):
    return ServingReplica(str(directory), device="cpu")


# ---------------------------------------------------------------------------
# The closed-form trainer of tests/test_serve.py.
# ---------------------------------------------------------------------------

_ROWS, _DIM = 32, 4
_ITEM = "sparse/tbl/rows.r00000"


def _base_table():
    return (np.arange(_ROWS * _DIM, dtype=np.float32)
            .reshape(_ROWS, _DIM) * 0.01)


def _touched(step):
    return np.unique((np.arange(6) * 5 + step * 3) % _ROWS)


def _update(step, rows):
    vals = np.repeat(rows.astype(np.float32)[:, None], _DIM, axis=1)
    return vals + step / 100.0


def _table_at(step):
    t = _base_table()
    for s in range(2, step + 1):
        r = _touched(s)
        t[r] = _update(s, r)
    return t


def _commit(mgr, step, row_delta=JRowDelta):
    if step == 1:
        item = row_delta(np.arange(_ROWS), _base_table(), _ROWS)
        mgr.save(1, {"dense/x": np.float32(1)},
                 local_items={_ITEM: item})
    else:
        r = _touched(step)
        item = row_delta(r, _update(step, r), _ROWS)
        mgr.save(step, {"dense/x": np.float32(step)},
                 local_items={_ITEM: item}, delta_of=mgr.delta_plan())


@pytest.fixture
def mgr(tmp_path):
    m = JManager(str(tmp_path), keep=None)
    yield m
    m.close()


def _same(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)


def test_bootstrap_tail_lookup_and_bag_match_the_jax_replica(tmp_path, mgr):
    _commit(mgr, 1)
    got, want = _rep(tmp_path), JReplica(str(tmp_path))
    assert got.bootstrap() == want.bootstrap() == 1
    assert got.table_names() == want.table_names() == ["tbl"]
    _commit(mgr, 2)
    _commit(mgr, 3)
    assert got.poll_once() == want.poll_once() == 2
    assert got.freshness() == want.freshness() == (3, 3)
    assert metrics.REGISTRY.gauge(
        "hvd_serve_freshness_steps").value() == 0.0
    for ids in (np.array([0, 5, _touched(3)[0], 31]), np.arange(_ROWS),
                [7, 7, -1], np.zeros(0, np.int64)):
        (g, gs), (w, ws) = got.lookup("tbl", ids), want.lookup("tbl", ids)
        assert gs == ws == 3
        _same(g, w, str(ids))
        _same(g, _table_at(3)[ids])
    ids = np.array([1, 2, 7, 7, 9, 30, 3])
    offsets = np.array([0, 2, 2, 4, 4])     # examples 1 and 3 are empty
    for mode in ("sum", "mean"):
        (g, gs), (w, ws) = (r.embedding_bag("tbl", ids, offsets, mode=mode)
                            for r in (got, want))
        assert gs == ws == 3
        _same(g, w, mode)
    for exc, args in ((KeyError, ("nope", [0])),
                      (IndexError, ("tbl", [_ROWS + 7])),
                      (IndexError, ("tbl", [-_ROWS - 1]))):
        for r in (got, want):
            with pytest.raises(exc):
                r.lookup(*args)
    for r in (got, want):
        with pytest.raises(ValueError, match="mode"):
            r.embedding_bag("tbl", ids, offsets, mode="max")
        with pytest.raises(ValueError, match="non-decreasing"):
            r.embedding_bag("tbl", ids, [0, 3, 2])


def test_serve_rows_counter_attributes_base_and_delta(tmp_path, mgr):
    _commit(mgr, 1)
    rep = _rep(tmp_path)
    rep.bootstrap()
    _commit(mgr, 2)
    rep.poll_once()
    rows = metrics.REGISTRY.counter("hvd_serve_rows_total")
    base0, delta0 = rows.value(source="base"), rows.value(source="delta")
    ids = np.array([_touched(2)[0], _touched(2)[1], 1])
    assert 1 not in _touched(2)
    rep.lookup("tbl", ids)
    assert rows.value(source="delta") == delta0 + 2
    assert rows.value(source="base") == base0 + 1


# ---------------------------------------------------------------------------
# across packages: DLRM-shaped tables at two ranks
# ---------------------------------------------------------------------------

def _two_rank_commits(directory, package, steps=4):
    """Two ranks' tables (``dlrm.t0`` and ``dlrm.t1``) of one package,
    committed by that package's managers: a base at step 1, then deltas
    of the rows each step moved.  Returns {step: {table: full table}}."""
    Table, Manager = (JTable, JManager) if package == "jax" else \
        (TTable, TManager)
    kw = {} if package == "jax" else {"device": "cpu"}
    coord = (JCoord if package == "jax" else TCoord)()
    mgrs = [Manager(str(directory), rank=r, world_size=2, coordinator=coord,
                    keep=None) for r in range(2)]
    tables = [[Table("dlrm.t%d" % i, 48, 4, rank=r, size=2, seed=7 + i, **kw)
               for i in range(2)] for r in range(2)]
    committed = {}
    rng = np.random.default_rng(8)
    for step in range(1, steps + 1):
        if step > 1:
            for r in range(2):
                for t in tables[r]:
                    slots = rng.choice(len(t.local_ids), 3, replace=False)
                    if package == "jax":
                        t.local[slots] += 0.5
                        t._gen += 1
                        t._touch_gen[slots] = t._gen
                    else:
                        s = torch.from_numpy(slots)
                        t.local[s] += 0.5
                        t._gen += 1
                        t._touch_gen[s] = t._gen
        plan = None if step == 1 else mgrs[0].delta_plan()
        threads = []
        for r in range(2):
            items = {}
            for t in tables[r]:
                items.update(t.durable_items(full=plan is None))
            threads.append(threading.Thread(
                target=mgrs[r].save,
                args=(step, {"dense/step": np.int64(step)}),
                kwargs={"local_items": items, "delta_of": plan}))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        for r in range(2):
            for t in tables[r]:
                t.clear_touched()
        full = {}
        for i in range(2):
            table = np.zeros((48, 4), np.float32)
            for r in range(2):
                local = tables[r][i].local
                table[r::2] = local if package == "jax" else local.numpy()
            full["dlrm.t%d" % i] = table
        committed[step] = full
    for m in mgrs:
        m.close()
    return committed


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_serves_the_other_packages_commits(tmp_path, writer):
    committed = _two_rank_commits(tmp_path, writer)
    reader = _rep(tmp_path) if writer == "jax" else JReplica(str(tmp_path))
    assert reader.bootstrap() == 4
    assert reader.table_names() == ["dlrm.t0", "dlrm.t1"]
    ids = np.arange(48)
    for name, table in committed[4].items():
        rows, step = reader.lookup(name, ids)
        assert step == 4
        _same(rows, table, name)
    # A replica that starts at the base tails every delta.
    other = _rep(tmp_path) if writer == "jax" else JReplica(str(tmp_path))
    other._mgr.restore_latest = lambda: (1, other._mgr.restore(1))
    assert other.bootstrap() == 1
    _same(other.lookup("dlrm.t0", ids)[0], committed[1]["dlrm.t0"])
    assert other.poll_once() == 3
    for name, table in committed[4].items():
        _same(other.lookup(name, ids)[0], table, name)


# ---------------------------------------------------------------------------
# the consistency contract
# ---------------------------------------------------------------------------

def test_torn_apply_structurally_impossible(tmp_path, mgr):
    _commit(mgr, 1)
    rep = _rep(tmp_path)
    rep.bootstrap()
    _commit(mgr, 2)
    failpoints.configure("serve.delta_apply=error(torn,times=1)")
    assert rep.poll_once() == 0
    rows, step = rep.lookup("tbl", np.arange(_ROWS))
    assert step == 1
    _same(rows, _table_at(1))
    assert rep.freshness() == (1, 2)
    failpoints.reset()
    failpoints.configure("serve.delta_apply=drop(1)")
    assert rep.poll_once() == 0
    rows, step = rep.lookup("tbl", np.arange(_ROWS))
    assert step == 1
    _same(rows, _table_at(1))
    failpoints.reset()
    assert rep.poll_once() == 1
    rows, step = rep.lookup("tbl", np.arange(_ROWS))
    assert step == 2
    _same(rows, _table_at(2))


def test_staleness_bound_rejects_reads(tmp_path, mgr, monkeypatch):
    _commit(mgr, 1)
    rep = _rep(tmp_path)
    rep.bootstrap()
    for s in (2, 3, 4):
        _commit(mgr, s)
    monkeypatch.setenv(tenv.HOROVOD_SERVE_MAX_STALENESS_STEPS, "1")
    failpoints.configure("serve.delta_apply=drop(10)")
    rep.poll_once()
    before = metrics.REGISTRY.counter(
        "hvd_serve_rejects_total").value(reason="staleness")
    with pytest.raises(StalenessError):
        rep.lookup("tbl", [0])
    assert metrics.REGISTRY.counter("hvd_serve_rejects_total").value(
        reason="staleness") == before + 1
    failpoints.reset()
    rep.poll_once()
    rows, step = rep.lookup("tbl", [0, 1])
    assert step == 4
    _same(rows, _table_at(4)[[0, 1]])


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read().decode())


def _signed(secret, method, path, body):
    ts = repr(time.time())
    return {job_secret.TS_HEADER: ts,
            job_secret.HEADER: job_secret.sign(secret, method, path, body,
                                               ts)}


def test_http_lookup_auth_parity_and_freshness(tmp_path, mgr):
    _commit(mgr, 1)
    _commit(mgr, 2)
    rep = _rep(tmp_path)
    rep.bootstrap()
    secret = job_secret.make_secret_key()
    srv = ServeServer(rep, port=0, secret=secret)
    try:
        url = "http://127.0.0.1:%d/lookup" % srv.port
        body = json.dumps({"table": "tbl", "ids": [0, 3, 31]}).encode()
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url, body)
        assert exc.value.code == 403
        out = _post(url, body, _signed(secret, "POST", "/lookup", body))
        assert out["step"] == 2 and out["table"] == "tbl"
        _same(np.asarray(out["rows"], np.float32), _table_at(2)[[0, 3, 31]])
        body = json.dumps({"table": "tbl", "ids": [1, 2],
                           "offsets": [0], "mode": "sum"}).encode()
        out = _post(url, body, _signed(secret, "POST", "/lookup", body))
        t = _table_at(2)
        _same(np.asarray(out["rows"], np.float32), (t[1] + t[2])[None, :])
        for bad, code in (({"table": "nope", "ids": [0]}, 404),
                          ({"table": "tbl", "ids": [99]}, 400),
                          ({"ids": [0]}, 400)):
            body = json.dumps(bad).encode()
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(url, body, _signed(secret, "POST", "/lookup", body))
            assert exc.value.code == code, bad
        furl = "http://127.0.0.1:%d/freshness" % srv.port
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(furl, timeout=10)
        assert exc.value.code == 403
        req = urllib.request.Request(
            furl, headers=_signed(secret, "GET", "/freshness", b""))
        with urllib.request.urlopen(req, timeout=10) as r:
            fresh = json.loads(r.read().decode())
        assert fresh == {"served_step": 2, "latest_step": 2,
                         "tables": ["tbl"]}
    finally:
        srv.stop()
    bare = ServeServer(None, port=0, secret="")
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post("http://127.0.0.1:%d/lookup" % bare.port,
                  json.dumps({"table": "tbl", "ids": [0]}).encode())
        assert exc.value.code == 404
    finally:
        bare.stop()


def test_http_staleness_maps_to_503(tmp_path, mgr, monkeypatch):
    _commit(mgr, 1)
    rep = _rep(tmp_path)
    rep.bootstrap()
    for s in (2, 3):
        _commit(mgr, s)
    monkeypatch.setenv(tenv.HOROVOD_SERVE_MAX_STALENESS_STEPS, "1")
    failpoints.configure("serve.delta_apply=drop(10)")
    rep.poll_once()
    srv = ServeServer(rep, port=0, secret="")
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post("http://127.0.0.1:%d/lookup" % srv.port,
                  json.dumps({"table": "tbl", "ids": [0]}).encode())
        assert exc.value.code == 503
    finally:
        srv.stop()


def test_train_commit_serve_verify_smoke(tmp_path, monkeypatch):
    """A trainer thread commits a delta chain (the port's manager) while
    the port's tail thread follows; every concurrent read equals the
    closed-form table at its own step stamp."""
    monkeypatch.setenv(tenv.HOROVOD_SERVE_POLL_SECONDS, "0.02")
    from horovod_tpu_torch.checkpoint import RowDelta
    m = TManager(str(tmp_path), keep=None)
    _commit(m, 1, RowDelta)
    plane = tserve.start(str(tmp_path), http=False, device="cpu")
    stop = threading.Event()
    errs = []

    def trainer():
        try:
            for s in range(2, 9):
                _commit(m, s, RowDelta)
                time.sleep(0.03)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=trainer)
    t.start()
    reads = 0
    try:
        while not stop.is_set() or reads == 0:
            ids = np.array([0, 3, 17, 31])
            rows, step = plane.replica.lookup("tbl", ids)
            _same(rows, _table_at(step)[ids], f"step {step}")
            reads += 1
            time.sleep(0.005)
        t.join(timeout=60)
        assert not t.is_alive() and not errs, errs
        deadline = time.monotonic() + 10.0
        while (plane.replica.freshness()[0] < 8
               and time.monotonic() < deadline):
            time.sleep(0.02)
        rows, step = plane.replica.lookup("tbl", np.arange(_ROWS))
        assert step == 8
        _same(rows, _table_at(8))
    finally:
        plane.stop()
        m.close()


def test_no_card_and_no_device_raises(tmp_path, mgr, monkeypatch):
    _commit(mgr, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingReplica(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.start(str(tmp_path), http=False)
