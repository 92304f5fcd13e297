"""The port's sparse embedding engine (``horovod_tpu_torch/sparse/``)
against the JAX package's (``horovod_tpu/sparse/``), on the CPU.

* In process, at size 1 (and world-4 shards built without an exchange):
  the splitmix64 init at several world sizes, lookups and updates with
  duplicate ids with dedupe on and off, ``EmbeddingBag`` sum and mean
  with empty bags, the touched sets, ``durable_items`` pickled by each
  package's ``shard_io`` (byte for byte) and a world-4 -> world-2
  reassembly: all equal the JAX engine's exactly.  ``ordered_scatter``
  equals ``np.add.at``/``np.subtract.at`` bit for bit, and torch's
  ``unique``/stable ``sort`` order ids as numpy does.
* One launch of four gloo ranks: ragged per-rank batches with duplicate
  ids over two tables, dedupe on and off, plain and overlapped lookups,
  then sum and mean bags.  Rows, tables after ``apply_gradients``,
  touched sets and ``durable_items`` bytes equal the JAX engine's serial
  replay of the same batches (rank order, as the owner applies them),
  and the three alltoall metrics count the expected ops and bytes.
* Without a card, a table with no ``device`` raises.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from horovod_tpu.checkpoint import RowDelta as JRowDelta
from horovod_tpu.checkpoint import shard_io as jshard_io
from horovod_tpu.sparse import EmbeddingBag as JBag
from horovod_tpu.sparse import ShardedEmbedding as JTable

from horovod_tpu_torch.checkpoint import shard_io as tshard_io
from horovod_tpu_torch.common import metrics as tmetrics
from horovod_tpu_torch.sparse import EmbeddingBag as TBag
from horovod_tpu_torch.sparse import ShardedEmbedding as TTable
from horovod_tpu_torch.sparse.embedding import ordered_scatter

from test_torch_port_multiproc import run_port_workers

LAUNCH_TIMEOUT_S = 180
ROWS, DIM, STEPS, LR = 64, 3, 4, 0.1
BAG_ROWS, BAG_DIM, BAG_STEPS, BAG_LR = 32, 2, 2, 0.5


def _t(name, rows, dim, rank=0, size=1, seed=0):
    return TTable(name, rows, dim, rank=rank, size=size, seed=seed,
                  device="cpu")


def _same(a, b, msg=""):
    assert a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=msg)


# The batches of both sides (the worker execs this source too).
_BATCHES = """
def batch(r, step, ti):
    # Ragged (splits vary by rank), half of the ids drawn from 3 hot ids.
    rng = np.random.default_rng([7 * r + ti, step])
    n = int(rng.integers(1, 10))
    hot = rng.integers(0, ROWS, size=3)
    ids = np.where(rng.random(n) < 0.5, rng.choice(hot, n),
                   rng.integers(0, ROWS, n)).astype(np.int64)
    g = rng.standard_normal((n, DIM)).astype(np.float32)
    return ids, g

def bag_batch(r, step):
    # 1-4 bags of 0-3 ids each (empty bags included), duplicates likely.
    rng = np.random.default_rng([100 + r, step])
    sizes = rng.integers(0, 4, size=int(rng.integers(1, 5)))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    ids = rng.integers(0, BAG_ROWS // 4, size=int(sizes.sum())).astype(
        np.int64)
    g = rng.standard_normal((len(sizes), BAG_DIM)).astype(np.float32)
    return ids, offsets, g
"""
exec(_BATCHES)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,rows,dim,seed", [
    ("tbl", 100, 4, 3), ("a-long-table-name", 37, 16, 2 ** 40 + 7),
    ("dlrm.t0", 257, 16, 7)])
@pytest.mark.parametrize("size", [1, 3, 4])
def test_init_matches_jax_at_every_world_size(name, rows, dim, seed, size):
    for r in range(size):
        want = JTable(name, rows, dim, rank=r, size=size, seed=seed)
        got = _t(name, rows, dim, r, size, seed)
        _same(got.local.numpy(), want.local, f"rank {r}")
        _same(got.local_ids, want.local_ids)


@pytest.mark.parametrize("dedupe", ["1", "0"])
def test_single_rank_lookup_and_apply_match_jax(dedupe, monkeypatch):
    monkeypatch.setenv("HOROVOD_SPARSE_DEDUPE", dedupe)
    want, got = JTable("u", 50, 3, rank=0, size=1, seed=1), \
        _t("u", 50, 3, seed=1)
    rng = np.random.default_rng(4)
    for step in range(5):
        ids = rng.choice([4, 9, 0, 17], size=12)
        g = rng.standard_normal((12, 3)).astype(np.float32)
        _same(got.lookup(ids).numpy(), want.lookup(ids), f"step {step}")
        want.apply_gradients(g, lr=0.5)
        got.apply_gradients(torch.from_numpy(g), lr=0.5)
        _same(got.local.numpy(), want.local, f"step {step}")
    _same(got.snapshot_touched(), want.snapshot_touched())
    assert got.touched_count() == want.touched_count() == 4


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_jax(mode):
    want, got = JTable("bag", 20, 2, rank=0, size=1, seed=2), \
        _t("bag", 20, 2, seed=2)
    jb, tb = JBag(want, mode=mode), TBag(got, mode=mode)
    ids = np.array([1, 3, 5, 7, 9, 7, 7])
    offsets = np.array([0, 2, 2, 5])       # [1,3], [], [5,7,9], [7,7]
    for _ in range(3):
        _same(tb.forward(ids, offsets).numpy(), jb.forward(ids, offsets))
        g = np.linspace(-1, 1, 8, dtype=np.float32).reshape(4, 2) * 3
        jb.backward(g, lr=1.0)
        tb.backward(g, lr=1.0)
        _same(got.local.numpy(), want.local)
    with pytest.raises(ValueError, match="non-decreasing"):
        tb.forward(ids, np.array([0, 3, 2]))
    with pytest.raises(RuntimeError, match="backward before forward"):
        TBag(got).backward(np.zeros((1, 2), np.float32))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_ordered_scatter_is_numpy_at(op):
    """Duplicate indices apply one after another in input order: equal
    to ``np.add.at``/``np.subtract.at`` bit for bit (a sum in another
    order would round differently)."""
    rng = np.random.default_rng(9)
    target = rng.standard_normal((7, 5)).astype(np.float32)
    index = rng.integers(0, 7, size=200)
    values = (rng.standard_normal((200, 5)) *
              10.0 ** rng.integers(-4, 4, (200, 1))).astype(np.float32)
    want = target.copy()
    (np.add if op == "add" else np.subtract).at(want, index, values)
    got = ordered_scatter(torch.from_numpy(target.copy()),
                          torch.from_numpy(index), torch.from_numpy(values),
                          op)
    _same(got.numpy(), want)
    shuffled = target.copy()
    np.add.at(shuffled, index[::-1], values[::-1])
    assert op == "sub" or not np.array_equal(shuffled, want), \
        "the inputs do not tell the order apart"


def test_unique_and_stable_sort_order_ids_as_numpy():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, size=300)
    uq, inv = np.unique(ids, return_inverse=True)
    tuq, tinv = torch.unique(torch.from_numpy(ids), sorted=True,
                             return_inverse=True)
    _same(tuq.numpy(), uq)
    _same(tinv.numpy(), inv.astype(np.int64))
    owners = uq % 4
    _same(torch.sort(torch.from_numpy(owners), stable=True).indices.numpy(),
          np.argsort(owners, kind="stable"))


def _touch(table, slots, package):
    """Mark local ``slots`` of a table touched, as an update would."""
    table._gen += 1
    if package == "jax":
        table._touch_gen[slots] = table._gen
    else:
        table._touch_gen[torch.from_numpy(slots)] = table._gen


def test_durable_items_are_byte_equal_to_jax():
    want, got = JTable("d", 40, 2, rank=0, size=1, seed=9), \
        _t("d", 40, 2, seed=9)
    ids = np.array([3, 3, 17, 5])
    g = np.arange(8, dtype=np.float32).reshape(4, 2)
    want.lookup(ids)
    want.apply_gradients(g, lr=0.25)
    got.lookup(ids)
    got.apply_gradients(g, lr=0.25)
    for full in (True, False):
        assert tshard_io.serialize_items(got.durable_items(full)) == \
            jshard_io.serialize_items(want.durable_items(full)), full
    for r in range(4):
        want = JTable("d", 40, 2, rank=r, size=4, seed=9)
        got = _t("d", 40, 2, r, 4, seed=9)
        for table, pkg in ((want, "jax"), (got, "torch")):
            _touch(table, np.array([0, 2 + r % 2]), pkg)
        for full in (True, False):
            assert tshard_io.serialize_items(got.durable_items(full)) == \
                jshard_io.serialize_items(want.durable_items(full)), \
                (r, full)


def test_resize_reassembly_matches_jax():
    """Shards written at world 4 (base, then a delta of touched rows)
    reassemble at world 2 in both packages to the same slices."""
    shards = [_t("rs", 40, 2, r, 4, seed=9) for r in range(4)]
    items = {}
    for sh in shards:
        items.update(sh.durable_items(full=True))
        sh.clear_touched()
    for sh in shards:
        slots = np.arange(0, len(sh.local_ids), 3)
        sh.local[torch.from_numpy(slots)] += 1.5
        _touch(sh, slots, "torch")
    merged = dict(items)
    for name, d in [kv for sh in shards
                    for kv in sh.durable_items(full=False).items()]:
        merged[name] = merged[name].merged_with(d)
    jmerged = {k: JRowDelta(v.rows, v.values, v.num_rows)
               for k, v in merged.items()}
    for r in range(2):
        got = _t("rs", 40, 2, r, 2)
        got.load_durable_items(merged)
        want = JTable("rs", 40, 2, rank=r, size=2)
        want.load_durable_items(jmerged)
        _same(got.local.numpy(), want.local)
        assert got.touched_count() == 0


def test_errors_match_jax():
    t = _t("v", 10, 2)
    with pytest.raises(RuntimeError, match="without a preceding"):
        t.apply_gradients(np.zeros((1, 2)))
    t.lookup(np.array([1]))
    with pytest.raises(ValueError, match="grad shape"):
        t.apply_gradients(np.zeros((2, 2)))
    with pytest.raises(ValueError, match="out of range"):
        t.lookup(np.array([10]))
    with pytest.raises(ValueError, match="out of range"):
        t.lookup(np.array([-1]))
    with pytest.raises(ValueError, match="1-D"):
        t.lookup(np.zeros((2, 2), np.int64))
    with pytest.raises(KeyError):
        t.load_durable_items({})
    from horovod_tpu_torch.checkpoint import RowDelta
    with pytest.raises(ValueError):
        t.load_durable_items({"sparse/v/rows.r00000":
                              RowDelta(np.arange(8), np.zeros((8, 2)), 8)})


def test_lookup_seconds_histogram_is_registered():
    t = _t("met", 10, 2)
    t.lookup(np.array([1]))
    assert "hvd_sparse_lookup_seconds" in tmetrics.snapshot()["histograms"]


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTable("nocard", 10, 2, rank=0, size=1)


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

_PORT_BODY = """
from horovod_tpu_torch.checkpoint.shard_io import serialize_items
from horovod_tpu_torch.common import metrics as _m
from horovod_tpu_torch.sparse import (EmbeddingBag, ShardedEmbedding,
                                      lookup_overlapped)
torch.set_num_threads(1)
globals().update(json.loads(os.environ["CONSTS"]))
exec(os.environ["BATCHES"])
res = {}
for dedupe in ("1", "0"):
    os.environ["HOROVOD_SPARSE_DEDUPE"] = dedupe
    tables = [ShardedEmbedding("d%s.t%d" % (dedupe, i), ROWS, DIM,
                               seed=5 + i, device="cpu") for i in range(2)]
    for step in range(STEPS):
        batches = [batch(RANK, step, ti) for ti in range(2)]
        if step % 2:
            outs = lookup_overlapped(tables, [b[0] for b in batches])
        else:
            outs = [t.lookup(b[0]) for t, b in zip(tables, batches)]
        for ti, (t, b) in enumerate(zip(tables, batches)):
            res["d%s_rows_%d_%d" % (dedupe, ti, step)] = outs[ti].numpy()
            t.apply_gradients(b[1], lr=LR)
    for ti, t in enumerate(tables):
        key = "d%s_%d" % (dedupe, ti)
        res[key + "_local"] = t.local.numpy()
        res[key + "_touched"] = t.local_ids[t.snapshot_touched()]
        for full in (True, False):
            res[key + "_items_%d" % full] = np.frombuffer(
                serialize_items(t.durable_items(full)), np.uint8)
os.environ["HOROVOD_SPARSE_DEDUPE"] = "1"
for mode in ("sum", "mean"):
    t = ShardedEmbedding("bag." + mode, BAG_ROWS, BAG_DIM, seed=11,
                         device="cpu")
    bag = EmbeddingBag(t, mode=mode)
    for step in range(BAG_STEPS):
        ids, offsets, g = bag_batch(RANK, step)
        res["bag_%s_%d" % (mode, step)] = bag.forward(ids, offsets).numpy()
        bag.backward(g, lr=BAG_LR)
    res["bag_%s_local" % mode] = t.local.numpy()
counters = _m.snapshot()["counters"]
for metric in ("ops", "bytes"):
    c = counters["hvd_sparse_alltoall_%s_total" % metric]
    res[metric] = np.asarray([c.get("stage=" + s, 0.0)
                              for s in ("ids", "rows", "grads")])
hvd.shutdown()
np.savez(os.environ["OUT"].replace(".npz", "-%d.npz" % RANK), **res)
"""

CONSTS = {"ROWS": ROWS, "DIM": DIM, "STEPS": STEPS, "LR": LR,
          "BAG_ROWS": BAG_ROWS, "BAG_DIM": BAG_DIM,
          "BAG_STEPS": BAG_STEPS, "BAG_LR": BAG_LR}


def _jax_replay():
    """The JAX engine at size 1 replaying every rank's batches: each
    step's rows are read before any update, then the ranks' updates land
    in rank order (the owner's order).  Returns the expected results of
    each rank and the expected metric counts."""
    want = [{} for _ in range(4)]
    ops = np.zeros(3)
    nbytes = [np.zeros(3) for _ in range(4)]
    saved = os.environ.get("HOROVOD_SPARSE_DEDUPE")
    try:
        for dedupe in ("1", "0"):
            os.environ["HOROVOD_SPARSE_DEDUPE"] = dedupe
            refs = [JTable("d%s.t%d" % (dedupe, i), ROWS, DIM, rank=0,
                           size=1, seed=5 + i) for i in range(2)]
            for step in range(STEPS):
                for ti, ref in enumerate(refs):
                    bs = [batch(r, step, ti) for r in range(4)]
                    for r, (ids, _) in enumerate(bs):
                        want[r]["d%s_rows_%d_%d" % (dedupe, ti, step)] = \
                            ref.lookup(ids)
                        sent = np.unique(ids) if dedupe == "1" else ids
                        nbytes[r] += [8 * len(sent), 0, 4 * DIM * len(sent)]
                        for o in range(4):
                            nbytes[o][1] += 4 * DIM * int(
                                (sent % 4 == o).sum())
                    for ids, g in bs:
                        ref.lookup(ids)
                        ref.apply_gradients(g, lr=LR)
                    ops += 1
            for ti, ref in enumerate(refs):
                touched = ref.local_ids[ref.snapshot_touched()]
                for r in range(4):
                    key = "d%s_%d" % (dedupe, ti)
                    want[r][key + "_local"] = ref.local[r::4]
                    mine = touched[touched % 4 == r]
                    want[r][key + "_touched"] = mine
                    shard = JTable(ref.name, ROWS, DIM, rank=r, size=4,
                                   seed=ref.seed)
                    shard.local = ref.local[r::4].copy()
                    _touch(shard, mine // 4, "jax")
                    for full in (True, False):
                        want[r][key + "_items_%d" % full] = np.frombuffer(
                            jshard_io.serialize_items(
                                shard.durable_items(full)), np.uint8)
        os.environ["HOROVOD_SPARSE_DEDUPE"] = "1"
        for mode in ("sum", "mean"):
            ref = JTable("bag." + mode, BAG_ROWS, BAG_DIM, rank=0, size=1,
                         seed=11)
            jb = JBag(ref, mode=mode)
            for step in range(BAG_STEPS):
                bs = [bag_batch(r, step) for r in range(4)]
                for r, (ids, offsets, _) in enumerate(bs):
                    want[r]["bag_%s_%d" % (mode, step)] = jb.forward(
                        ids, offsets)
                    sent = np.unique(ids)
                    nbytes[r] += [8 * len(sent), 0, 4 * BAG_DIM * len(sent)]
                    for o in range(4):
                        nbytes[o][1] += 4 * BAG_DIM * int(
                            (sent % 4 == o).sum())
                for ids, offsets, g in bs:
                    jb.forward(ids, offsets)
                    jb.backward(g, lr=BAG_LR)
                ops += 1
            for r in range(4):
                want[r]["bag_%s_local" % mode] = ref.local[r::4]
    finally:
        if saved is None:
            os.environ.pop("HOROVOD_SPARSE_DEDUPE", None)
        else:
            os.environ["HOROVOD_SPARSE_DEDUPE"] = saved
    for r in range(4):
        want[r]["ops"] = np.tile(ops[:1], 3)
        want[r]["bytes"] = nbytes[r]
    return want


@pytest.fixture(scope="module")
def four_ranks():
    want = _jax_replay()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.npz")
        results = run_port_workers(
            "import json\n" + _PORT_BODY, nproc=4,
            extra_env={"OMP_NUM_THREADS": "1", "OUT": out,
                       "CONSTS": json.dumps(CONSTS), "BATCHES": _BATCHES},
            timeout=LAUNCH_TIMEOUT_S)
        for rc, _ in results:
            assert rc == 0, "\n".join(t[-2500:] for _, t in results)
        got = []
        for r in range(4):
            with np.load(out.replace(".npz", f"-{r}.npz")) as f:
                got.append({k: f[k] for k in f.files})
    return want, got


@pytest.mark.parametrize("dedupe", ["1", "0"])
def test_four_ranks_rows_tables_and_touched_match_jax(dedupe, four_ranks):
    want, got = four_ranks
    for r in range(4):
        for ti in range(2):
            for step in range(STEPS):
                k = "d%s_rows_%d_%d" % (dedupe, ti, step)
                _same(got[r][k], want[r][k], f"{k} rank {r}")
            for part in ("local", "touched"):
                k = "d%s_%d_%s" % (dedupe, ti, part)
                _same(got[r][k], want[r][k], f"{k} rank {r}")


@pytest.mark.parametrize("dedupe", ["1", "0"])
def test_four_ranks_durable_items_byte_equal_to_jax(dedupe, four_ranks):
    want, got = four_ranks
    for r in range(4):
        for ti in range(2):
            for full in (1, 0):
                k = "d%s_%d_items_%d" % (dedupe, ti, full)
                assert got[r][k].tobytes() == want[r][k].tobytes(), \
                    f"{k} rank {r}"


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_four_ranks_bags_match_jax(mode, four_ranks):
    want, got = four_ranks
    for r in range(4):
        for k in ["bag_%s_%d" % (mode, s) for s in range(BAG_STEPS)] + \
                ["bag_%s_local" % mode]:
            _same(got[r][k], want[r][k], f"{k} rank {r}")


def test_four_ranks_alltoall_metrics_count(four_ranks):
    """``hvd_sparse_alltoall_ops_total`` counts one op per lookup and
    stage; ``_bytes_total`` the bytes each rank sent: its unique (or
    raw) ids, the rows it served, its gradient rows."""
    want, got = four_ranks
    for r in range(4):
        _same(got[r]["ops"], want[r]["ops"].astype(np.float64))
        _same(got[r]["bytes"], want[r]["bytes"].astype(np.float64),
              f"rank {r}")
