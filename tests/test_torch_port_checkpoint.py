"""The port's durable checkpoints held against the JAX package's:
``checkpoint/`` (shards, manifest, manager, delta chains, the elastic
bridge, the preemption hook), ``TorchState``'s durable protocol and the
``torch/checkpoint.py`` API.

The shards are the JAX package's format: for the same items both
packages write the same bytes, and a checkpoint written by either
package's manager restores bit-identically in the other's, for fp32,
int64, ``ObjectState`` items and ``RowDelta`` chains, and across a
N -> M -> N resize.  The manager's behaviour is held case by case
against ``tests/test_durable_checkpoint.py`` and
``tests/test_delta_checkpoint.py`` (async overlap, supersede, GC,
corruption fallback, torn writes, two-phase commit, chain bounds).  The
preemption hook runs in a subprocess, and through the port's launcher a
two-rank job preempted by SIGTERM resumes from its final commit.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.checkpoint import delta as jdelta
from horovod_tpu.checkpoint import manager as jmanager
from horovod_tpu.checkpoint import shard_io as jshard
from horovod_tpu.checkpoint.coordinator import \
    LocalCommitCoordinator as JLocal
from horovod_tpu.common.elastic import ObjectState as JObjectState

from horovod_tpu_torch.checkpoint import (CheckpointCorruptError,
                                          CheckpointManager,
                                          CheckpointNotFoundError,
                                          DurableCheckpointer,
                                          KVCommitCoordinator,
                                          LocalCommitCoordinator,
                                          RowDelta, assemble_table,
                                          install_preemption_hook)
from horovod_tpu_torch.checkpoint import manifest as mf
from horovod_tpu_torch.checkpoint import shard_io as pshard
from horovod_tpu_torch.checkpoint.preemption import uninstall
from horovod_tpu_torch.common import env as penv
from horovod_tpu_torch.common import failpoints, metrics
from horovod_tpu_torch.common.elastic import ObjectState

from test_torch_port_multiproc import launcher_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = {"manager": jmanager.CheckpointManager, "local": JLocal,
       "rowdelta": jdelta.RowDelta, "assemble": jdelta.assemble_table,
       "object_state": JObjectState}
PORT = {"manager": CheckpointManager, "local": LocalCommitCoordinator,
        "rowdelta": RowDelta, "assemble": assemble_table,
        "object_state": ObjectState}


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    failpoints.set_crash_handler(None)
    yield
    failpoints.reset()
    failpoints.set_crash_handler(None)


@pytest.fixture
def chain_max(monkeypatch):
    def set_max(n):
        monkeypatch.setenv(penv.HOROVOD_CKPT_DELTA_CHAIN_MAX, str(n))
    return set_max


def _items(scale=1.0):
    return {"obj/epoch": 7,
            "tree/w1": np.arange(64, dtype=np.float32) * scale,
            "tree/w2": np.ones((3, 5), np.float64) * scale}


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
            assert a[k].dtype == b[k].dtype, k
        elif hasattr(a[k], "rows"):
            assert type(a[k]).__name__ == type(b[k]).__name__ == \
                "RowDelta"
            assert np.array_equal(a[k].rows, b[k].rows), k
            assert np.array_equal(a[k].values, b[k].values), k
            assert a[k].values.dtype == b[k].values.dtype, k
            assert a[k].num_rows == b[k].num_rows, k
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# one format for both packages
# ---------------------------------------------------------------------------

def _kind_items(pkg, kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "fp32":
        return {"tree/w%d" % i: rng.randn(5, 7).astype(np.float32)
                for i in range(4)}
    if kind == "int64":
        return {"tree/i%d" % i: rng.randint(-1 << 40, 1 << 40, size=(9,))
                .astype(np.int64) for i in range(3)}
    if kind == "object":
        return pkg["object_state"](
            bcast_object=lambda o: o, get_rank=lambda: 0, epoch=3,
            batch=11, cursor={"order": [3, 1, 2], "lr": 0.125},
            name="run").durable_state_dict()
    rows = np.sort(rng.choice(40, 9, replace=False))
    return {"dense": np.float32(1.5),
            "sparse/t/rows.r00000": pkg["rowdelta"](
                rows, rng.randn(9, 3).astype(np.float32), 40)}


KINDS = ["fp32", "int64", "object", "rowdelta"]


@pytest.mark.parametrize("kind", KINDS)
def test_shard_bytes_equal_the_jax_package(kind):
    assert pshard.serialize_items(_kind_items(PORT, kind)) == \
        jshard.serialize_items(_kind_items(JAX, kind))


@pytest.mark.parametrize("kind", KINDS)
def test_step_files_equal_the_jax_package(tmp_path, kind):
    for name, pkg in (("jax", JAX), ("port", PORT)):
        m = pkg["manager"](str(tmp_path / name))
        m.save(4, _kind_items(pkg, kind))
        m.close()
    for fname in (mf.shard_name(0, 1), mf.MANIFEST_NAME):
        got, want = (open(os.path.join(mf.step_dir(
            str(tmp_path / n), 4), fname), "rb").read()
            for n in ("port", "jax"))
        if fname == mf.MANIFEST_NAME:
            got, want = json.loads(got), json.loads(want)
        assert got == want, fname


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_checkpoint_restores_in_the_other_package(tmp_path, kind, writer,
                                                  reader):
    m = writer["manager"](str(tmp_path))
    m.save(2, _kind_items(writer, kind, seed=1))
    m.close()
    r = reader["manager"](str(tmp_path))
    step, items = r.restore_latest()
    r.close()
    assert step == 2
    _assert_items_equal(items, _kind_items(reader, kind, seed=1))
    for v in items.values():
        if hasattr(v, "rows"):
            assert isinstance(v, reader["rowdelta"])


def _chain(pkg, directory, steps, world=1):
    """Base + deltas of a 32-row table by ``world`` thread-ranks, each
    owning the rows r, r + world, ...; returns the table per step."""
    coord = pkg["local"]()
    mgrs = [pkg["manager"](directory, rank=r, world_size=world,
                           coordinator=coord, keep=None)
            for r in range(world)]
    table = np.zeros((32, 2), np.float32)
    history = {}
    for s in range(1, steps + 1):
        touched = [(s * 3) % 32, (s * 7) % 32]
        table[touched] += np.float32(0.5 * s)
        parent = mgrs[0].delta_plan()

        def run(r):
            own = np.arange(r, 32, world)
            rows = own if parent is None else \
                np.array(sorted(set(touched) & set(own.tolist())),
                         np.int64)
            mgrs[r].save(s, {"dense": np.float32(s)}, local_items={
                "sparse/t/rows.r%05d" % r: pkg["rowdelta"](
                    rows, table[rows].copy(), 32)}, delta_of=parent)

        ts = [threading.Thread(target=run, args=(r,))
              for r in range(world)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        history[s] = table.copy()
    for m in mgrs:
        m.close(timeout=5)
    return history


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_delta_chain_restores_in_the_other_package(tmp_path, chain_max,
                                                   writer, reader, world):
    chain_max(4)
    history = _chain(writer, str(tmp_path), 5, world)
    r = reader["manager"](str(tmp_path))
    assert r.chain_of(5) == [1, 2, 3, 4, 5]
    for s, want in history.items():
        items = r.restore(s)
        tab = reader["assemble"](items, "sparse/t/rows")
        assert np.array_equal(tab, want) and tab.dtype == want.dtype
        assert items["dense"] == np.float32(s)
    r.close()


def test_delta_chains_of_both_packages_are_the_same_files(tmp_path,
                                                          chain_max):
    chain_max(4)
    _chain(JAX, str(tmp_path / "jax"), 5, 2)
    _chain(PORT, str(tmp_path / "port"), 5, 2)
    for s in range(1, 6):
        for r in range(2):
            got, want = (open(os.path.join(mf.step_dir(
                str(tmp_path / n), s), mf.shard_name(r, 2)), "rb").read()
                for n in ("port", "jax"))
            assert got == want, (s, r)


def _world(pkg, directory, world, step, items):
    coord = pkg["local"]()
    mgrs = [pkg["manager"](directory, rank=r, world_size=world,
                           coordinator=coord, commit_timeout_s=10)
            for r in range(world)]
    _parallel_save(mgrs, step, items)
    for m in mgrs:
        m.close()


@pytest.mark.parametrize("first,second", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-port-jax", "port-jax-port"])
def test_resize_n_m_n_across_packages(tmp_path, first, second):
    """N = 4 writes, M = 2 of the other package restores and rewrites,
    N = 4 of the first restores: every hop bit-identical."""
    items = {"obj/epoch": 11,
             **{"tree/layer%02d" % i:
                np.random.RandomState(i).randn(17).astype(np.float32)
                for i in range(10)},
             "tree/count": np.arange(5, dtype=np.int64)}
    d = str(tmp_path)
    _world(first, d, 4, 1, items)
    m = second["manager"](d, rank=0, world_size=2,
                          coordinator=second["local"]())
    step, restored = m.restore_latest()
    m.close()
    assert step == 1
    _assert_items_equal(restored, items)
    _world(second, d, 2, 2, restored)
    back = first["manager"](d, rank=1, world_size=4,
                            coordinator=first["local"]())
    step, final = back.restore_latest()
    back.close()
    assert step == 2 and mf.read_manifest(mf.step_dir(d, 2)).world_size \
        == 2
    _assert_items_equal(final, items)


def test_reading_a_jax_rowdelta_loads_no_jax_module(tmp_path):
    m = jmanager.CheckpointManager(str(tmp_path))
    m.save(1, _kind_items(JAX, "rowdelta"))
    m.close()
    code = ("import sys\n"
            "from horovod_tpu_torch.checkpoint import CheckpointManager\n"
            f"step, items = CheckpointManager({str(tmp_path)!r})"
            ".restore_latest()\n"
            "print(type(items['sparse/t/rows.r00000']).__module__)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'horovod_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["horovod_tpu_torch.checkpoint.delta",
                                  "[]"]


# ---------------------------------------------------------------------------
# the manager, case by case as tests/test_durable_checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip_bit_identical(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(3, _items(1.5))
    step, out = m.restore_latest()
    assert step == 3
    _assert_items_equal(out, _items(1.5))
    m.close()


def test_async_overlap_and_wait(tmp_path):
    failpoints.configure("ckpt.shard_write=delay(200ms,times=1)")
    m = CheckpointManager(str(tmp_path))
    t0 = time.perf_counter()
    m.save_async(1, _items())
    assert time.perf_counter() - t0 < 0.1
    assert m.wait(10)
    assert m.outcome(1) == "committed"
    m.close()


def test_double_buffer_supersede(tmp_path):
    failpoints.configure("ckpt.shard_write=delay(150ms,times=1)")
    m = CheckpointManager(str(tmp_path), keep=None)
    m.save_async(1, _items(1.0))
    deadline = time.monotonic() + 5.0
    while m._inflight is None and time.monotonic() < deadline:
        time.sleep(0.001)
    m.save_async(2, _items(2.0))
    m.save_async(3, _items(3.0))
    assert m.wait(10)
    assert (m.outcome(1), m.outcome(2), m.outcome(3)) == \
        ("committed", "superseded", "committed")
    assert m.committed_steps() == [1, 3]
    m.close()


def test_retention_gc_keeps_exactly_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    for s in range(1, 8):
        m.save(s, _items(float(s)))
    assert m.committed_steps() == [5, 6, 7]
    assert mf.list_step_dirs(str(tmp_path)) == [5, 6, 7]
    step, out = m.restore_latest()
    assert step == 7
    _assert_items_equal(out, _items(7.0))
    m.close()


def test_gc_reaps_abandoned_uncommitted_steps(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _items())
    failpoints.configure("ckpt.manifest_publish=error(times=1)")
    m.save_async(2, _items(2.0))
    m.wait(10)
    assert m.outcome(2) == "failed"
    failpoints.reset()
    assert 2 in mf.list_step_dirs(str(tmp_path))
    assert m.committed_steps() == [1]
    m.save(3, _items(3.0))
    assert 2 not in mf.list_step_dirs(str(tmp_path))
    m.close()


def test_corrupt_shard_falls_back_to_previous_valid(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=None)
    m.save(1, _items(1.0))
    m.save(2, _items(2.0))
    shard = glob.glob(str(tmp_path / "step-0000000002" / "shard-*.bin"))[0]
    with open(shard, "r+b") as f:
        f.seek(40)
        f.write(b"\x13\x37\x13\x37")
    before = metrics.REGISTRY.counter(
        "hvd_ckpt_restore_fallbacks_total").value()
    step, out = m.restore_latest()
    assert step == 1
    _assert_items_equal(out, _items(1.0))
    assert metrics.REGISTRY.counter(
        "hvd_ckpt_restore_fallbacks_total").value() == before + 1
    m.close()


def test_torn_write_failpoint_detected_at_restore(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=None)
    m.save(1, _items(1.0))
    failpoints.configure("ckpt.shard_write.torn=drop(times=1)")
    m.save(2, _items(2.0))
    failpoints.reset()
    step, out = m.restore_latest()
    assert step == 1
    _assert_items_equal(out, _items(1.0))
    m.close()


def test_truncated_manifest_is_not_a_checkpoint(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=None)
    m.save(1, _items(1.0))
    m.save(2, _items(2.0))
    man = str(tmp_path / "step-0000000002" / mf.MANIFEST_NAME)
    with open(man, "r+b") as f:
        f.truncate(os.path.getsize(man) // 2)
    assert m.committed_steps() == [1]
    assert m.restore_latest()[0] == 1
    m.close()


def test_crash_between_shard_write_and_manifest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=None)
    m.save(1, _items(1.0))
    failpoints.set_crash_handler(
        lambda site: (_ for _ in ()).throw(RuntimeError("died@" + site)))
    failpoints.configure("ckpt.manifest_publish=crash(times=1)")
    m.save_async(2, _items(2.0))
    m.wait(10)
    assert m.outcome(2) == "failed"
    failpoints.reset()
    sdir = str(tmp_path / "step-0000000002")
    assert glob.glob(os.path.join(sdir, "shard-*.bin"))
    assert not os.path.exists(os.path.join(sdir, mf.MANIFEST_NAME))
    assert m.restore_latest()[0] == 1
    m.close()


def test_restore_empty_dir_raises(tmp_path):
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(CheckpointNotFoundError):
        m.restore_latest()
    m.close()


def _parallel_save(mgrs, step, items, timeout=20.0):
    errs = []

    def one(m):
        try:
            m.save_async(step, items)
            m.wait(timeout)
        except Exception as e:  # pragma: no cover
            errs.append(repr(e))

    ts = [threading.Thread(target=one, args=(m,)) for m in mgrs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout + 5)
    assert not errs, errs


def test_two_phase_commit_all_ranks(tmp_path):
    coord = LocalCommitCoordinator()
    mgrs = [CheckpointManager(str(tmp_path), rank=r, world_size=3,
                              coordinator=coord, commit_timeout_s=10)
            for r in range(3)]
    items = {"obj/e": 1,
             **{"tree/p%d" % i: np.full((9,), float(i)) for i in range(7)}}
    _parallel_save(mgrs, 5, items)
    assert mgrs[0].outcome(5) == "committed"
    assert all(m.outcome(5) == "prepared" for m in mgrs[1:])
    man = mf.read_manifest(mf.step_dir(str(tmp_path), 5))
    assert man.world_size == 3 and len(man.shards) == 3
    assert coord.committed_step() == 5
    for m in mgrs:
        m.close()


def test_two_phase_never_exposes_partial_step(tmp_path):
    failpoints.set_crash_handler(
        lambda site: (_ for _ in ()).throw(RuntimeError("died@" + site)))
    failpoints.configure("ckpt.shard_write=crash(times=1,rank=2)")
    coord = LocalCommitCoordinator()
    mgrs = [CheckpointManager(str(tmp_path), rank=r, world_size=3,
                              coordinator=coord, commit_timeout_s=1.0)
            for r in range(3)]
    _parallel_save(mgrs, 1, _items(), timeout=15.0)
    assert mgrs[0].outcome(1) == "failed"
    assert mgrs[2].outcome(1) == "failed"
    assert not os.path.exists(os.path.join(
        mf.step_dir(str(tmp_path), 1), mf.MANIFEST_NAME))
    with pytest.raises(CheckpointNotFoundError):
        mgrs[0].restore_latest()
    for m in mgrs:
        m.close(timeout=1.0)


def test_kv_coordinator_over_real_rendezvous():
    from horovod_tpu_torch.runner.http_server import (RendezvousClient,
                                                      RendezvousServer)
    server = RendezvousServer(secret="")
    port = server.start()
    try:
        coord = KVCommitCoordinator(
            RendezvousClient("127.0.0.1", port, timeout=5.0, secret=""))
        coord.prepare(4, 1, {"rank": 1, "sha256": "b"})
        assert coord.gather(4, 2, timeout=0.5) is None
        coord.prepare(4, 0, {"rank": 0, "sha256": "a"})
        assert [m["rank"] for m in coord.gather(4, 2, timeout=5.0)] == \
            [0, 1]
        coord.mark_committed(4)
        assert coord.committed_step() == 4
    finally:
        server.stop()


def test_metrics_record_save_and_restore(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _items())
    m.restore_latest()
    snap = metrics.snapshot()
    save = snap["histograms"]["hvd_ckpt_save_seconds"]
    assert save["phase=capture"]["count"] >= 1
    assert save["phase=total"]["count"] >= 1
    assert snap["histograms"]["hvd_ckpt_restore_seconds"][
        "phase=total"]["count"] >= 1
    assert snap["counters"]["hvd_ckpt_commits_total"][
        "outcome=committed"] >= 1
    assert snap["counters"]["hvd_ckpt_bytes_total"]["direction=write"] > 0
    m.close()


# ---------------------------------------------------------------------------
# delta chains, case by case as tests/test_delta_checkpoint.py
# ---------------------------------------------------------------------------

def test_rowdelta_merge_overlay_and_validation():
    base = RowDelta([0, 2, 4], np.arange(6.).reshape(3, 2), 6)
    newer = RowDelta([2, 5], np.full((2, 2), 9.0), 6)
    merged = base.merged_with(newer)
    assert merged.rows.tolist() == [0, 2, 4, 5]
    np.testing.assert_array_equal(merged.values[1], [9.0, 9.0])
    np.testing.assert_array_equal(base.values[1], [2.0, 3.0])
    with pytest.raises(ValueError):
        RowDelta([0, 7], np.zeros((2, 2)), 4)
    with pytest.raises(ValueError):
        RowDelta([0], np.zeros((2, 2)), 4)
    with pytest.raises(ValueError, match="covered by no shard"):
        assemble_table({"t/rows.r0": RowDelta([0, 2], np.ones((2, 3)),
                                              4)}, "t/rows")


def test_chain_max_forces_full_base(tmp_path, chain_max):
    chain_max(2)
    _chain(PORT, str(tmp_path), 7)
    m = CheckpointManager(str(tmp_path), keep=None)
    assert [m.chain_of(s) for s in (3, 4, 6, 7)] == \
        [[1, 2, 3], [4], [4, 5, 6], [7]]
    m.close()


def test_chain_disabled_by_env_zero(tmp_path, chain_max):
    chain_max(0)
    m = CheckpointManager(str(tmp_path), keep=None)
    m.save(1, {"dense": np.float32(1.0)})
    assert m.delta_plan() is None
    m.close()


def test_corrupt_chain_link_falls_back_to_earlier_base(tmp_path,
                                                       chain_max):
    chain_max(2)
    history = _chain(PORT, str(tmp_path), 6)
    shard = os.path.join(mf.step_dir(str(tmp_path), 4), mf.shard_name(0, 1))
    with open(shard, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff")
    m = CheckpointManager(str(tmp_path), keep=None)
    for tip in (6, 5, 4):
        with pytest.raises(CheckpointCorruptError):
            m.restore(tip)
    step, items = m.restore_latest()
    assert step == 3
    np.testing.assert_array_equal(assemble_table(items, "sparse/t/rows"),
                                  history[3])
    m.close()


def test_gc_pins_chain_ancestors(tmp_path, chain_max):
    chain_max(10)
    history = _chain(PORT, str(tmp_path), 5)
    m = CheckpointManager(str(tmp_path), keep=2)
    m.gc()
    on_disk = mf.list_step_dirs(str(tmp_path))
    assert set(on_disk) == {1, 2, 3, 4, 5}, "a kept delta's chain reaped"
    step, items = m.restore_latest()
    assert step == 5
    np.testing.assert_array_equal(assemble_table(items, "sparse/t/rows"),
                                  history[5])
    m.close()


def test_delta_parent_disagreement_abandons_commit(tmp_path, chain_max):
    chain_max(4)
    coord = LocalCommitCoordinator()
    mgrs = [CheckpointManager(str(tmp_path), rank=r, world_size=2,
                              coordinator=coord, keep=None,
                              commit_timeout_s=5) for r in range(2)]
    _parallel_save(mgrs, 1, {"dense": np.float32(1.0)})
    outcomes = [None, None]

    def run(r, parent):
        try:
            outcomes[r] = mgrs[r].save(2, {"dense": np.float32(2.0)},
                                       delta_of=parent)
        except Exception as e:
            outcomes[r] = repr(e)

    ts = [threading.Thread(target=run, args=(r, p))
          for r, p in ((0, 1), (1, None))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert "committed" not in outcomes
    assert mf.committed_steps(str(tmp_path)) == [1]
    for m in mgrs:
        m.close(timeout=5)


def test_delta_parent_gone_abandons_commit(tmp_path, chain_max):
    chain_max(4)
    m = CheckpointManager(str(tmp_path), keep=None)
    m.save(1, {"dense": np.float32(1.0)})
    with pytest.raises(Exception):
        m.save(2, {"dense": np.float32(2.0)}, delta_of=99)
    assert mf.committed_steps(str(tmp_path)) == [1]
    m.close()


# ---------------------------------------------------------------------------
# the elastic bridge and the preemption hook
# ---------------------------------------------------------------------------

def _object_state(**kwargs):
    return ObjectState(bcast_object=lambda o: o, get_rank=lambda: 0,
                       **kwargs)


def test_durable_checkpointer_restart_cycle(tmp_path):
    s = _object_state(epoch=0, w=np.zeros(4))
    ck = DurableCheckpointer(s, str(tmp_path), every_n_commits=2)
    assert ck.maybe_restore() is None
    for i in range(5):
        s.epoch = i
        s.w = np.full(4, float(i))
        s.save()
        ck.commit()
    assert ck.wait(10)
    ck.close()
    s2 = _object_state(epoch=-1, w=np.ones(4))
    ck2 = DurableCheckpointer(s2, str(tmp_path))
    assert ck2.maybe_restore() == 2
    assert s2.epoch == 4 and np.array_equal(s2.w, np.full(4, 4.0))
    s2.epoch = 99
    s2.restore()
    assert s2.epoch == 4
    ck2.close()


def test_durable_checkpointer_resize_rebuilds_manager(tmp_path):
    world = {"n": 1}
    coords = {1: LocalCommitCoordinator(), 2: LocalCommitCoordinator()}
    s = _object_state(epoch=0)
    ck = DurableCheckpointer(
        s, str(tmp_path), rank=0, world_size=lambda: world["n"],
        coordinator_factory=lambda: coords[world["n"]])
    s.save()
    ck.commit()
    assert ck.wait(10)
    assert mf.read_manifest(mf.step_dir(str(tmp_path), 0)).world_size == 1
    world["n"] = 2
    peer = DurableCheckpointer(_object_state(epoch=0), str(tmp_path),
                               rank=1, world_size=2, coordinator=coords[2])
    s.epoch = 1
    s.save()
    t = threading.Thread(target=lambda: (peer.state.save(),
                                         peer.commit(step=1),
                                         peer.wait(10)))
    t.start()
    ck.commit(step=1)
    assert ck.wait(15)
    t.join(15)
    assert mf.read_manifest(mf.step_dir(str(tmp_path), 1)).world_size == 2
    ck.close()
    peer.close()


def test_env_contract_builds_the_checkpointer(tmp_path, monkeypatch):
    from horovod_tpu_torch.checkpoint.elastic import from_env
    s = _object_state(epoch=0)
    monkeypatch.delenv("HOROVOD_CHECKPOINT_DIR", raising=False)
    assert from_env(s) is None
    monkeypatch.setenv("HOROVOD_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_CHECKPOINT_KEEP", "0")
    monkeypatch.setenv("HOROVOD_CHECKPOINT_EVERY", "3")
    ck = from_env(s)
    assert (ck.directory, ck.keep, ck.every_n_commits) == \
        (str(tmp_path), 0, 3)


def test_preemption_hook_final_commit(tmp_path):
    s = _object_state(epoch=0)
    ck = DurableCheckpointer(s, str(tmp_path))
    s.epoch = 41
    s.save()
    ck.commit()
    assert ck.wait(10)
    s.epoch = 42
    s.save()
    prev = install_preemption_hook(ck, signals=(signal.SIGUSR1,),
                                   grace_s=10.0, chain=False)
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
    finally:
        uninstall(prev)
    ck.close()
    s2 = _object_state(epoch=0)
    ck2 = DurableCheckpointer(s2, str(tmp_path))
    ck2.maybe_restore()
    assert s2.epoch == 42
    ck2.close()


# A process that commits epoch 41 durably and 42 in memory, installs the
# hook, makes its final commit slow (a failpoint delays the shard write)
# and gets a second SIGTERM while the commit runs, as a launcher passing
# a preemption on to its workers sends.
_TWO_SIGNALS = """
import os, signal, sys, threading, time
import numpy as np
from {pkg}.checkpoint import DurableCheckpointer, install_preemption_hook
from {pkg}.common import failpoints
from {pkg}.common.elastic import ObjectState
s = ObjectState(bcast_object=lambda o: o, get_rank=lambda: 0, epoch=41)
ck = DurableCheckpointer(s, sys.argv[1])
s.save(); ck.commit(); ck.wait(10)
s.epoch = 42; s.save()
failpoints.configure("ckpt.shard_write=delay(1500ms,times=1)")
install_preemption_hook(ck, grace_s=10.0)
threading.Timer(0.5, os.kill, (os.getpid(), signal.SIGTERM)).start()
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)
"""


@pytest.mark.parametrize("pkg,final_lands", [("horovod_tpu_torch", True),
                                             ("horovod_tpu", False)])
def test_second_sigterm_during_the_final_commit(tmp_path, pkg,
                                                final_lands):
    """The port's hook ignores a second signal during its final commit
    and then dies of the first; the JAX package's hook dies of the
    second one before its final commit lands (CHANGES.md)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c",
                          _TWO_SIGNALS.format(pkg=pkg), str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == -signal.SIGTERM, out.stderr
    s2 = _object_state(epoch=0)
    ck2 = DurableCheckpointer(s2, str(tmp_path))
    ck2.maybe_restore()
    ck2.close()
    assert s2.epoch == (42 if final_lands else 41)


# ---------------------------------------------------------------------------
# TorchState's durable protocol
# ---------------------------------------------------------------------------

def _torch_state(seed, epoch):
    from horovod_tpu_torch.torch.elastic import TorchState
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.LayerNorm(6),
                                torch.nn.Linear(6, 2))
    opt = torch.optim.AdamW(model.parameters(), lr=0.01)
    return TorchState(model, opt, epoch=epoch), model, opt


def _train(model, opt, steps, seed):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        opt.zero_grad()
        x = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
        model(x).square().mean().backward()
        opt.step()


def test_torch_state_durable_items_are_host_numpy():
    state, model, opt = _torch_state(0, epoch=5)
    _train(model, opt, 2, 1)
    state.save()
    d = state.durable_state_dict()
    assert d["obj/epoch"] == 5
    for name, p in model.state_dict().items():
        assert np.array_equal(d["torch/arg.0/" + name], p.numpy())
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            got = d[f"torch/arg.1/state/{i}/{k}"]
            assert isinstance(got, np.ndarray)
            assert np.array_equal(got, v.numpy())
    assert d["torch/arg.1/param_groups"][0]["lr"] == 0.01


def test_torch_state_restores_through_the_manager(tmp_path):
    state, model, opt = _torch_state(0, epoch=5)
    _train(model, opt, 3, 1)
    state.save()
    ck = DurableCheckpointer(state, str(tmp_path))
    ck.commit()
    assert ck.wait(10)
    ck.close()
    state2, model2, opt2 = _torch_state(9, epoch=0)
    ck2 = DurableCheckpointer(state2, str(tmp_path))
    assert ck2.maybe_restore() == 0
    ck2.close()
    assert state2.epoch == 5
    for a, b in zip(model.state_dict().values(),
                    model2.state_dict().values()):
        assert torch.equal(a, b)
    # The restored optimizer steps exactly as the original does.
    _train(model, opt, 2, 7)
    _train(model2, opt2, 2, 7)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    # restore() returns to the loaded snapshot.
    state2.restore()
    assert state2.epoch == 5


def test_torch_state_refuses_bfloat16():
    from horovod_tpu_torch.torch.elastic import TorchState
    state = TorchState(torch.nn.Linear(2, 2).to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        state.durable_state_dict()


# ---------------------------------------------------------------------------
# torch/checkpoint.py: the API of horovod_tpu.jax.checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def tckpt():
    import horovod_tpu_torch.torch.checkpoint as ckpt
    yield ckpt
    ckpt.close()


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"w": torch.from_numpy(
        rng.rand(8, 4).astype(np.float32))},
        "opt": {"m": torch.from_numpy(rng.rand(8).astype(np.float32))},
        "step": torch.tensor(seed, dtype=torch.int32),
        "host": [np.arange(3, dtype=np.int64) + seed, seed]}


def _zeros_like(tree):
    return {"params": {"w": torch.zeros(8, 4)}, "opt": {"m": torch.zeros(8)},
            "step": torch.tensor(0, dtype=torch.int32),
            "host": [np.zeros(3, np.int64), 0]}


def test_save_restore_roundtrip(tmp_path, tckpt):
    state = _tree(3)
    tckpt.save(str(tmp_path), state, step=3)
    assert tckpt.latest_step(str(tmp_path)) == 3
    restored = tckpt.restore(str(tmp_path), _zeros_like(state))
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert torch.equal(restored["opt"]["m"], state["opt"]["m"])
    assert restored["step"].dtype == torch.int32
    assert int(restored["step"]) == 3
    assert np.array_equal(restored["host"][0], state["host"][0])
    assert restored["host"][1] == 3


def test_keep_n_retention_and_latest(tmp_path, tckpt):
    for step in range(5):
        tckpt.save(str(tmp_path), _tree(step), step=step, keep=2)
    assert tckpt.latest_step(str(tmp_path)) == 4
    with pytest.raises(Exception):
        tckpt.restore(str(tmp_path), _zeros_like(None), step=0)
    assert int(tckpt.restore(str(tmp_path), _zeros_like(None),
                             step=4)["step"]) == 4


def test_keep_applies_after_latest_step_probe(tmp_path, tckpt):
    assert tckpt.latest_step(str(tmp_path)) is None
    for step in range(4):
        tckpt.save(str(tmp_path), _tree(step), step=step, keep=2,
                   block=False)
        tckpt.wait(str(tmp_path))
    assert tckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(Exception):
        tckpt.restore(str(tmp_path), _zeros_like(None), step=0)
    assert int(tckpt.restore(str(tmp_path), _zeros_like(None),
                             step=3)["step"]) == 3


def test_latest_step_empty_dir(tmp_path, tckpt):
    assert tckpt.latest_step(str(tmp_path / "nothing_here")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "nothing_here"), {})


_MULTI = """
import numpy as np
import torch
import horovod_tpu_torch.torch as hvd
import horovod_tpu_torch.torch.checkpoint as ckpt
hvd.init()
RANK = hvd.rank()
d = os.environ["CKPT_DIR"]
state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
         "m": [torch.full((5,), 2.5), np.arange(4, dtype=np.int64)],
         "step": torch.tensor(7)}
ckpt.save(d, state, step=7)
assert ckpt.latest_step(d) == 7
template = {"w": torch.zeros(3, 4), "m": [torch.zeros(5),
                                          np.zeros(4, np.int64)],
            "step": torch.tensor(0)}
got = ckpt.restore(d, template)
assert torch.equal(got["w"], state["w"]) and int(got["step"]) == 7
assert torch.equal(got["m"][0], state["m"][0])
assert np.array_equal(got["m"][1], state["m"][1])
# Every rank wrote its part of the round-robin partition.
import json
man = json.load(open(os.path.join(d, "step-%010d" % 7, "MANIFEST.json")))
assert man["world_size"] == 2 and len(man["shards"]) == 2
# Rank-divergent leaves must raise, not keep one rank's value.
err = None
try:
    ckpt.save(d + "_bad", {"cursor": torch.tensor(RANK)}, step=1)
except ValueError as e:
    err = e
assert err is not None and "differ across processes" in str(err), err
ckpt.close()
print("CKPT-MULTI OK", RANK)
hvd.shutdown()
"""


def test_multiprocess_save_restore_through_the_launcher(tmp_path):
    """``torch/checkpoint.py`` at two ranks: every rank writes its shard,
    rank 0 commits through the launcher's KV, both restore the step, and
    rank-divergent leaves raise (the multi-process case of
    tests/test_checkpoint.py)."""
    from test_torch_port_multiproc import run_port_launcher
    script = tmp_path / "multi.py"
    script.write_text("import os\n" + _MULTI)
    rc, out = run_port_launcher(
        ["-np", "2", "-H", "localhost:2", sys.executable, str(script)],
        launcher_env({"CKPT_DIR": str(tmp_path / "ck")}))
    assert rc == 0, out[-4000:]
    assert out.count("CKPT-MULTI OK") == 2, out[-4000:]


# ---------------------------------------------------------------------------
# through the port's launcher: a 2-rank job preempted and resumed
# ---------------------------------------------------------------------------

_PREEMPTED = """
import hashlib, json, os, sys, time
import numpy as np
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.checkpoint import install_preemption_hook
from horovod_tpu_torch.torch.elastic import TorchState, durable_checkpointer
import horovod_tpu_torch.torch.checkpoint as tckpt
hvd.init()
RANK = hvd.rank()
torch.manual_seed(0)
torch.set_num_threads(1)
model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                            torch.nn.Linear(16, 2))
opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=0.01),
                               named_parameters=model.named_parameters())
state = TorchState(model, opt, step=0)
ckpt = durable_checkpointer(state, every_n_commits=2, keep=2)
restored = ckpt.maybe_restore()

def digest():
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(v.numpy().tobytes())
    for i, st in sorted(opt.state_dict()["state"].items()):
        for k, v in sorted(st.items()):
            h.update(v.numpy().tobytes())
    return h.hexdigest()

def report(**fields):
    path = os.path.join(os.environ["CKPT_REPORT"],
                        "rank%d.jsonl" % RANK)
    with open(path, "a") as f:
        f.write(json.dumps(dict(fields, rank=RANK)) + "\\n")

report(event="start", restored=restored, step=state.step, sha=digest())

class Final:
    # The hook's checkpointer: the final commit, then a report of it.
    def finalize(self, timeout=None, reason="shutdown"):
        t0 = time.perf_counter()
        step = ckpt.finalize(timeout=timeout, reason=reason)
        report(event="final", id=step, sha=committed[0],
               seconds=time.perf_counter() - t0)
        return step

committed = [digest()]
install_preemption_hook(Final(), grace_s=20.0)
rng = np.random.RandomState(10 + RANK)
steps = int(os.environ["CKPT_STEPS"])
for _ in range(steps):
    opt.zero_grad()
    model(torch.from_numpy(rng.randn(4, 8).astype(np.float32))) \\
        .square().mean().backward()
    opt.step()
    state.step += 1
    state.commit()
    committed[0] = digest()
    sid = ckpt.commit()
    if sid is not None:
        ckpt.wait(30)
        report(event="durable", id=sid, step=state.step, sha=committed[0])
report(event="done", step=state.step)
if os.environ.get("CKPT_HOLD"):
    time.sleep(120)
hvd.shutdown()
"""


def _read_reports(d):
    out = {}
    for r in (0, 1):
        path = os.path.join(d, "rank%d.jsonl" % r)
        out[r] = [json.loads(line) for line in open(path)] \
            if os.path.exists(path) else []
    return out


def test_launcher_preemption_final_commit_resumes(tmp_path):
    """A 2-rank job through the port's launcher with
    ``HOROVOD_CHECKPOINT_DIR``: after its durable commits the launcher
    gets SIGTERM and passes it on to its workers' trees, the hook's
    final commit lands, and a relaunch resumes from it with the same
    parameters and optimizer state on both ranks."""
    from horovod_tpu_torch.runner.safe_shell_exec import \
        terminate_process_tree
    script = tmp_path / "train.py"
    script.write_text(_PREEMPTED)
    ckdir = tmp_path / "ckpt"
    env = launcher_env({"HOROVOD_CHECKPOINT_DIR": str(ckdir),
                        "CKPT_STEPS": "5", "CKPT_HOLD": "1"})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           "2", "-H", "localhost:2", sys.executable, str(script)]
    a_dir = tmp_path / "a"
    a_dir.mkdir()
    env["CKPT_REPORT"] = str(a_dir)
    p = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        rep = _read_reports(str(a_dir))
        if all(any(e["event"] == "done" for e in rep[r]) for r in (0, 1)):
            break
        assert p.poll() is None, p.communicate()[0].decode()[-4000:]
        time.sleep(0.2)
    # A scheduler's preemption: SIGTERM to the launcher, which passes it
    # on to every worker's tree and serves the KV until they exit.
    t0 = time.monotonic()
    p.send_signal(signal.SIGTERM)
    try:
        out = p.communicate(timeout=60)[0].decode()
    finally:
        terminate_process_tree(p.pid, grace_s=1.0)
    assert p.returncode == -signal.SIGTERM, out[-4000:]
    assert time.monotonic() - t0 < 20
    rep = _read_reports(str(a_dir))
    finals = {r: [e for e in rep[r] if e["event"] == "final"]
              for r in (0, 1)}
    assert all(len(finals[r]) == 1 for r in (0, 1)), (finals, out[-4000:])
    final_id = finals[0][0]["id"]
    assert final_id is not None and finals[1][0]["id"] == final_id
    durable = [e["id"] for e in rep[0] if e["event"] == "durable"]
    assert durable == [0, 1, 2] and final_id == 3, (durable, final_id)

    b_dir = tmp_path / "b"
    b_dir.mkdir()
    env.update(CKPT_REPORT=str(b_dir), CKPT_STEPS="2", CKPT_HOLD="")
    out = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-4000:]
    rep = _read_reports(str(b_dir))
    for r in (0, 1):
        start = rep[r][0]
        assert start["restored"] == final_id
        assert start["step"] == 5
        assert start["sha"] == finals[r][0]["sha"] == finals[0][0]["sha"]
        assert rep[r][-1] == {"event": "done", "step": 7, "rank": r}
