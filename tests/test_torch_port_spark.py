"""The port's ``spark/`` against the JAX package's, on the CPU.

* Params, data preparation (shards, metadata, streaming, step counts,
  validation splits) and the Store: the same answers from one DataFrame,
  and each package reads the other's shards.
* ``TorchEstimator`` at two ranks on ``LocalBackend`` (``device="cpu"``
  in the port) against the JAX ``TorchEstimator`` on the same DataFrame,
  model and optimizer: per-epoch history and final ``state_dict`` at atol
  1e-6, ``transform`` and ``_output_ranks``, and a resume to epoch 5 in
  each direction (each package resumes the other's Store checkpoint),
  both equal to a serial replay of the uninterrupted run.  The two
  packages' fits run side by side.
* ``KerasEstimator`` at two ranks on ``LocalBackend`` (``device="cpu"``
  in the port; the JAX package's workers also on Keras's torch backend)
  against the JAX ``KerasEstimator`` on the same DataFrame and model
  (``tests/test_spark_estimator.py::
  test_keras_estimator_fit_transform_resume``): per-epoch losses,
  ``transform`` and the resume from epoch 2 to 4 (each package resumes
  the other's Store checkpoint) are equal.  Without a card and with
  ``device=None`` it raises before writing any data.
* The in-process ``memory://`` case, a resume with momentum (the port's
  trainer keeps the optimizer state the JAX one drops), the raise without
  a card, ``spark.run`` under a fake ``pyspark``, and ``LocalBackend``
  with a rank that writes more than a pipe holds before a barrier.
"""

import concurrent.futures
import os
import shutil
import sys
import tempfile
import types
import uuid

import numpy as np
import pandas as pd
import pytest
import torch

import horovod_tpu.spark as jspark
from horovod_tpu.spark import backend as jbackend
from horovod_tpu.spark import estimator as jestimator
from horovod_tpu.spark import keras as jkeras
from horovod_tpu.spark import store as jstore
from horovod_tpu.spark import torch as jtorch
from horovod_tpu.spark import util as jutil

import horovod_tpu_torch.spark as tspark
from horovod_tpu_torch.spark import backend as tbackend
from horovod_tpu_torch.spark import estimator as testimator
from horovod_tpu_torch.spark import keras as tkeras
from horovod_tpu_torch.spark import store as tstore
from horovod_tpu_torch.spark import torch as ttorch
from horovod_tpu_torch.spark import util as tutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
LR = 0.5
BATCH = 8


def _df(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n).astype(np.float32)
    df = pd.DataFrame({"x": x, "y": 2.0 * x + 0.5})
    df["x"] = df["x"].apply(lambda v: [v])     # feature as 1-vector
    return df


@pytest.fixture
def restore_environ():
    saved = dict(os.environ)
    yield saved
    os.environ.clear()
    os.environ.update(saved)


# ---------------------------------------------------------------------------
# params, data, store
# ---------------------------------------------------------------------------

def test_params_accessors_match_jax():
    for mod in (jestimator, testimator):
        p = mod.EstimatorParams()
        p.setEpochs(7).setBatchSize(16).setFeatureCols(["x"])
        assert (p.getEpochs(), p.getBatchSize(), p.getFeatureCols()) == \
            (7, 16, ["x"])
        with pytest.raises(ValueError):
            p.setParams(not_a_param=1)
        dup = p.copy({"epochs": 9})
        assert dup.getEpochs() == 9 and p.getEpochs() == 7
    assert testimator.EstimatorParams()._values == \
        jestimator.EstimatorParams()._values
    assert testimator.ModelParams()._values == \
        jestimator.ModelParams()._values
    # The port's estimator and model add one param: the device.
    est = ttorch.TorchEstimator(epochs=2)
    assert set(est._values) - set(jtorch.TorchEstimator()._values) == \
        {"device"}
    assert est.getDevice() is None and \
        est.setDevice("cpu").getDevice() == "cpu"
    assert ttorch.TorchModel(device="cpu").getDevice() == "cpu"


@pytest.mark.parametrize("validation", [None, 0.2, "is_val"])
def test_prepare_data_matches_jax_and_reads_across(tmp_path, validation):
    df = _df(103)
    df["is_val"] = [i % 5 == 0 for i in range(103)]
    stores = {}
    metas = {}
    for name, store_mod, util in (("jax", jstore, jutil),
                                  ("port", tstore, tutil)):
        stores[name] = store_mod.FilesystemStore(str(tmp_path / name))
        metas[name] = util.prepare_data(4, stores[name], df, ["x"], ["y"],
                                        validation=validation, seed=3)
    assert metas["port"] == metas["jax"]
    assert tutil.read_metadata(stores["jax"]) == metas["jax"]
    assert jutil.read_metadata(stores["port"]) == metas["port"]
    cols = ["x", "y"]
    splits = ["train"] + (["val"] if metas["jax"]["val_rows"] else [])
    for split in splits:
        for rank in range(2):
            for src in ("jax", "port"):
                want = jutil.data_shards(stores["jax"], split, rank, 2, cols)
                got = tutil.data_shards(stores[src], split, rank, 2, cols)
                for c in cols:
                    np.testing.assert_array_equal(got[c], want[c])
                for drop in (False, True):
                    jb = list(jutil.stream_batches(
                        stores["jax"], split, rank, 2, cols, 10, seed=5,
                        drop_remainder=drop))
                    tb = list(tutil.stream_batches(
                        stores[src], split, rank, 2, cols, 10, seed=5,
                        drop_remainder=drop))
                    assert len(tb) == len(jb)
                    for a, b in zip(tb, jb):
                        for x, y in zip(a, b):
                            np.testing.assert_array_equal(x, y)
                assert tutil.shard_rows(metas["port"], split, rank, 2) == \
                    jutil.shard_rows(metas["jax"], split, rank, 2)
        assert tutil.part_row_counts(stores["jax"], split, "x") == \
            jutil.part_row_counts(stores["port"], split, "x") == \
            metas["jax"][f"{split}_part_rows"]
    legacy = {k: v for k, v in metas["jax"].items()
              if k != "train_part_rows"}
    for size in (1, 2, 3):
        for ceil in (False, True):
            want = jutil.sync_steps_per_epoch(metas["jax"], "train", size,
                                              7, ceil=ceil)
            assert tutil.sync_steps_per_epoch(
                metas["port"], "train", size, 7, ceil=ceil) == want
            assert tutil.sync_steps_per_epoch(
                legacy, "train", size, 7, ceil=ceil,
                store=stores["jax"], col="x") == want
    with pytest.raises(ValueError, match="no train rows"):
        tutil.sync_steps_per_epoch(metas["port"], "train", 8, 7)
    shard = {"x": np.arange(10.0), "y": np.arange(10.0)}
    for kw in ({}, {"drop_remainder": False}, {"shuffle": False}):
        got = list(tutil.batches(shard, cols, 4, seed=2, **kw))
        want = list(jutil.batches(shard, cols, 4, seed=2, **kw))
        assert [np.asarray(b).tolist() for b in got] == \
            [np.asarray(b).tolist() for b in want]


def test_store_create_dispatch_and_memory_round_trip(tmp_path):
    for url in (str(tmp_path / "a"), "file://" + str(tmp_path / "b"),
                "s3://b/p", "s3a://b/p", "hdfs://n/p", "gs://b/p",
                "gcs://b/p", f"memory://x-{uuid.uuid4().hex}"):
        assert type(tstore.Store.create(url)).__name__ == \
            type(jstore.Store.create(url)).__name__, url
    for cls in (tstore.S3Store, tstore.HDFSStore, tstore.GCSStore):
        with pytest.raises(ValueError, match="Store.create"):
            cls("file:///tmp/x")
    url = f"memory://est-{uuid.uuid4().hex}"
    store = tstore.Store.create(url)
    ckpt = store.get_checkpoint_path("r1")
    assert ckpt == jstore.Store.create(url).get_checkpoint_path("r1")
    assert not store.exists(ckpt)
    store.write(ckpt, b"payload")
    assert store.read(ckpt) == b"payload"
    with store.open_read(ckpt) as f:
        assert f.read() == b"payload"
    # The JAX package's store on the same URL reads what the port wrote.
    assert jstore.Store.create(url).read(ckpt) == b"payload"
    store.delete(store.get_run_path("r1"))
    assert not store.exists(ckpt)
    meta = tutil.prepare_data(3, store, _df(30), ["x"], ["y"])
    got = list(tutil.stream_batches(store, "train", 0, 1, ["x", "y"], 8,
                                    shuffle=False))
    assert sum(len(b[0]) for b in got) == meta["train_rows"] == 30


def test_spark_exports_the_jax_names():
    assert tspark.__all__ == jspark.__all__
    for name in tspark.__all__:
        assert getattr(tspark, name) is not None, name


# ---------------------------------------------------------------------------
# two ranks on LocalBackend, both packages side by side
# ---------------------------------------------------------------------------

def _estimator(pkg, net, store, epochs, **kw):
    kwargs = dict(model=net,
                  optimizer=torch.optim.SGD(net.parameters(), lr=LR),
                  loss=torch.nn.MSELoss(), feature_cols=["x"],
                  label_cols=["y"], store=store, epochs=epochs,
                  batch_size=BATCH, run_id="torchrun", verbose=0, **kw)
    if pkg is ttorch:
        kwargs.setdefault("device", "cpu")
    return pkg.TorchEstimator(**kwargs)


def _linear(state):
    net = torch.nn.Linear(1, 1)
    net.load_state_dict(state)
    return net


def _replay(store, init_state, epochs, size=2, lr=LR, momentum=0.0):
    """The data-parallel run in this process: each step averages the
    ranks' gradients on their batches, as ``util.stream_batches`` and
    ``sync_steps_per_epoch`` give them."""
    import itertools
    net = _linear(init_state)
    opt = torch.optim.SGD(net.parameters(), lr=lr, momentum=momentum)
    loss_fn = torch.nn.MSELoss()
    meta = tutil.read_metadata(store)
    steps = tutil.sync_steps_per_epoch(meta, "train", size, BATCH,
                                       ceil=True)
    history, states = [], []
    for epoch in range(epochs):
        its = [itertools.islice(tutil.stream_batches(
            store, "train", r, size, ["x", "y"], BATCH, seed=epoch,
            drop_remainder=False), steps) for r in range(size)]
        total = 0.0
        for batches in zip(*its):
            grads = []
            for r, (x, y) in enumerate(batches):
                net.zero_grad()
                loss = loss_fn(net(torch.as_tensor(x).float()).squeeze(-1),
                               torch.as_tensor(y).float())
                loss.backward()
                if r == 0:
                    total += float(loss.detach())
                grads.append([p.grad.clone() for p in net.parameters()])
            for p, *g in zip(net.parameters(), *grads):
                p.grad = sum(g[1:], g[0]) / size
            opt.step()
        history.append(total / steps)
        states.append({k: v.clone() for k, v in net.state_dict().items()})
    return history, states


def _both(fn_jax, fn_port):
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(fn_jax), pool.submit(fn_port)]
        return [f.result() for f in futures]


@pytest.fixture(scope="module")
def two_rank_fits():
    """JAX and port fits of 3 epochs side by side, then each package
    resumes a copy of the other's Store to epoch 5."""
    root = tempfile.mkdtemp(prefix="torch_port_spark_")
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, saved) if p)
    try:
        torch.manual_seed(0)
        init = torch.nn.Linear(1, 1).state_dict()
        df = _df()
        stores = {name: mod.FilesystemStore(os.path.join(root, name))
                  for name, mod in (("jax", jstore), ("port", tstore))}
        fits = _both(
            lambda: _estimator(jtorch, _linear(init), stores["jax"], 3,
                               num_proc=2).fit(df),
            lambda: _estimator(ttorch, _linear(init), stores["port"], 3,
                               num_proc=2).fit(df))
        copies = {}
        for name in stores:
            shutil.copytree(os.path.join(root, name),
                            os.path.join(root, name + "_copy"))
            copies[name] = (jstore if name == "jax" else tstore) \
                .FilesystemStore(os.path.join(root, name + "_copy"))
        # Each package resumes the other's checkpoint.
        resumed = _both(
            lambda: _estimator(jtorch, _linear(init), copies["port"], 5,
                               num_proc=2).fit_on_prepared_data(),
            lambda: _estimator(ttorch, _linear(init), copies["jax"], 5,
                               num_proc=2).fit_on_prepared_data())
        replay = _replay(stores["port"], init, 5)
        yield {"df": df, "init": init, "stores": stores, "copies": copies,
               "jax": fits[0], "port": fits[1], "jax_resumed": resumed[0],
               "port_resumed": resumed[1], "replay": replay}
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved
        shutil.rmtree(root, ignore_errors=True)


def _assert_states_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=0)


def test_two_rank_fit_matches_jax(two_rank_fits):
    j, t = two_rank_fits["jax"], two_rank_fits["port"]
    assert t.start_epoch == j.start_epoch == 0
    assert len(t.history) == 3
    np.testing.assert_allclose(t.history, j.history, atol=ATOL, rtol=0)
    assert t.history[-1] < t.history[0]
    _assert_states_close(t.getModel().state_dict(),
                         j.getModel().state_dict())
    for name in ("jax", "port"):
        store = two_rank_fits["stores"][name]
        assert testimator.checkpoint_epoch(store, "torchrun") == \
            jestimator.checkpoint_epoch(store, "torchrun") == 2
    history, states = two_rank_fits["replay"]
    np.testing.assert_allclose(t.history, history[:3], atol=ATOL, rtol=0)
    _assert_states_close(t.getModel().state_dict(), states[2])


def test_transform_and_output_ranks_match_jax(two_rank_fits):
    j, t = two_rank_fits["jax"], two_rank_fits["port"]
    head = two_rank_fits["df"].head(8)
    tout, jout = t.transform(head), j.transform(head)
    assert list(tout.columns) == list(jout.columns) == ["x", "y",
                                                        "y__output"]
    np.testing.assert_allclose(np.asarray(tout["y__output"].tolist()),
                               np.asarray(jout["y__output"].tolist()),
                               atol=ATOL, rtol=0)
    assert t.getMetadata() == j.getMetadata()
    assert t._output_ranks() == j._output_ranks() == [0]
    bare = ttorch.TorchModel(model=t.getModel(), feature_cols=["x"],
                             label_cols=["y"], device="cpu")
    assert bare._output_ranks() is None


def test_each_package_resumes_the_others_checkpoint(two_rank_fits):
    """Port from the JAX package's epoch-2 checkpoint, JAX from the
    port's: both start at epoch 3 and end where the uninterrupted
    5-epoch run ends."""
    j5, t5 = two_rank_fits["jax_resumed"], two_rank_fits["port_resumed"]
    history, states = two_rank_fits["replay"]
    for m in (j5, t5):
        assert m.start_epoch == 3
        np.testing.assert_allclose(m.history, history[3:], atol=ATOL,
                                   rtol=0)
        _assert_states_close(m.getModel().state_dict(), states[4])
    for store in two_rank_fits["copies"].values():
        assert testimator.checkpoint_epoch(store, "torchrun") == 4
    # The port's Store holds CPU tensors that the JAX package loads as
    # they are (its loader passes no map_location).
    port_ckpt = two_rank_fits["stores"]["port"]
    raw = port_ckpt.read(port_ckpt.get_checkpoint_path("torchrun"))
    state = jtorch._state_from_bytes(raw)
    assert {v.device.type for v in state["model"].values()} == {"cpu"}


# ---------------------------------------------------------------------------
# in process: memory://, momentum across a resume, no card
# ---------------------------------------------------------------------------

def _inproc_backend(base):
    class InprocBackend(base):
        def num_processes(self):
            return 1

        def run(self, fn, args=(), extra_env=None):
            env = {"HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
                   "HOROVOD_LOCAL_RANK": "0", "HOROVOD_LOCAL_SIZE": "1",
                   "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
                   "HOROVOD_TPU_FORCE_CPU": "1", **(extra_env or {})}
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                return [fn(*args)]
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v

    return InprocBackend()


def test_memory_store_in_process_matches_jax():
    """The trainer streams out of an fsspec ``memory://`` store (per
    process, hence an in-process backend), in both packages."""
    torch.manual_seed(1)
    init = torch.nn.Linear(1, 1).state_dict()
    df = _df()
    models = {}
    for pkg, store_mod, base in ((jtorch, jstore, jbackend.Backend),
                                 (ttorch, tstore, tbackend.Backend)):
        store = store_mod.Store.create(f"memory://est-{uuid.uuid4().hex}")
        models[pkg] = _estimator(pkg, _linear(init), store, 3,
                                 backend=_inproc_backend(base)).fit(df)
    j, t = models[jtorch], models[ttorch]
    np.testing.assert_allclose(t.history, j.history, atol=ATOL, rtol=0)
    assert t.history[-1] < t.history[0]
    _assert_states_close(t.getModel().state_dict(),
                         j.getModel().state_dict())
    out = t.transform(df.head(8))
    assert "y__output" in out.columns


def test_resume_keeps_the_momentum_the_jax_trainer_drops(tmp_path):
    """Fit 2 epochs and resume to 3 with ``SGD(momentum=0.9)``: the
    port's resumed run is the uninterrupted one (the optimizer state is
    loaded into the ``DistributedOptimizer``); the JAX package's loads it
    into the optimizer that the wrapper replaces, and drifts."""
    torch.manual_seed(2)
    init = torch.nn.Linear(1, 1).state_dict()
    df = _df()
    ends = {}
    for pkg, store_mod, base in ((jtorch, jstore, jbackend.Backend),
                                 (ttorch, tstore, tbackend.Backend)):
        store = store_mod.FilesystemStore(str(tmp_path / pkg.__name__))
        net = _linear(init)
        est = _estimator(pkg, net, store, 2, backend=_inproc_backend(base))
        est.setOptimizer(torch.optim.SGD(net.parameters(), lr=0.1,
                                         momentum=0.9))
        est.fit(df)
        resumed = est.copy({"epochs": 3}).fit_on_prepared_data()
        assert resumed.start_epoch == 2
        ends[pkg] = {k: v.clone()
                     for k, v in resumed.getModel().state_dict().items()}
    _, states = _replay(store, init, 3, size=1, lr=0.1, momentum=0.9)
    _assert_states_close(ends[ttorch], states[2])
    drift = max((ends[jtorch][k] - states[2][k]).abs().max().item()
                for k in states[2])
    assert drift > 1e-3, drift


def test_no_card_raises_before_any_worker_starts(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    store = tstore.FilesystemStore(str(tmp_path))
    net = torch.nn.Linear(1, 1)

    class NoRun(tbackend.Backend):
        def num_processes(self):
            return 2

        def run(self, fn, args=(), extra_env=None):
            raise AssertionError("a worker started")

    est = _estimator(ttorch, net, store, 1, backend=NoRun(), device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit(_df())
    assert not store.exists(store.get_train_data_path())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit_on_prepared_data()
    model = ttorch.TorchModel(model=net, feature_cols=["x"],
                              label_cols=["y"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model._predict([np.zeros((1, 1), np.float32)])


# ---------------------------------------------------------------------------
# spark.run under a fake pyspark
# ---------------------------------------------------------------------------

def test_spark_run_requires_pyspark():
    if "pyspark" in sys.modules:
        pytest.skip("pyspark is importable")
    for mod in (jspark, tspark):
        with pytest.raises(ImportError, match="pyspark"):
            mod.run(lambda: None)


def _fake_pyspark(monkeypatch):
    """One barrier task per partition, run in this process; its
    ``allGather`` returns its input in a list."""
    pyspark = types.ModuleType("pyspark")
    sql = types.ModuleType("pyspark.sql")

    class Context:
        def allGather(self, message):
            return [message]

    class RDD:
        def __init__(self, data):
            self.data = list(data)

        def barrier(self):
            return self

        def mapPartitionsWithIndex(self, fn):
            self.fn = fn
            return self

        def collect(self):
            return list(self.fn(0, iter(self.data)))

    class SparkContext:
        defaultParallelism = 1

        def parallelize(self, data, num_slices):
            assert num_slices == 1
            return RDD(data)

    session = types.SimpleNamespace(sparkContext=SparkContext())
    sql.SparkSession = types.SimpleNamespace(
        builder=types.SimpleNamespace(getOrCreate=lambda: session))
    pyspark.BarrierTaskContext = types.SimpleNamespace(get=Context)
    pyspark.sql = sql
    monkeypatch.setitem(sys.modules, "pyspark", pyspark)
    monkeypatch.setitem(sys.modules, "pyspark.sql", sql)


def _horovod_env():
    return {k: v for k, v in os.environ.items()
            if k.startswith("HOROVOD_")}


# Ports and the secret differ from run to run; the coordinator and
# controller keep their host.
_PER_RUN = ("HOROVOD_GLOO_RENDEZVOUS_PORT", "HOROVOD_SECRET_KEY")
_HOST_PORT = ("HOROVOD_TPU_COORDINATOR", "HOROVOD_CONTROLLER_ADDR")


def _contract(env):
    out = {k: v for k, v in env.items() if k not in _PER_RUN}
    for k in _HOST_PORT:
        out[k] = env[k].rsplit(":", 1)[0]
    return out


def test_spark_run_hands_the_task_the_jax_env(monkeypatch,
                                              restore_environ):
    _fake_pyspark(monkeypatch)
    got = {}
    for name, mod in (("jax", jspark), ("port", tspark)):
        os.environ.clear()
        os.environ.update(restore_environ)
        before = _horovod_env()
        result = mod.run(lambda a, b=0: (a + b, _horovod_env()), args=(2,),
                         kwargs={"b": 3}, num_proc=1,
                         extra_env={"HOROVOD_EXTRA": "1"})
        assert len(result) == 1 and result[0][0] == 5
        got[name] = {k: v for k, v in result[0][1].items()
                     if before.get(k) != v}
    assert set(_PER_RUN) | set(_HOST_PORT) <= set(got["port"])
    assert _contract(got["port"]) == _contract(got["jax"])
    assert got["port"]["HOROVOD_RANK"] == "0"
    assert got["port"]["HOROVOD_SIZE"] == "1"
    assert got["port"]["HOROVOD_EXTRA"] == "1"


# ---------------------------------------------------------------------------
# LocalBackend: a rank that writes more than a pipe holds
# ---------------------------------------------------------------------------

def _chatty_pair(flag):
    """Rank 1 writes 1 MB to stdout, then arrives at a barrier (a file)
    that rank 0 waits on; returns the rank."""
    def fn():
        import os
        import sys
        import time
        rank = int(os.environ["HOROVOD_RANK"])
        if rank == 1:
            sys.stdout.write("x" * (1 << 20))
            sys.stdout.flush()
            open(flag, "w").close()
        else:
            while not os.path.exists(flag):
                time.sleep(0.01)
        return rank
    return fn


def test_local_backend_output_cannot_wedge_a_rank(tmp_path, monkeypatch):
    """At ``verbose=1`` the JAX backend pipes each rank's output and reads
    the pipes one rank after another: rank 1 blocks on its full pipe while
    rank 0 waits for it, until the timeout fails the run.  The port's
    backend writes each rank's output to a file and finishes."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    assert tbackend.LocalBackend(2, verbose=1, timeout=60).run(
        _chatty_pair(str(tmp_path / "port.flag"))) == [0, 1]
    with pytest.raises(RuntimeError, match=r"worker\(s\) \[0\]"):
        jbackend.LocalBackend(2, verbose=1, timeout=8).run(
            _chatty_pair(str(tmp_path / "jax.flag")))


def test_local_backend_names_a_failed_rank_with_its_output():
    def fn():
        import os
        if os.environ["HOROVOD_RANK"] == "1":
            print("rank 1 gives up")
            raise SystemExit(3)
        return 0
    with pytest.raises(RuntimeError, match=r"worker\(s\) \[1\] failed"
                       r"(.|\n)*rank 1 gives up"):
        tbackend.LocalBackend(2, verbose=1, timeout=60).run(fn)


# ---------------------------------------------------------------------------
# KerasEstimator: two ranks on LocalBackend, both packages side by side
# ---------------------------------------------------------------------------

def _keras_estimator(pkg, model, store, epochs, **kw):
    kwargs = dict(model=model, optimizer="sgd", loss="mse",
                  feature_cols=["x"], label_cols=["y"], store=store,
                  num_proc=2, epochs=epochs, batch_size=8,
                  run_id="kerasrun", verbose=0, **kw)
    if pkg is tkeras:
        kwargs.setdefault("device", "cpu")
    return pkg.KerasEstimator(**kwargs)


@pytest.fixture(scope="module")
def keras_fits():
    """JAX and port fits of 2 epochs side by side (every worker on
    Keras's torch backend), then each package resumes a copy of the
    other's Store to epoch 4."""
    keras = pytest.importorskip("keras")
    root = tempfile.mkdtemp(prefix="torch_port_spark_keras_")
    saved = {k: os.environ.get(k) for k in ("PYTHONPATH", "KERAS_BACKEND")}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, saved["PYTHONPATH"]) if p)
    # The JAX package's workers take the driver's environment; the
    # port's set the torch backend themselves.
    os.environ["KERAS_BACKEND"] = "torch"
    try:
        model = keras.Sequential([keras.layers.Input(shape=(1,)),
                                  keras.layers.Dense(1)])
        model.set_weights([np.full((1, 1), 0.25, np.float32),
                           np.full((1,), -0.5, np.float32)])
        df = _df(64)
        stores = {name: mod.FilesystemStore(os.path.join(root, name))
                  for name, mod in (("jax", jstore), ("port", tstore))}
        fits = _both(
            lambda: _keras_estimator(jkeras, model, stores["jax"],
                                     2).fit(df),
            lambda: _keras_estimator(tkeras, model, stores["port"],
                                     2).fit(df))
        copies = {}
        for name in stores:
            shutil.copytree(os.path.join(root, name),
                            os.path.join(root, name + "_copy"))
            copies[name] = (jstore if name == "jax" else tstore) \
                .FilesystemStore(os.path.join(root, name + "_copy"))
        resumed = _both(
            lambda: _keras_estimator(jkeras, None, copies["port"],
                                     4).fit_on_prepared_data(),
            lambda: _keras_estimator(tkeras, None, copies["jax"],
                                     4).fit_on_prepared_data())
        yield {"df": df, "jax": fits[0], "port": fits[1],
               "jax_resumed": resumed[0], "port_resumed": resumed[1]}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def test_keras_estimator_fit_matches_jax(keras_fits):
    """The fit, held to the JAX package's with equal losses: both run
    the same Keras steps, and at two ranks an average of fp32 gradients
    rounds the same way on either data plane."""
    j, t = keras_fits["jax"], keras_fits["port"]
    assert t.start_epoch == j.start_epoch == 0
    assert len(t.history["loss"]) == 2
    assert t.history == j.history
    for got, want in zip(t.getModel().get_weights(),
                         j.getModel().get_weights()):
        np.testing.assert_array_equal(got, want)


def test_keras_estimator_transform_matches_jax(keras_fits):
    j, t = keras_fits["jax"], keras_fits["port"]
    head = keras_fits["df"].head(8)
    tout, jout = t.transform(head), j.transform(head)
    assert list(tout.columns) == list(jout.columns) == ["x", "y",
                                                        "y__output"]
    np.testing.assert_array_equal(np.asarray(tout["y__output"].tolist()),
                                  np.asarray(jout["y__output"].tolist()))


def test_keras_estimators_resume_each_others_checkpoint(keras_fits):
    j4, t4 = keras_fits["jax_resumed"], keras_fits["port_resumed"]
    for m in (j4, t4):
        assert m.start_epoch == 2
        assert len(m.history["loss"]) == 2
    assert t4.history == j4.history
    for got, want in zip(t4.getModel().get_weights(),
                         j4.getModel().get_weights()):
        np.testing.assert_array_equal(got, want)


def test_keras_estimator_without_a_card_raises_before_any_data(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    store = tstore.FilesystemStore(str(tmp_path))

    class NoRun(tbackend.Backend):
        def num_processes(self):
            return 2

        def run(self, fn, args=(), extra_env=None):
            raise AssertionError("a worker started")

    est = tkeras.KerasEstimator(
        model=None, optimizer="sgd", loss="mse", feature_cols=["x"],
        label_cols=["y"], store=store, backend=NoRun(), epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit(_df())
    assert not store.exists(store.get_train_data_path())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit_on_prepared_data()
