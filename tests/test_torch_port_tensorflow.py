"""The port's TF binding (``horovod_tpu_torch.tensorflow``) held against
the JAX package's ``horovod_tpu.tensorflow``.

* Every case of ``tests/test_tensorflow_keras.py`` at world one, in this
  process, once through each package (with its ``keras`` binding on the
  TensorFlow backend): the outputs are equal.  Inputs and initial
  weights are numpy from seeds.
* ``tests/test_tf_graph_collectives.py`` at two ranks: the traced train
  step holds ``CollectiveReduceV2`` and no ``py_function`` node, and its
  losses and weights equal the JAX package's; the graph ops' values; the
  rank-divergent trace caught by the key check; and the fallback to
  ``py_function`` when the TF context is already live.
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest

from multiproc import assert_all_ok, run_workers
from test_torch_port_multiproc import run_port_workers

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")


@pytest.fixture(scope="module")
def packages():
    """(tensorflow binding, keras binding) of each package, initialized
    at world one."""
    import horovod_tpu.keras as jk
    import horovod_tpu.tensorflow as jt
    import horovod_tpu_torch.keras as tk
    import horovod_tpu_torch.tensorflow as tt
    jt.init()
    tt.init()
    yield {"jax": (jt, jk), "port": (tt, tk)}
    tt.shutdown()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _make_model():
    model = keras.Sequential([
        keras.layers.Input(shape=(4,)),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(2),
    ])
    model.set_weights([_rand(10 + i, *w.shape)
                       for i, w in enumerate(model.get_weights())])
    return model


def _case_allreduce_dense(hvd, hk):
    x = tf.constant([1.0, 2.0, 3.0])
    return [hvd.allreduce(x, op=hvd.Sum), hvd.allreduce(x, op=hvd.Average)]


def _case_allreduce_prescale(hvd, hk):
    return [hvd.allreduce(tf.constant([2.0, 4.0]), op=hvd.Sum,
                          prescale_factor=0.5)]


def _case_allreduce_indexed_slices(hvd, hk):
    slices = tf.IndexedSlices(
        values=tf.constant([[1.0, 2.0]]), indices=tf.constant([1]),
        dense_shape=tf.constant([4, 2]))
    out = hvd.allreduce(slices, op=hvd.Average)
    assert isinstance(out, tf.IndexedSlices)
    return [out.values, out.indices]


def _case_allgather_broadcast(hvd, hk):
    x = tf.constant([[1, 2], [3, 4]], dtype=tf.int32)
    return [hvd.allgather(x), hvd.broadcast(x, root_rank=0)]


def _case_graph_mode_allreduce(hvd, hk):
    @tf.function
    def fn(t):
        return hvd.allreduce(t, op=hvd.Sum)
    return [fn(tf.constant([5.0, 6.0]))]


def _case_scalar_ops_read_at_execution(hvd, hk):
    @tf.function
    def fn():
        return hvd.size_op(), hvd.rank_op()
    s, r = fn()
    assert (int(s), int(r)) == (hvd.size(), hvd.rank())
    return [s, r]


def _case_distributed_gradient_tape(hvd, hk):
    x = tf.Variable([1.0, 2.0])
    with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
        y = tf.reduce_sum(x * x)
    return tape.gradient(y, [x])


def _case_broadcast_variables(hvd, hk):
    v = tf.Variable([1.0, 2.0, 3.0])
    hvd.broadcast_variables([v], root_rank=0)
    return [v]


def _case_broadcast_and_allgather_object(hvd, hk):
    obj = {"epoch": 3, "name": "x"}
    assert hvd.broadcast_object(obj, 0, name="tfobj") == obj
    assert hvd.allgather_object(obj, name="tfobjs") == [obj]
    return [np.array(3)]


def _case_keras_distributed_optimizer_fit(hvd, hk):
    model = _make_model()
    model.compile(optimizer=hk.DistributedOptimizer(
        keras.optimizers.SGD(0.01)), loss="mse", run_eagerly=True)
    before = model.get_weights()[0].copy()
    model.fit(_rand(1, 16, 4), _rand(2, 16, 2), batch_size=8, epochs=1,
              verbose=0, shuffle=False,
              callbacks=[hk.callbacks.BroadcastGlobalVariablesCallback(0),
                         hk.callbacks.MetricAverageCallback()])
    assert not np.allclose(before, model.get_weights()[0])
    return model.get_weights()


def _case_keras_backward_passes_compiled_fit(hvd, hk):
    """Two accumulated microbatches equal one full-batch SGD step with
    the SUM of their mean gradients (size 1: the reducer is the
    identity)."""
    lr, n = 0.1, 2
    x, y = _rand(0, 16, 4), _rand(1, 16, 2)
    model = _make_model()
    opt = hk.DistributedOptimizer(keras.optimizers.SGD(lr),
                                  backward_passes_per_step=n)
    model.compile(optimizer=opt, loss="mse")
    assert not model.run_eagerly
    w0 = [w.copy() for w in model.get_weights()]
    model.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=0)
    w1 = model.get_weights()
    ref = _make_model()
    ref.set_weights(w0)
    grads = []
    for sl in (slice(0, 8), slice(8, 16)):
        with tf.GradientTape() as t:
            loss = tf.reduce_mean((ref(x[sl]) - y[sl]) ** 2)
        grads.append(t.gradient(loss, ref.trainable_variables))
    exp = [w - lr * (a.numpy() + b.numpy())
           for w, a, b in zip(w0, *grads)]
    for got, want in zip(w1, exp):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return w1


def _case_keras_lr_callbacks(hvd, hk):
    model = _make_model()
    opt = keras.optimizers.SGD(0.1)
    model.compile(optimizer=opt, loss="mse", run_eagerly=True)
    x, y = _rand(3, 8, 4), _rand(4, 8, 2)
    sched = hk.callbacks.LearningRateScheduleCallback(
        initial_lr=0.1, multiplier=0.5, start_epoch=0, staircase=True)
    # Unshuffled: a shuffled batch sums its loss in another order.
    model.fit(x, y, batch_size=8, epochs=1, verbose=0, shuffle=False,
              callbacks=[sched])
    lr1 = float(np.asarray(opt.learning_rate))
    assert np.isclose(lr1, 0.05)
    warm = hk.callbacks.LearningRateWarmupCallback(
        initial_lr=0.1, warmup_epochs=2, steps_per_epoch=1)
    model.fit(x, y, batch_size=8, epochs=1, verbose=0, shuffle=False,
              callbacks=[warm])
    lr2 = float(np.asarray(opt.learning_rate))
    # size()==1 → multiplier is 1 → lr back to initial
    assert np.isclose(lr2, 0.1)
    return [np.array([lr1, lr2])] + model.get_weights()


def _case_sync_batch_norm_single(hvd, hk):
    layer = hvd.SyncBatchNormalization(axis=-1)
    got = layer(tf.constant(_rand(5, 16, 4)), training=True).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(axis=0), np.zeros(4), atol=1e-3)
    np.testing.assert_allclose(got.std(axis=0), np.ones(4), atol=2e-2)
    return [got]


def _case_sync_batch_norm_symbolic_training(hvd, hk):
    layer = hvd.SyncBatchNormalization(axis=-1)
    x = tf.constant(_rand(6, 8, 3))
    layer.build(x.shape)

    class _FakePS:
        def size(self):
            return 2

    layer._process_set = _FakePS()
    layer._sync_call = lambda inputs, mask=None: \
        tf.convert_to_tensor(inputs) + 100.0

    @tf.function
    def run(x, training):
        return layer.call(x, training=training)

    out_train = run(x, tf.constant(True))
    np.testing.assert_allclose(out_train.numpy(), x.numpy() + 100.0,
                               rtol=1e-5)
    out_infer = run(x, tf.constant(False))
    assert not np.allclose(out_infer.numpy(), x.numpy() + 100.0)
    return [out_train, out_infer]


def _case_keras_elastic_state(hvd, hk):
    model = _make_model()
    model.compile(optimizer=keras.optimizers.SGD(0.01), loss="mse")
    state = hk.elastic.KerasState(model, epoch=0)
    w0 = model.get_weights()[0].copy()
    state.commit()
    model.set_weights([w * 0 for w in model.get_weights()])
    state.restore()
    np.testing.assert_allclose(model.get_weights()[0], w0)
    state.epoch = 5
    state.save()
    state.sync()
    assert state.epoch == 5
    return model.get_weights()


_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
          if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_world_one_case_matches_jax(packages, case):
    """The case of tests/test_tensorflow_keras.py of the same name, once
    through each package: its checks hold, and the outputs are equal."""
    outs = {pkg: [np.asarray(o) for o in _CASES[case](*mods)]
            for pkg, mods in packages.items()}
    assert len(outs["port"]) == len(outs["jax"])
    for got, want in zip(outs["port"], outs["jax"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# two ranks: tests/test_tf_graph_collectives.py
# ---------------------------------------------------------------------------

_HEAD = {
    "jax": "import horovod_tpu.tensorflow as hvdtf\nPKG = 'jax'\n",
    "port": "import horovod_tpu_torch.tensorflow as hvdtf\nPKG = 'port'\n",
}

# The traced train step (test_traced_train_step_no_py_function), in both
# packages; then, in the port's world, the graph ops' values
# (test_graph_ops_correctness) and the key check
# (test_key_check_detects_rank_divergent_tracing).
_GRAPH_BODY = """
import json
import tensorflow as tf

assert hvdtf.enable_graph_collectives(), "graph collectives not enabled"
rec = {}

w = tf.Variable([[1.0], [2.0]])

@tf.function
def train_step(x, y):
    with tf.GradientTape() as tape:
        pred = tf.matmul(x, w)
        loss = tf.reduce_mean((pred - y) ** 2)
    tape = hvdtf.DistributedGradientTape(tape)
    grads = tape.gradient(loss, [w])
    w.assign_sub(0.1 * grads[0])
    return loss

x = tf.constant([[float(RANK + 1), 0.0]])
y = tf.constant([[3.0]])
rec["losses"] = [float(train_step(x, y)), float(train_step(x, y))]
cf = train_step.get_concrete_function(
    tf.TensorSpec([1, 2], tf.float32), tf.TensorSpec([1, 1], tf.float32))
ops = {op.type for op in cf.graph.get_operations()}
assert "CollectiveReduceV2" in ops, sorted(ops)
assert not any("PyFunc" in t for t in ops), sorted(ops)
gathered = hvdtf.allgather(tf.reshape(w, (1, 2)))
np.testing.assert_allclose(gathered.numpy()[0], gathered.numpy()[1])
rec["w"] = w.numpy().tolist()

if PKG == "port":
    @tf.function
    def fn(x):
        s = hvdtf.allreduce(x, op=hvdtf.Sum)
        a = hvdtf.allreduce(x, op=hvdtf.Average)
        g = hvdtf.allgather(x[None, :])
        b = hvdtf.broadcast(x * (RANK + 1.0), root_rank=1)
        return s, a, g, b

    x = tf.constant([1.0 + RANK, 4.0])
    s, a, g, b = fn(x)
    np.testing.assert_allclose(s.numpy(), [3.0, 8.0])
    np.testing.assert_allclose(a.numpy(), [1.5, 4.0])
    assert g.shape == (2, 2), g.shape
    np.testing.assert_allclose(g.numpy()[RANK], x.numpy())
    np.testing.assert_allclose(b.numpy(), [4.0, 8.0])   # rank1's x*2
    ops = {op.type for op in fn.get_concrete_function(
        tf.TensorSpec([2], tf.float32)).graph.get_operations()}
    assert {"CollectiveReduceV2", "CollectiveGatherV2"} <= ops, sorted(ops)
    assert not any("PyFunc" in t for t in ops), sorted(ops)
    rec["ops"] = True

    # Rank-divergent tracing: rank 0 emits allreduce(4) while rank 1
    # emits allreduce(8) under the same instance key; the key check
    # raises on every rank at trace time, naming the op.
    n = 4 if RANK == 0 else 8

    @tf.function
    def diverge(x):
        return hvdtf.allreduce(x, op=hvdtf.Sum)

    try:
        diverge(tf.zeros([n]))
    except RuntimeError as e:
        msg = str(e)
        assert "rank-divergent" in msg and "allreduce" in msg, msg
        assert "DIVERGED" in msg and "(4,)" in msg and "(8,)" in msg, msg
    else:
        raise SystemExit("divergent tracing was not detected")

    @tf.function
    def agree(x):
        return hvdtf.allreduce(x, op=hvdtf.Sum)

    np.testing.assert_allclose(agree(tf.ones([3])).numpy(), [2.0] * 3)
    rec["key_check"] = True

with open(os.path.join(os.environ["RESULT_DIR"], f"{PKG}-{RANK}.json"),
          "w") as f:
    json.dump(rec, f)
"""

# test_late_context_falls_back_to_py_function.
_FALLBACK_BODY = """
import json
import tensorflow as tf

# The TF context is already live: graph collectives must degrade to the
# py_function path, not break.
_ = tf.constant(1.0) + 1.0

@tf.function
def fn(x):
    return hvdtf.allreduce(x, op=hvdtf.Sum)

out = fn(tf.constant([2.0]))
np.testing.assert_allclose(out.numpy(), [4.0])
ops = {op.type for op in fn.get_concrete_function(
    tf.TensorSpec([1], tf.float32)).graph.get_operations()}
assert any("PyFunc" in t for t in ops), sorted(ops)
with open(os.path.join(os.environ["RESULT_DIR"], f"{PKG}-{RANK}.json"),
          "w") as f:
    json.dump({"fallback": True}, f)
"""

_WORLDS = {
    "graph_port": ("port", _GRAPH_BODY,
                   {"HOROVOD_TF_COLLECTIVE_KEY_CHECK": "1"}),
    "graph_jax": ("jax", _GRAPH_BODY,
                  {"HOROVOD_TF_COLLECTIVE_KEY_CHECK": "1"}),
    "fallback_port": ("port", _FALLBACK_BODY, {}),
}


def _world(name, result_dir):
    pkg, body, env = _WORLDS[name]
    env = dict(env, RESULT_DIR=result_dir)
    code = _HEAD[pkg] + body
    if pkg == "jax":
        results = run_workers(code, nproc=2, timeout=240, extra_env=env)
    else:
        results = run_port_workers(code, nproc=2, extra_env=env,
                                   timeout=240)
    assert_all_ok(results)
    recs = []
    for r in range(2):
        with open(os.path.join(result_dir, f"{pkg}-{r}.json")) as f:
            recs.append(json.load(f))
    return recs


@pytest.fixture(scope="module")
def two_rank_worlds(tmp_path_factory):
    with concurrent.futures.ThreadPoolExecutor(len(_WORLDS)) as pool:
        futures = {name: pool.submit(
            _world, name, str(tmp_path_factory.mktemp(name)))
            for name in _WORLDS}
        return {name: f.result() for name, f in futures.items()}


def test_traced_train_step_matches_jax(two_rank_worlds):
    port, jax = two_rank_worlds["graph_port"], two_rank_worlds["graph_jax"]
    for r in range(2):
        assert port[r]["losses"] == jax[r]["losses"], r
        assert port[r]["w"] == jax[r]["w"], r
    assert port[0]["w"] == port[1]["w"]


def test_graph_ops_correctness(two_rank_worlds):
    assert all(rec["ops"] for rec in two_rank_worlds["graph_port"])


def test_key_check_detects_rank_divergent_tracing(two_rank_worlds):
    assert all(rec["key_check"] for rec in two_rank_worlds["graph_port"])


def test_late_context_falls_back_to_py_function(two_rank_worlds):
    assert all(rec["fallback"] for rec in two_rank_worlds["fallback_port"])
