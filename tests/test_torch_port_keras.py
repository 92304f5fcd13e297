"""The port's Keras binding (``horovod_tpu_torch.keras``) on Keras's torch
backend, held against the JAX package's ``horovod_tpu.keras`` on the same
backend.

One body, written against the Keras binding API both packages share
(bound to ``K``), runs at two ranks in a world of port workers and in a
world of JAX-package workers, both with ``KERAS_BACKEND=torch`` (the JAX
package reduces there through ``_backend_grads_fn``, by numpy).  Inputs
are numpy from seeds, and each rank starts from its own weights.  Per
epoch losses, learning rates and final weights are **equal** across the
two packages: at two ranks an average is one fp32 (or fp16) addition and
an exact 0.5 postscale, which round the same way on either data plane.
The cases:

* ``model.fit`` of ``tests/test_keras_jax.py`` (rank-disjoint shards of
  y = 2x + 0.5, ``SGD(0.4)``, broadcast and metric-average callbacks, 30
  epochs) with that test's own checks;
* ``backward_passes_per_step=2`` (Keras's ``gradient_accumulation_steps``:
  the reducer runs on update steps only, so about half the frames);
* ``Compression.fp16``; the learning-rate schedule and warmup callbacks;
* ``KerasState`` restore, then ``sync`` after a reset of the world;
* ``load_model``, whose optimizer comes back wrapped.

The port's world also reduces gradients through ``_torch_grads_fn`` with
``torch.Tensor.numpy`` and ``keras.ops.convert_to_numpy`` patched to
raise, bit-equal to the torch binding's ``grouped_allreduce``; broadcasts
a model's variables after rank 0 built one more model than rank 1; and
checks that ``set_data_parallel`` raises its ``NotImplementedError``.
A process with ``KERAS_BACKEND=jax`` checks that the port refuses that
backend with its ``ValueError``.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from multiproc import REPO, assert_all_ok, run_workers
from test_torch_port_multiproc import run_port_workers

pytestmark = pytest.mark.multiproc

TIMEOUT_S = 240

_HEAD = {
    "jax": "import horovod_tpu.keras as K\n"
           "from horovod_tpu.common import basics\nPKG = 'jax'\n",
    "port": "import horovod_tpu_torch.keras as K\n"
            "from horovod_tpu_torch.common import basics\nPKG = 'port'\n",
}

_BODY = """
import json
import keras
import torch
assert keras.backend.backend() == "torch", keras.backend.backend()
torch.set_num_threads(1)
keras.utils.set_random_seed(1234 + RANK)   # the fit's shuffles
ctrl = basics._state().runtime.controller
rec = {}

def frames():
    s = ctrl.stats
    return s.get("ch_frames", 0) + s.get("rq_frames", 0)

def weights(model):
    return [w.tolist() for w in model.get_weights()]

# Rank-disjoint shards of y = 2x + 0.5: convergence to the shared
# weights shows the gradients are averaged across ranks.
x = (np.linspace(0, 1, 256)[RANK::SIZE]).astype("float32")[:, None]
y = 2.0 * x + 0.5

def line_model():
    model = keras.Sequential([keras.layers.Input((1,)),
                              keras.layers.Dense(1)])
    # Each rank starts elsewhere: the broadcast callback aligns them.
    model.set_weights([np.full((1, 1), 0.3 + RANK, np.float32),
                       np.full((1,), -0.2 * RANK, np.float32)])
    return model

def check_converged(model, tag):
    w = float(model.get_weights()[0][0, 0])
    b = float(model.get_weights()[1][0])
    assert abs(w - 2.0) < 0.1 and abs(b - 0.5) < 0.1, (tag, w, b)
    gathered = np.asarray(K.allgather(np.array([[w, b]], np.float32),
                                      name=tag + ".wb"))
    assert (gathered == gathered[0:1]).all(), (tag, gathered)

# 1. model.fit (tests/test_keras_jax.py:12-65).
model = line_model()
model.compile(optimizer=K.DistributedOptimizer(keras.optimizers.SGD(0.4)),
              loss="mse")
before = frames()
hist = model.fit(x, y, batch_size=32, epochs=30, verbose=0,
                 callbacks=[K.callbacks.BroadcastGlobalVariablesCallback(0),
                            K.callbacks.MetricAverageCallback()])
assert frames() - before > 30, (before, frames())
assert len(hist.history["loss"]) == 30
assert hist.history["loss"][-1] < hist.history["loss"][0]
check_converged(model, "fit")
rec["fit_loss"], rec["fit_w"] = hist.history["loss"], weights(model)

# 2. backward_passes_per_step=2: the wire only on update steps.
model = line_model()
opt = K.DistributedOptimizer(keras.optimizers.SGD(0.2),
                             backward_passes_per_step=2)
assert opt.gradient_accumulation_steps == 2
model.compile(optimizer=opt, loss="mse")
epochs, batch = 40, 32
before = frames()
hist = model.fit(x, y, batch_size=batch, epochs=epochs, verbose=0,
                 callbacks=[K.callbacks.BroadcastGlobalVariablesCallback(0)])
steps = (len(x) // batch) * epochs
sent = frames() - before
assert steps // 4 <= sent <= steps // 2 + 12, (sent, steps)
check_converged(model, "bps")
rec["bps_loss"], rec["bps_w"] = hist.history["loss"], weights(model)

# 3. fp16 on the wire.
model = line_model()
model.compile(optimizer=K.DistributedOptimizer(
    keras.optimizers.SGD(0.4), compression=K.Compression.fp16), loss="mse")
hist = model.fit(x, y, batch_size=32, epochs=10, verbose=0,
                 callbacks=[K.callbacks.BroadcastGlobalVariablesCallback(0)])
rec["fp16_loss"], rec["fp16_w"] = hist.history["loss"], weights(model)

# 4. Learning-rate schedule, then warmup from lr/size.
model = line_model()
opt = K.DistributedOptimizer(keras.optimizers.SGD(0.1))
model.compile(optimizer=opt, loss="mse")
sched = K.callbacks.LearningRateScheduleCallback(
    initial_lr=0.1, multiplier=0.5, start_epoch=0, staircase=True)
hist = model.fit(x, y, batch_size=32, epochs=1, verbose=0,
                 callbacks=[sched])
assert np.isclose(float(keras.ops.convert_to_numpy(opt.learning_rate)),
                  0.05)
rec["sched_lr"] = hist.history["lr"]
warm = K.callbacks.LearningRateWarmupCallback(
    initial_lr=0.1, warmup_epochs=2, steps_per_epoch=4)
hist = model.fit(x, y, batch_size=32, epochs=2, verbose=0,
                 callbacks=[warm])
# Batch 3 of epoch 1 (the last) sets 0.1 * (1/2 + 1.75 * (1/2) / 2).
assert np.isclose(hist.history["lr"][-1], 0.1 * (0.5 + 1.75 * 0.25)), \\
    hist.history["lr"]
rec["warm_lr"], rec["warm_w"] = hist.history["lr"], weights(model)

# 5. load_model wraps the loaded optimizer.
path = os.path.join(os.environ["RESULT_DIR"], f"{PKG}.keras")
plain = line_model()   # on every rank: Keras's layer names stay aligned
plain.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
if RANK == 0:
    plain.save(path)
K.allreduce(np.zeros(1, np.float32), name="saved")   # rank 0 has saved
model = K.load_model(path)
assert getattr(model.optimizer, "_hvd_distributed", False)
hist = model.fit(x, y, batch_size=32, epochs=2, verbose=0,
                 callbacks=[K.callbacks.BroadcastGlobalVariablesCallback(0)])
rec["load_loss"], rec["load_w"] = hist.history["loss"], weights(model)

if PKG == "port":
    # 6. The reducer never goes through numpy, and equals the torch
    #    binding's grouped_allreduce bit for bit.
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import _keras
    rng = np.random.RandomState(7 + RANK)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in ((5, 3), (3,), (2, 2, 2))]
    cases = {"average": (K.Compression.none, 1.0),
             "predivide": (K.Compression.none, 2.0),
             "fp16": (K.Compression.fp16, 1.0)}
    saved = torch.Tensor.numpy, keras.ops.convert_to_numpy

    def refuse(*a, **k):
        raise AssertionError("the reducer went through numpy")
    for tag, (comp, pre) in cases.items():
        fn = _keras._torch_grads_fn(comp, K.Average, pre,
                                    K.global_process_set)
        torch.Tensor.numpy = refuse
        keras.ops.convert_to_numpy = refuse
        try:
            got = fn([grads[0], None, grads[1], grads[2]])
        finally:
            torch.Tensor.numpy, keras.ops.convert_to_numpy = saved
        assert got[1] is None
        got = [got[0], got[2], got[3]]
        want = [comp.decompress(r, ctx) for r, (_, ctx) in zip(
            hvd_torch.grouped_allreduce(
                [comp.compress(g)[0] for g in grads], op=K.Sum,
                prescale_factor=1.0 / pre, postscale_factor=pre / SIZE),
            [comp.compress(g) for g in grads])]
        for g, w, src in zip(got, want, grads):
            assert g.dtype == src.dtype and g.device == src.device, tag
            assert torch.equal(g, w), tag
    # Variables broadcast by their place in the list, so ranks whose
    # Keras names differ (rank 0 built one more model) still meet.
    if RANK == 0:
        line_model()
    model = line_model()
    model.compile(optimizer=K.DistributedOptimizer(
        keras.optimizers.SGD(0.1, momentum=0.9)), loss="mse")
    model.optimizer.build(model.trainable_variables)
    K.broadcast_variables(model.optimizer.variables, 0)
    K.broadcast_model(model, 0)
    root = [np.full((1, 1), 0.3, np.float32), np.zeros((1,), np.float32)]
    assert all((w == v).all() for w, v in zip(model.get_weights(), root))
    rec["divergent_names"] = True
    try:
        K.set_data_parallel()
        raise AssertionError("set_data_parallel did not raise")
    except NotImplementedError as e:
        assert "torch backend" in str(e), e
    rec["reducer_cases"] = sorted(cases)

# 7. KerasState: restore, then sync from rank 0 after a reset.
model = line_model()
model.compile(optimizer=K.DistributedOptimizer(keras.optimizers.SGD(0.1,
              momentum=0.9)), loss="mse")
model.fit(x, y, batch_size=32, epochs=1, verbose=0,
          callbacks=[K.callbacks.BroadcastGlobalVariablesCallback(0)])
state = K.elastic.KerasState(model, epoch=0)
w0 = model.get_weights()
state.commit()
model.set_weights([w * 0 for w in w0])
state.restore()
assert all((a == b).all() for a, b in zip(model.get_weights(), w0))
model.set_weights([w + RANK for w in w0])
state.epoch = 5 + RANK
state.save()
# A reset re-forms the world at the endpoints the elastic driver hands
# out for the new epoch: here rank 0 picks them and broadcasts them.
ports = np.zeros(2, np.int64)
if RANK == 0:
    import socket
    socks = [socket.socket() for _ in range(2)]
    for sock in socks:
        sock.bind(("127.0.0.1", 0))
    ports = np.array([sock.getsockname()[1] for sock in socks], np.int64)
    for sock in socks:
        sock.close()
ports = K.broadcast(ports, 0, name="reset.ports")
os.environ["HOROVOD_TPU_COORDINATOR"] = f"127.0.0.1:{int(ports[0])}"
os.environ["HOROVOD_CONTROLLER_ADDR"] = f"127.0.0.1:{int(ports[1])}"
K.elastic._reset()
state.sync()
assert state.epoch == 5, state.epoch
assert all((a == b).all() for a, b in zip(model.get_weights(), w0))
rec["sync_w"] = weights(model)
rec["sync_opt"] = [np.asarray(v).tolist() for v in model.optimizer.variables]
rec["durable"] = sorted(state.durable_state_dict())

with open(os.path.join(os.environ["RESULT_DIR"], f"{PKG}-{RANK}.json"),
          "w") as f:
    json.dump(rec, f)
print("KERAS CASES DONE", RANK, flush=True)
"""


def _world(pkg, result_dir):
    env = {"KERAS_BACKEND": "torch", "RESULT_DIR": result_dir}
    code = _HEAD[pkg] + _BODY
    if pkg == "jax":
        results = run_workers(code, nproc=2, timeout=TIMEOUT_S,
                              extra_env=env)
    else:
        results = run_port_workers(code, nproc=2, extra_env=env,
                                   timeout=TIMEOUT_S)
    assert_all_ok(results)
    recs = []
    for r in range(2):
        with open(os.path.join(result_dir, f"{pkg}-{r}.json")) as f:
            recs.append(json.load(f))
    return recs


# The port under KERAS_BACKEND=jax: every entry point that reaches Keras
# refuses it, before any collective.
_JAX_BACKEND = """
import keras
assert keras.backend.backend() == "jax", keras.backend.backend()
import horovod_tpu_torch.keras as hvd
for call in (lambda: hvd.DistributedOptimizer(keras.optimizers.SGD(0.1)),
             lambda: hvd.broadcast_variables([keras.Variable(1.0)], 0)):
    try:
        call()
    except ValueError as e:
        assert "torch and tensorflow Keras backends" in str(e), e
    else:
        raise SystemExit("KERAS_BACKEND=jax was not refused")
print("JAX BACKEND REFUSED", flush=True)
"""


def _jax_backend_run():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(KERAS_BACKEND="jax", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _JAX_BACKEND], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both packages' two-rank worlds, and the port under
    KERAS_BACKEND=jax, side by side."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {pkg: pool.submit(
            _world, pkg, str(tmp_path_factory.mktemp(f"keras-{pkg}")))
            for pkg in ("port", "jax")}
        futures["jax_backend"] = pool.submit(_jax_backend_run)
        return {name: f.result() for name, f in futures.items()}


_FIELDS = {
    "fit": ("fit_loss", "fit_w"),
    "backward_passes_per_step": ("bps_loss", "bps_w"),
    "fp16_compression": ("fp16_loss", "fp16_w"),
    "lr_schedule_and_warmup": ("sched_lr", "warm_lr", "warm_w"),
    "load_model": ("load_loss", "load_w"),
    "keras_state_sync": ("sync_w", "sync_opt", "durable"),
}


# Equal on both ranks too: rates, the weights of every fit that starts
# with the broadcast callback, and the metric-averaged loss (the other
# losses are each rank's own).
_SAME_ON_EVERY_RANK = {"fit_loss", "fit_w", "bps_w", "fp16_w", "sched_lr",
                       "warm_lr", "load_w", "sync_w", "sync_opt"}


@pytest.mark.parametrize("case", sorted(_FIELDS))
def test_two_rank_keras_matches_jax(worlds, case):
    """Each case's losses, rates and weights are equal across the two
    packages on both ranks; weights and rates also across the ranks."""
    port, jax = worlds["port"], worlds["jax"]
    for field in _FIELDS[case]:
        for r in range(2):
            assert port[r][field] == jax[r][field], (field, r)
        if field in _SAME_ON_EVERY_RANK:
            assert port[0][field] == port[1][field], field


def test_reducer_never_touches_numpy(worlds):
    """Every reducer case ran in the port's world with numpy conversion
    refused, bit-equal to ``grouped_allreduce``."""
    for r in range(2):
        assert worlds["port"][r]["reducer_cases"] == \
            ["average", "fp16", "predivide"]


def test_broadcasts_meet_across_divergent_keras_names(worlds):
    """Rank 0 built one more model, so Keras named the ranks' variables
    differently: the port's broadcasts, named by place, still meet (the
    JAX package's, named by Keras's names, would wait on each other)."""
    assert all(rec["divergent_names"] for rec in worlds["port"])


def test_jax_backend_is_refused(worlds):
    """``KERAS_BACKEND=jax``: the port's entry points raise a
    ``ValueError`` naming the backends it serves."""
    out = worlds["jax_backend"]
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX BACKEND REFUSED" in out.stdout
