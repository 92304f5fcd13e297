"""The port's Keras and TensorFlow examples on the CPU, each launched at
two ranks as a user launches it beside the JAX package's example with
the same arguments (both on Keras's torch backend, ``KERAS_BACKEND=torch``;
the card's machine has neither Keras nor TensorFlow):

* ``keras/keras_mnist.py --synthetic`` and ``keras_mnist_advanced.py``:
  the same lines, numbers masked and Keras's progress bars (whose
  updates Keras throttles by time) left out; the JAX advanced example's
  rank-0 checkpoint is redirected from its fixed ``/tmp`` path into the
  test's directory;
* ``tensorflow2/tensorflow2_mnist.py``,
  ``tensorflow2_synthetic_benchmark.py`` (MobileNetV3Small, batch 1) and
  ``elastic/tensorflow2/tensorflow2_resnet50_elastic.py`` (its ``simple``
  model): the same lines, numbers masked;
* ``spark/keras_estimator_example.py``: the fitted model's predictions
  equal the JAX example's within 1e-4 at the same seed, and the same
  lines.

Losses of a Keras fit equal to the JAX package's on the same weights are
held by ``tests/test_torch_port_keras.py``; these examples draw their
weights unseeded, as the JAX ones do.  The launches run in a pool of
threads, started once for the module.
"""

import concurrent.futures
import json
import re

import pytest

from test_torch_port_examples import (LAUNCH_TIMEOUT_S, _SEEDED, jax,
                                      launch, masked, ok, port,
                                      stdout_lines)

pytestmark = pytest.mark.multiproc

_ANSI = re.compile(r"\x1b\[[0-9;]*m")

# The JAX advanced example writes rank 0's checkpoint to a fixed /tmp
# path: run it with Keras's ModelCheckpoint pointed at the working
# directory instead.
_REDIRECTED = """
import os, runpy, sys
import keras
class _Here(keras.callbacks.ModelCheckpoint):
    def __init__(self, filepath, *a, **k):
        super().__init__(os.path.join(os.getcwd(),
                                      os.path.basename(filepath)), *a, **k)
keras.callbacks.ModelCheckpoint = _Here
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
"""

KERAS = dict(KERAS_BACKEND="torch")
MNIST_ARGS = ["--synthetic", "--epochs", "1", "--batch-size", "256"]
ADVANCED_ARGS = ["--epochs", "2", "--data-size", "256", "--batch-size",
                 "64", "--warmup-epochs", "1"]
TF_MNIST_ARGS = ["--steps", "3", "--batch-size", "16", "--data-size", "64"]
TF_BENCH_ARGS = ["--model", "MobileNetV3Small", "--batch-size", "1",
                 "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
                 "--num-iters", "2"]
TF_ELASTIC_ARGS = ["--model", "simple", "--image-size", "32",
                   "--batch-size", "2", "--num-warmup-batches", "1",
                   "--num-batches-per-iter", "1", "--num-iters", "2"]
ESTIMATOR_ARGS = ["--epochs", "2", "--num-proc", "2", "--run-id", "ex"]
# The estimator example fits twice (a fit, then a resume), each through
# LocalBackend(2): the launched rank, then two fresh ranks for each fit,
# every one importing Keras and torch.  Alone on the CPU its launch
# takes 59 to 72 s where every other launch here takes 20 to 30 s, so
# the shared LAUNCH_TIMEOUT_S leaves it the least headroom of the
# module: under load it is the first launch to cross the limit.  It
# gets the same headroom over its own time as the others get over
# theirs.
ESTIMATOR_TIMEOUT_S = 3 * LAUNCH_TIMEOUT_S
CPU = ["--device", "cpu"]


def _jobs(tmp):
    mnist = "keras/keras_mnist.py"
    advanced = "keras/keras_mnist_advanced.py"
    tf_mnist = "tensorflow2/tensorflow2_mnist.py"
    tf_bench = "tensorflow2/tensorflow2_synthetic_benchmark.py"
    tf_elastic = "elastic/tensorflow2/tensorflow2_resnet50_elastic.py"
    estimator = "spark/keras_estimator_example.py"
    return {
        "estimator_jax": (
            "horovod_tpu", 1, jax(estimator), ESTIMATOR_ARGS + [
                "--work-dir", str(tmp / "est_jax" / "store")],
            tmp / "est_jax", dict(KERAS, python_args=("-c", _SEEDED),
                                  timeout=ESTIMATOR_TIMEOUT_S)),
        "estimator_port": (
            "horovod_tpu_torch", 1, port(estimator), ESTIMATOR_ARGS + CPU + [
                "--work-dir", str(tmp / "est_port" / "store")],
            tmp / "est_port", dict(KERAS, python_args=("-c", _SEEDED),
                                   timeout=ESTIMATOR_TIMEOUT_S)),
        "mnist_jax": ("horovod_tpu", 2, jax(mnist), MNIST_ARGS,
                      tmp / "mnist_jax", KERAS),
        "mnist_port": ("horovod_tpu_torch", 2, port(mnist), MNIST_ARGS + CPU,
                       tmp / "mnist_port", KERAS),
        "advanced_jax": ("horovod_tpu", 2, jax(advanced), ADVANCED_ARGS,
                         tmp / "advanced_jax",
                         dict(KERAS, python_args=("-c", _REDIRECTED))),
        "advanced_port": ("horovod_tpu_torch", 2, port(advanced),
                          ADVANCED_ARGS + CPU, tmp / "advanced_port", KERAS),
        "tf_mnist_jax": ("horovod_tpu", 2, jax(tf_mnist), TF_MNIST_ARGS,
                         tmp / "tf_mnist_jax", {}),
        "tf_mnist_port": ("horovod_tpu_torch", 2, port(tf_mnist),
                          TF_MNIST_ARGS, tmp / "tf_mnist_port", {}),
        "tf_bench_jax": ("horovod_tpu", 2, jax(tf_bench), TF_BENCH_ARGS,
                         tmp / "tf_bench_jax", {}),
        "tf_bench_port": ("horovod_tpu_torch", 2, port(tf_bench),
                          TF_BENCH_ARGS, tmp / "tf_bench_port", {}),
        "tf_elastic_jax": ("horovod_tpu", 2, jax(tf_elastic),
                           TF_ELASTIC_ARGS, tmp / "tf_elastic_jax", {}),
        "tf_elastic_port": ("horovod_tpu_torch", 2, port(tf_elastic),
                            TF_ELASTIC_ARGS, tmp / "tf_elastic_port", {}),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples_keras_tf")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futures = {}
    for name, (pkg, np_, script, args, cwd, extra) in _jobs(tmp).items():
        futures[name] = pool.submit(launch, pkg, np_, script, args, cwd,
                                    **extra)

    class Results(dict):
        def __missing__(self, name):
            value = futures[name].result(
                timeout=ESTIMATOR_TIMEOUT_S + 3 * LAUNCH_TIMEOUT_S)
            self[name] = value
            return value

    yield Results()
    pool.shutdown(wait=True, cancel_futures=True)


def keras_lines(result):
    """The workers' lines without ANSI colours and without Keras's
    progress bars, numbers masked."""
    lines = [_ANSI.sub("", t) for t in stdout_lines(ok(result))]
    return masked(t for t in lines if "━" not in t)


def test_keras_mnist_prints_the_jax_lines(runs):
    jax_lines = keras_lines(runs["mnist_jax"])
    port_lines = keras_lines(runs["mnist_port"])
    assert port_lines[-1] == "0:done"
    assert port_lines == jax_lines
    bars = [t for t in stdout_lines(ok(runs["mnist_port"])) if "━" in t]
    assert bars and "loss:" in bars[-1]


def test_keras_mnist_advanced_prints_the_jax_lines(runs):
    jax_lines = keras_lines(runs["advanced_jax"])
    port_lines = keras_lines(runs["advanced_port"])
    assert any("Test loss:" in t for t in port_lines)
    assert port_lines == jax_lines


@pytest.mark.parametrize("name", ["tf_mnist", "tf_bench", "tf_elastic"])
def test_tensorflow_example_prints_the_jax_lines(runs, name):
    jax_lines = masked(stdout_lines(ok(runs[f"{name}_jax"])))
    port_lines = masked(stdout_lines(ok(runs[f"{name}_port"])))
    assert port_lines
    assert port_lines == jax_lines


def test_keras_estimator_predicts_as_the_jax_example(runs):
    def preds(result):
        out = ok(result)
        return json.loads(re.search(r"<stdout>:PRED (\[.*\])",
                                    out).group(1)), stdout_lines(out)
    jax_pred, jax_lines = preds(runs["estimator_jax"])
    port_pred, port_lines = preds(runs["estimator_port"])
    assert len(port_pred) == 4
    assert max(abs(a - b) for a, b in zip(port_pred, jax_pred)) <= 1e-4
    assert masked(port_lines) == masked(jax_lines)
