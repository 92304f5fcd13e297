"""The port's user entry points on the CPU: the ``horovod`` drop-in
alias (``horovod_tpu_torch/_alias``) and the PyTorch examples under
``horovod_tpu_torch/examples/``, each launched as a user launches it
(``python -m horovod_tpu_torch.runner.launch ...``, ``--device cpu``)
beside the JAX package's example with the same arguments:

* ``pytorch/pytorch_synthetic_benchmark.py``: the same printed lines,
  img/s values masked;
* ``pytorch/pytorch_mnist.py``: every printed loss and accuracy equal
  (an average of two ranks is exact);
* ``elastic/pytorch/pytorch_synthetic_benchmark_elastic.py``: through
  the port's elastic launcher, the lines of the JAX example launched
  statically;
* ``elastic/torch_elastic_train.py``: the JAX example's lines at two
  ranks, and through the port's elastic launcher a world that grows
  2 -> 3 mid-run resumes from its committed epoch;
* ``adasum/adasum_bert_pretrain.py --tiny``: each step's loss within
  1e-5 of the same torch BERT-tiny driven by the JAX package's torch
  binding (``horovod_tpu/torch/optimizer.py``'s Adasum delta rule);
* ``parallel/resnet50_synthetic_benchmark.py`` at one and two ranks:
  the JAX example's lines (two devices in one process);
* ``parallel/gpt_sharded_train.py`` at four ranks: losses finite and
  falling, as the JAX example's at the same arguments;
* ``torch/torch_checkpoint_resume.py``: a relaunch resumes at the saved
  step and weight and prints what an uninterrupted run prints;
* ``spark/pytorch_estimator_example.py``: the fitted model's
  predictions equal the JAX example's within 1e-4 at the same seed;
* ``ray/``: no ray is installed, so the scripts are compiled only.

And the alias: every ``horovod.*`` name of
``tests/test_reference_compat.py`` resolves to the port's module with
the same surface, importing it loads no JAX, and an upstream-style
script (``import horovod.torch as hvd``) launched by the port's launcher
reaches the port even with the repository root (whose ``horovod/`` is
the JAX package's alias) on ``PYTHONPATH``.

The launches run in a pool of threads, started once for the module.
"""

import concurrent.futures
import json
import os
import py_compile
import re
import subprocess
import sys
import textwrap
import threading

import pytest

from multiproc import REPO

pytestmark = pytest.mark.multiproc

JAX_EX = os.path.join(REPO, "examples")
PORT_EX = os.path.join(REPO, "horovod_tpu_torch", "examples")
ALIAS_DIR = os.path.join(REPO, "horovod_tpu_torch", "_alias")
LAUNCH_TIMEOUT_S = 150
# The JAX package's examples and the port's counterparts; None where
# the README's table gives the reason there is none.
COUNTERPARTS = {
    "pytorch/pytorch_synthetic_benchmark.py":
        "pytorch/pytorch_synthetic_benchmark.py",
    "pytorch/pytorch_mnist.py": "pytorch/pytorch_mnist.py",
    "elastic/pytorch/pytorch_synthetic_benchmark_elastic.py":
        "elastic/pytorch/pytorch_synthetic_benchmark_elastic.py",
    "elastic/jax_elastic_train.py": "elastic/torch_elastic_train.py",
    "adasum/adasum_bert_pretrain.py": "adasum/adasum_bert_pretrain.py",
    "jax/jax_synthetic_benchmark.py":
        "parallel/resnet50_synthetic_benchmark.py",
    "jax/gpt_sharded_train.py": "parallel/gpt_sharded_train.py",
    "jax/jax_checkpoint_resume.py": "torch/torch_checkpoint_resume.py",
    "keras/keras_mnist.py": "keras/keras_mnist.py",
    "keras/keras_mnist_advanced.py": "keras/keras_mnist_advanced.py",
    "keras/keras_mnist_jax.py": None,
    "tensorflow2/tensorflow2_mnist.py": "tensorflow2/tensorflow2_mnist.py",
    "tensorflow2/tensorflow2_synthetic_benchmark.py":
        "tensorflow2/tensorflow2_synthetic_benchmark.py",
    "elastic/tensorflow2/tensorflow2_resnet50_elastic.py":
        "elastic/tensorflow2/tensorflow2_resnet50_elastic.py",
    "ray/pytorch_ray_elastic.py": "ray/pytorch_ray_elastic.py",
    "ray/tensorflow2_mnist_ray.py": "ray/tensorflow2_mnist_ray.py",
    "spark/pytorch_estimator_example.py":
        "spark/pytorch_estimator_example.py",
    "spark/keras_estimator_example.py": "spark/keras_estimator_example.py",
}
_PREFIX = re.compile(r"^\[(\d+)\]<stdout>:(.*)$")
_NUMBER = re.compile(r"\d+(\.\d+)?")


def env_for(tmp, **extra):
    """A launcher's environment: the repository on ``PYTHONPATH`` (the
    JAX examples need it; the port's launcher adds its own entries),
    the JAX workers on the CPU, and one thread per process for both
    packages alike (the launches run several at a time)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "HOROVOD_RANK")}
    env.update(PYTHONPATH=REPO, HOROVOD_TPU_FORCE_CPU="1",
               JAX_PLATFORMS="cpu", HOROVOD_START_TIMEOUT="60",
               OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    env.update(extra)
    return env


def run(cmd, cwd, env, timeout=LAUNCH_TIMEOUT_S):
    """(returncode, output) of ``cmd`` in its own session, killed past
    ``timeout``."""
    from horovod_tpu_torch.runner.safe_shell_exec import \
        terminate_process_tree
    p = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        terminate_process_tree(p.pid, grace_s=1.0)
        out, _ = p.communicate()
        return -9, out.decode(errors="replace")
    return p.returncode, out.decode(errors="replace")


def launch(pkg, np_, script, args, tmp, elastic=False, python_args=(),
           timeout=LAUNCH_TIMEOUT_S, **env_extra):
    """``python -m <pkg>.runner.launch -np N ... python <script> args``
    from ``tmp``, killed past ``timeout``; with ``elastic`` through a
    discovery script that reports ``localhost:N``."""
    tmp.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", f"{pkg}.runner.launch", "-np", str(np_)]
    if elastic:
        (tmp / "hosts.txt").write_text(f"localhost:{np_}\n")
        disc = tmp / "discover.sh"
        disc.write_text(f"#!/bin/sh\ncat {tmp / 'hosts.txt'}\n")
        disc.chmod(0o755)
        cmd += ["--min-np", str(np_), "--max-np", str(np_),
                "--host-discovery-script", str(disc)]
    else:
        cmd += ["-H", f"localhost:{np_}"]
    cmd += [sys.executable, *python_args, script, *args]
    return run(cmd, str(tmp), env_for(tmp, **env_extra), timeout)


def stdout_lines(out):
    """The workers' standard output, ``rank:text`` per line, ranks in
    order, each rank's lines in the order it printed them."""
    by_rank = {}
    # Split at newlines only: Keras's progress bar redraws with "\r".
    for line in out.split("\n"):
        m = _PREFIX.match(line)
        if m:
            by_rank.setdefault(int(m.group(1)), []).append(m.group(2))
    return [f"{r}:{t}" for r in sorted(by_rank) for t in by_rank[r]]


def masked(lines):
    """``rank:text`` lines with every number of the text masked."""
    out = []
    for line in lines:
        rank, _, text = line.partition(":")
        out.append(f"{rank}:{_NUMBER.sub('#', text)}")
    return out


def ok(result):
    code, out = result
    assert code == 0, out[-6000:]
    return out


def port(path):
    return os.path.join(PORT_EX, path)


def jax(path):
    return os.path.join(JAX_EX, path)


# ---------------------------------------------------------------------------
# the launches, run in threads once for the module
# ---------------------------------------------------------------------------
BENCH_ARGS = ["--batch-size", "2", "--num-warmup-batches", "1",
              "--num-batches-per-iter", "1", "--num-iters", "2"]
MNIST_ARGS = ["--epochs", "1", "--data-size", "512", "--batch-size", "32"]
RESNET_ARGS = ["--batch-size", "4", "--image-size", "32",
               "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
               "--num-iters", "1"]
GPT_ARGS = ["--dp", "2", "--tp", "2", "--steps", "5", "--batch-size", "4",
            "--seq-len", "16"]
ADASUM_STEPS = 3
ESTIMATOR_ARGS = ["--epochs", "2", "--num-proc", "2", "--run-id", "ex"]

# The adasum example's model, optimizer and batches, driven by the JAX
# package's torch binding: its DistributedOptimizer(op=Adasum) applies
# the same delta rule (horovod_tpu/torch/optimizer.py).
_ADASUM_JAX_BINDING = """
import sys
import torch
import horovod_tpu.torch as hvd
from horovod_tpu_torch.models.bert import (BertForMaskedLM,
                                           bert_tiny_config, mlm_loss)
from horovod_tpu_torch.training import make_bert_batch

hvd.init()
config = bert_tiny_config(attention_impl="einsum")
model = BertForMaskedLM(config, device="cpu", seed=0)
batch = make_bert_batch(8, 128, config.vocab_size, seed=hvd.rank())
opt = hvd.DistributedOptimizer(
    torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
    named_parameters=model.named_parameters(), op=hvd.Adasum)
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
for step in range(int(sys.argv[1])):
    opt.zero_grad()
    loss = mlm_loss(model(batch["input_ids"], deterministic=True),
                    batch["labels"], batch["mask"])
    loss.backward()
    opt.step()
    print("LOSS " + repr(loss.item()), flush=True)
"""

# Runs an estimator example in this process with torch's (and Keras's)
# generators seeded first, so that both packages' examples build the
# same weights, then prints the fitted model's predictions.
_SEEDED = """
import os, runpy, sys
import numpy as np
import torch
torch.manual_seed(0)
if os.environ.get("KERAS_BACKEND"):
    import keras
    keras.utils.set_random_seed(0)
path = sys.argv[1]
sys.argv = sys.argv[1:]
g = runpy.run_path(path, run_name="__main__")
print("PRED " + repr([float(np.asarray(v).reshape(-1)[0])
                      for v in g["pred"]["y__output"]]), flush=True)
"""


def _checkpoint_runs(tmp):
    """Two launches into one directory (2 epochs, then 4) and one
    uninterrupted launch of 4 epochs into another."""
    script = port("torch/torch_checkpoint_resume.py")
    common = ["--lr", "0.01", "--device", "cpu"]
    first = launch("horovod_tpu_torch", 2, script,
                   ["--epochs", "2", "--dir", str(tmp / "a")] + common,
                   tmp / "first")
    second = launch("horovod_tpu_torch", 2, script,
                    ["--epochs", "4", "--dir", str(tmp / "a")] + common,
                    tmp / "second")
    whole = launch("horovod_tpu_torch", 2, script,
                   ["--epochs", "4", "--dir", str(tmp / "b")] + common,
                   tmp / "whole")
    return first, second, whole


def _adasum_runs(tmp):
    report = tmp / "report"
    ported = launch("horovod_tpu_torch", 2,
                    port("adasum/adasum_bert_pretrain.py"),
                    ["--tiny", "--steps", str(ADASUM_STEPS), "--device",
                     "cpu", "--report", str(report)], tmp / "port")
    (tmp / "jax").mkdir(parents=True, exist_ok=True)
    script = tmp / "jax" / "binding.py"
    script.write_text(_ADASUM_JAX_BINDING)
    binding = launch("horovod_tpu", 2, str(script), [str(ADASUM_STEPS)],
                     tmp / "jax")
    return ported, binding, report


def _jobs(tmp):
    """name -> (function, args) of every launch of the module."""
    bench = "pytorch/pytorch_synthetic_benchmark.py"
    mnist = "pytorch/pytorch_mnist.py"
    elastic = "elastic/pytorch/pytorch_synthetic_benchmark_elastic.py"
    cpu = ["--device", "cpu"]
    estimator = "spark/pytorch_estimator_example.py"
    return {
        "adasum": (_adasum_runs, (tmp / "adasum",)),
        "resnet_jax": (run, (
            [sys.executable, jax("jax/jax_synthetic_benchmark.py")] +
            RESNET_ARGS, str(tmp), env_for(
                tmp, XLA_FLAGS="--xla_force_host_platform_device_count=2"))),
        "gpt_jax": (run, (
            [sys.executable, jax("jax/gpt_sharded_train.py")] + GPT_ARGS,
            str(tmp), env_for(
                tmp, XLA_FLAGS="--xla_force_host_platform_device_count=4"))),
        "gpt_port": (launch, ("horovod_tpu_torch", 4,
                              port("parallel/gpt_sharded_train.py"),
                              GPT_ARGS + cpu, tmp / "gpt")),
        "estimator_jax": (launch, (
            "horovod_tpu", 1, jax(estimator), ESTIMATOR_ARGS + [
                "--work-dir", str(tmp / "est_jax" / "store")],
            tmp / "est_jax"), {"python_args": ("-c", _SEEDED)}),
        "estimator_port": (launch, (
            "horovod_tpu_torch", 1, port(estimator), ESTIMATOR_ARGS + cpu + [
                "--work-dir", str(tmp / "est_port" / "store")],
            tmp / "est_port"), {"python_args": ("-c", _SEEDED)}),
        "resnet_port_1": (launch, ("horovod_tpu_torch", 1,
                                   port("parallel/"
                                        "resnet50_synthetic_benchmark.py"),
                                   RESNET_ARGS + cpu, tmp / "resnet1")),
        "resnet_port_2": (launch, ("horovod_tpu_torch", 2,
                                   port("parallel/"
                                        "resnet50_synthetic_benchmark.py"),
                                   RESNET_ARGS + cpu, tmp / "resnet2")),
        "bench_jax": (launch, ("horovod_tpu", 2, jax(bench), BENCH_ARGS,
                               tmp / "bench_jax")),
        "bench_port": (launch, ("horovod_tpu_torch", 2, port(bench),
                                BENCH_ARGS + cpu, tmp / "bench_port")),
        "mnist_jax": (launch, ("horovod_tpu", 2, jax(mnist), MNIST_ARGS,
                               tmp / "mnist_jax")),
        "mnist_port": (launch, ("horovod_tpu_torch", 2, port(mnist),
                                MNIST_ARGS + cpu, tmp / "mnist_port")),
        # The JAX example statically: the JAX package's elastic workers
        # can die in jax.distributed's shutdown barrier, and its elastic
        # launcher then waits for a replacement.
        "elastic_jax": (launch, ("horovod_tpu", 2, jax(elastic), BENCH_ARGS,
                                 tmp / "elastic_jax")),
        "elastic_port": (launch, ("horovod_tpu_torch", 2, port(elastic),
                                  BENCH_ARGS + cpu, tmp / "elastic_port"),
                         {"elastic": True}),
        "train_jax": (launch, ("horovod_tpu", 2,
                               jax("elastic/jax_elastic_train.py"), [],
                               tmp / "train_jax")),
        "train_port": (launch, ("horovod_tpu_torch", 2,
                                port("elastic/torch_elastic_train.py"), cpu,
                                tmp / "train_port")),
        "checkpoint": (_checkpoint_runs, (tmp / "checkpoint",)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the module, started at once in a pool of threads;
    ``runs[name]`` waits for its result."""
    tmp = tmp_path_factory.mktemp("examples")
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futures = {}
    for name, job in _jobs(tmp).items():
        fn, args = job[0], job[1]
        kwargs = job[2] if len(job) > 2 else {}
        futures[name] = pool.submit(fn, *args, **kwargs)

    class Results(dict):
        def __missing__(self, name):
            value = futures[name].result(timeout=3 * LAUNCH_TIMEOUT_S)
            self[name] = value
            return value

    yield Results()
    pool.shutdown(wait=True, cancel_futures=True)


# ---------------------------------------------------------------------------
# the examples against the JAX package's
# ---------------------------------------------------------------------------
def test_every_jax_example_has_a_counterpart_or_a_reason():
    jax_examples = sorted(
        os.path.relpath(os.path.join(d, f), JAX_EX)
        for d, _, files in os.walk(JAX_EX) for f in files
        if f.endswith(".py"))
    assert jax_examples == sorted(COUNTERPARTS)
    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    for ours in COUNTERPARTS.values():
        if ours is not None:
            assert os.path.exists(port(ours)), ours
    # The one without a counterpart is named in the README's table with
    # its reason.
    row = [line for line in readme.splitlines()
           if "keras_mnist_jax.py" in line and line.startswith("|")]
    assert row and "not ported" in row[0], row


@pytest.mark.parametrize("path", sorted(p for p in COUNTERPARTS.values()
                                        if p is not None))
def test_example_compiles(path, tmp_path):
    py_compile.compile(port(path), cfile=str(tmp_path / "out.pyc"),
                       doraise=True)


def test_synthetic_benchmark_prints_the_jax_lines(runs):
    jax_lines = stdout_lines(ok(runs["bench_jax"]))
    port_lines = stdout_lines(ok(runs["bench_port"]))
    assert "0:Total img/sec on 2 worker(s): " in "\n".join(port_lines)
    assert masked(port_lines) == masked(jax_lines)


def test_mnist_losses_and_accuracy_equal_the_jax_example(runs):
    jax_lines = stdout_lines(ok(runs["mnist_jax"]))
    port_lines = stdout_lines(ok(runs["mnist_port"]))
    assert any("Test set: Average loss" in t for t in port_lines)
    assert port_lines == jax_lines


def test_elastic_benchmark_through_the_elastic_launcher(runs):
    jax_lines = stdout_lines(ok(runs["elastic_jax"]))
    port_lines = stdout_lines(ok(runs["elastic_port"]))
    assert "0:Running benchmark on 2 worker(s), resuming from batch 0" \
        in port_lines
    assert masked(port_lines) == masked(jax_lines)


def test_elastic_train_prints_the_jax_lines(runs):
    jax_lines = stdout_lines(ok(runs["train_jax"]))
    port_lines = stdout_lines(ok(runs["train_port"]))
    assert port_lines[-1].startswith("0:final w: ")
    assert port_lines == jax_lines


def test_elastic_train_resumes_its_commit_when_the_world_grows(tmp_path):
    """Through the port's elastic launcher at 2 ranks, whose discovery
    script reports a third slot as soon as the driver has planned the
    first world.  The two first workers' reset callbacks fire, the
    epochs go on from the committed one at size 3 (the epoch committed
    when the interrupt came is not printed, none is repeated) and the
    run ends at the last epoch."""
    from horovod_tpu_torch.runner.safe_shell_exec import \
        terminate_process_tree
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("localhost:2\n")
    disc = tmp_path / "discover.sh"
    disc.write_text(f"#!/bin/sh\ncat {hosts}\n")
    disc.chmod(0o755)
    epochs = 40
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "-np", "2", "--min-np", "2", "--max-np", "3",
           "--host-discovery-script", str(disc), sys.executable,
           port("elastic/torch_elastic_train.py"), "--device", "cpu",
           "--epochs", str(epochs)]
    # Unbuffered, so that the launcher passes each line on as it comes.
    p = subprocess.Popen(cmd, cwd=str(tmp_path), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         env=env_for(tmp_path, PYTHONUNBUFFERED="1"),
                         start_new_session=True)
    lines = []

    def pump():
        for line in p.stdout:
            lines.append(line)
            if "epoch 1 planned, size=2" in line:
                hosts.write_text("localhost:3\n")

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        p.wait(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        terminate_process_tree(p.pid, grace_s=1.0)
        p.wait()
    reader.join(timeout=30)
    out = "".join(lines)
    assert p.returncode == 0, out[-6000:]
    printed = [(int(e), int(s)) for e, s in
               re.findall(r"<stdout>:epoch (\d+) size=(\d+) ", out)]
    sizes = [s for _, s in printed]
    assert sizes[-1] == 3 and sizes == sorted(sizes), printed
    numbers = [e for e, _ in printed]
    assert numbers[0] in (1, 2) and numbers[-1] == epochs, printed
    gaps = {b - a for a, b in zip(numbers, numbers[1:])}
    assert gaps <= {1, 2}, printed
    resized = re.findall(r"\[rank (\d)\] world resized to 3", out)
    assert sorted(resized) == ["0", "1"], out[-3000:]
    assert re.search(r"<stdout>:final w: \[ *\S+ +\S+ +\S+ +\S+ *\]", out)


def adasum_oracle(steps):
    """Both ranks' losses of the adasum example's BERT-tiny, computed in
    this process: from the seed-0 weights each rank takes its local
    AdamW step on its own batch (its own AdamW state), and the two
    deltas of every tensor merge by the plain Adasum formula
    (``ops/adasum.py``'s docstring) in float64."""
    import torch
    from horovod_tpu_torch.models.bert import (BertForMaskedLM,
                                               bert_tiny_config, mlm_loss)
    from horovod_tpu_torch.training import make_bert_batch
    config = bert_tiny_config(attention_impl="einsum")
    model = BertForMaskedLM(config, device="cpu", seed=0)
    params = list(model.parameters())
    batches = [make_bert_batch(8, 128, config.vocab_size, seed=r)
               for r in range(2)]
    opts = [torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
            for _ in range(2)]

    def merge(a, b):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        dot, na, nb = a @ b, a @ a, b @ b
        ca = 1 - dot / (2 * na) if na != 0 else 1.0
        cb = 1 - dot / (2 * nb) if nb != 0 else 1.0
        return (ca * a + cb * b).float()

    losses = {0: [], 1: []}
    for _ in range(steps):
        start = [p.detach().clone() for p in params]
        deltas = []
        for r in range(2):
            with torch.no_grad():
                for p, s in zip(params, start):
                    p.copy_(s)
            opts[r].zero_grad()
            b = batches[r]
            loss = mlm_loss(model(b["input_ids"], deterministic=True),
                            b["labels"], b["mask"])
            loss.backward()
            losses[r].append(loss.item())
            opts[r].step()
            deltas.append([p.detach() - s for p, s in zip(params, start)])
        with torch.no_grad():
            for p, s, d0, d1 in zip(params, start, *deltas):
                p.copy_(s + merge(d0, d1).view_as(p))
    return losses


def test_adasum_bert_tiny_matches_the_jax_binding(runs):
    """Every step's loss of both ranks within 1e-5 of the one-process
    oracle, and of the JAX package's torch binding up to its first
    merge: from the second merge on the binding departs from the plain
    Adasum formula (step 2 by 3.3e-4 on this model), with the response
    cache, fusion and replay on or off (ROADMAP Queue 3)."""
    ported, binding, report = runs["adasum"]
    port_lines = stdout_lines(ok(ported))
    by_rank = {}
    for line in ok(binding).splitlines():
        m = re.match(r"^\[(\d)\]<stdout>:LOSS (\S+)$", line)
        if m:
            by_rank.setdefault(int(m.group(1)), []).append(float(m.group(2)))
    assert sorted(by_rank) == [0, 1]
    oracle = adasum_oracle(ADASUM_STEPS)
    for rank in range(2):
        with open(report / f"rank{rank}.json") as f:
            got = json.load(f)
        assert got["size"] == 2 and got["backend"] == "gloo"
        losses = got["losses"]
        assert len(losses) == len(by_rank[rank]) == ADASUM_STEPS
        assert max(abs(a - b) for a, b in
                   zip(losses, oracle[rank])) <= 1e-5, (losses, oracle)
        assert max(abs(a - b) for a, b in
                   zip(losses[:2], by_rank[rank][:2])) <= 1e-5, \
            (losses, by_rank[rank])
        adasums = sum(n for k, n in got["after"]["collectives"].items()
                      if "op=ADASUM" in k)
        assert adasums > 0, got["after"]
    # Rank 0 prints the JAX example's line per step.
    assert masked(port_lines) == ["0:step # loss #"] * ADASUM_STEPS
    # The merged steps move the loss.
    assert oracle[0][-1] < oracle[0][0]


def test_resnet_benchmark_on_the_mesh_prints_the_jax_lines(runs):
    jax_lines = [t for t in ok(runs["resnet_jax"]).splitlines()
                 if t.startswith(("ResNet-50", "Iter #", "Img/sec"))]
    want = masked(f"0:{t}" for t in jax_lines)
    for name in ("resnet_port_1", "resnet_port_2"):
        lines = stdout_lines(ok(runs[name]))
        assert masked(lines) == want, (name, lines, jax_lines)
    assert stdout_lines(ok(runs["resnet_port_2"]))[0] == \
        "0:ResNet-50, global batch 4, 2 chips, dtype bfloat16"


def test_gpt_sharded_losses_fall_as_the_jax_examples(runs):
    def losses(text):
        return [float(x) for x in
                re.findall(r"step +\d+  loss ([\d.]+)", text)]
    jax_losses = losses(ok(runs["gpt_jax"]))
    port_losses = losses(ok(runs["gpt_port"]))
    for got in (jax_losses, port_losses):
        assert len(got) == 2 and all(x == x and x < 1e3 for x in got)
        assert got[1] < got[0], got


def test_checkpoint_resumes_the_saved_step_and_weight(runs):
    first, second, whole = (stdout_lines(ok(r))
                            for r in runs["checkpoint"])
    saved = re.search(r"epoch 1: w=(\S+) \(checkpointed step 2\)",
                      "\n".join(first)).group(1)
    assert second[0] == f"0:resumed from step 2: w={saved}", second
    # The resumed run prints what the uninterrupted one does from there.
    assert second[1:] == whole[2:], (second, whole)
    assert whole[-1].startswith("0:final w=")


def test_torch_estimator_predicts_as_the_jax_example(runs):
    def preds(result):
        out = ok(result)
        return json.loads(re.search(r"<stdout>:PRED (\[.*\])",
                                    out).group(1)), stdout_lines(out)
    jax_pred, jax_lines = preds(runs["estimator_jax"])
    port_pred, port_lines = preds(runs["estimator_port"])
    assert len(port_pred) == 4
    assert max(abs(a - b) for a, b in zip(port_pred, jax_pred)) <= 1e-4
    # The lines up to the resume's: the JAX trainer resumes without its
    # Adam state, the port's with it (ROADMAP Queue 3), so the
    # resumed losses differ.
    resumed = [i for i, t in enumerate(port_lines) if "resumed at" in t]
    assert resumed and port_lines[:resumed[0]] == jax_lines[:resumed[0]]
    assert masked(port_lines[:-1]) == masked(jax_lines[:-1])


# ---------------------------------------------------------------------------
# the drop-in alias
# ---------------------------------------------------------------------------
_SURFACE = [
    ("torch", ["DistributedOptimizer", "broadcast_parameters",
               "broadcast_optimizer_state", "allreduce_async", "alltoall",
               "reducescatter", "join"]),
    ("tensorflow", ["DistributedGradientTape", "DistributedOptimizer",
                    "broadcast_variables", "elastic", "alltoall",
                    "reducescatter", "join"]),
    ("tensorflow.keras", ["DistributedOptimizer", "callbacks"]),
    ("keras", ["DistributedOptimizer", "callbacks"]),
    ("spark", ["run", "Store", "FilesystemStore"]),
    ("spark.keras", ["KerasEstimator", "KerasModel"]),
    ("spark.torch", ["TorchEstimator", "TorchModel"]),
    ("ray", ["RayExecutor"]),
    ("elastic", ["State", "run_fn"]),
]


def _fresh(code, tmp_path, **env_extra):
    """``code`` in a fresh interpreter from ``tmp_path`` with the alias
    directory first on its path (the repository second, as a launcher
    puts it); returns its standard output."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.pathsep.join([ALIAS_DIR, REPO]),
               KERAS_BACKEND="torch", **env_extra)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_alias_names_resolve_to_the_port(tmp_path):
    """Every ``horovod.*`` name of ``tests/test_reference_compat.py``
    is the port's module object, with the names that test expects."""
    code = textwrap.dedent(f"""
        import importlib, json
        import horovod
        surface = {_SURFACE!r}
        out = {{"version": horovod.__version__, "file": horovod.__file__}}
        for sub, names in surface:
            alias = importlib.import_module("horovod." + sub)
            impl = ("horovod_tpu_torch.common.elastic" if sub == "elastic"
                    else "horovod_tpu_torch." + sub)
            out[sub] = [alias is importlib.import_module(impl),
                        [n for n in names if not hasattr(alias, n)]]
        import horovod.torch.elastic.sampler as s
        import horovod_tpu_torch.torch.elastic.sampler as t
        out["deep"] = s is t
        print(json.dumps(out))
        """)
    got = json.loads(_fresh(code, tmp_path).strip().splitlines()[-1])
    from horovod_tpu_torch.version import __version__
    assert got.pop("version") == __version__
    assert got.pop("file") == os.path.join(ALIAS_DIR, "horovod",
                                           "__init__.py")
    assert got.pop("deep") is True
    assert got == {sub: [True, []] for sub, _ in _SURFACE}


def test_alias_loads_no_jax(tmp_path):
    code = ("import sys\n"
            "import horovod.torch, horovod_tpu_torch.torch as p\n"
            "assert horovod.torch is p\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu'))\n"
            "print(','.join(bad))\n")
    assert _fresh(code, tmp_path).strip() == ""


def test_alias_of_a_missing_port_module_is_not_found(tmp_path):
    code = ("import horovod\n"
            "try:\n"
            "    import horovod.no_such_module\n"
            "except ModuleNotFoundError as e:\n"
            "    print(e.name)\n")
    assert _fresh(code, tmp_path).strip() == "horovod.no_such_module"


_UPSTREAM_SCRIPT = """
import sys
import torch
import horovod.torch as hvd

hvd.init()
import horovod_tpu_torch.torch
assert hvd is horovod_tpu_torch.torch, hvd.__file__
assert not any(m.split(".")[0] in ("jax", "horovod_tpu") for m in sys.modules)
x = torch.arange(4, dtype=torch.float32) * (hvd.rank() + 1)
y = hvd.allreduce(x, op=hvd.Sum, name="x")
assert torch.equal(y, torch.arange(4, dtype=torch.float32) * 3), y
print("ALIAS rank=%d size=%d %s" % (hvd.rank(), hvd.size(), y.tolist()))
"""


@pytest.mark.parametrize("root_on_path", [False, True],
                         ids=["plain", "repo_root_on_pythonpath"])
def test_upstream_script_reaches_the_port_through_the_launcher(
        root_on_path, tmp_path):
    """An upstream-style script at two ranks through the port's launcher,
    from a directory outside the repository.  With the repository root
    on ``PYTHONPATH`` its ``horovod/`` (the JAX package's alias) would
    come first if the launcher only kept the caller's path."""
    script = tmp_path / "train.py"
    script.write_text(_UPSTREAM_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(HOROVOD_START_TIMEOUT="60")
    if root_on_path:
        env["PYTHONPATH"] = REPO
    # The launcher itself must find the package: run it from the root.
    code, out = run([sys.executable, "-m", "horovod_tpu_torch.runner.launch",
                     "-np", "2", "-H", "localhost:2", sys.executable,
                     str(script)], REPO, env)
    assert code == 0, out[-6000:]
    lines = sorted(t for t in stdout_lines(out) if "ALIAS" in t)
    assert lines == ["0:ALIAS rank=0 size=2 [0.0, 3.0, 6.0, 9.0]",
                     "1:ALIAS rank=1 size=2 [0.0, 3.0, 6.0, 9.0]"], out[-3000:]


def test_worker_pythonpath_puts_the_alias_first(monkeypatch):
    from horovod_tpu_torch._alias import (ALIAS_DIR as alias,
                                          PACKAGE_ROOT, install,
                                          worker_pythonpath)
    assert alias == ALIAS_DIR and PACKAGE_ROOT == REPO
    got = worker_pythonpath(os.pathsep.join([REPO, "/x", ALIAS_DIR, ""]))
    assert got.split(os.pathsep) == [ALIAS_DIR, REPO, "/x"]
    assert worker_pythonpath(None).split(os.pathsep) == [ALIAS_DIR, REPO]
    # In place (a Spark task, a Ray actor): this process's path and the
    # one its children inherit.
    monkeypatch.setattr(sys, "path", ["/y", ALIAS_DIR])
    monkeypatch.setenv("PYTHONPATH", "/y")
    install()
    assert sys.path == [ALIAS_DIR, "/y"]
    assert os.environ["PYTHONPATH"].split(os.pathsep) == \
        [ALIAS_DIR, REPO, "/y"]
