"""Elastic re-formation latency measurement.

Measures the number elasticity lives or dies by: wall-clock time from a
worker's hard death (``os._exit(1)``, no cleanup) to the first
completed post-resize training step on a survivor, at nproc=3, for

  * the torch re-init path (``horovod_tpu_torch.torch.elastic`` —
    in-process re-formation of the ``torch.distributed`` group and the
    controller, committed ``TorchState`` never leaves memory), each step
    an allreduce of a 4-element tensor on the card (``--device cpu``:
    on the host);
  * the in-graph TF context-reset path (``HOROVOD_TF_ELASTIC_GRAPH=1``
    on the port's ``tensorflow`` binding — full
    ``context._reset_context()`` + cluster re-formation + retrace;
    runs only where TensorFlow is installed).

Every worker prints wall-clock (``time.time()``) stamps; all workers
run on one machine so the stamps share a clock.  The latency decomposes
into driver-side detection (the dead worker's exit must surface),
survivor unwind (HorovodInternalError → restore committed state),
rendezvous + world re-formation, and (TF only) retrace/recompile of the
train function.  The first post-resize step time is reported separately
from the steady-state step time so the one-off set-up cost is visible.

With the flight recorder armed in the workers' environment
(``HOROVOD_BLACKBOX_DIR``), the torch workers also mark the incident
for ``blackbox_merge``: the dying worker notes ``drill.fault`` and dumps
its ring before it exits, rank 0 notes ``drill.resumed`` at its first
post-resize step, and each survivor dumps its ring at the end.

Usage:
    python -m horovod_tpu_torch.tools.measure_elastic [--runs 3]
        [--paths torch tf] [--device cpu]

Prints one JSON object.  Counterpart of the JAX package's
``tools/measure_elastic.py``, whose ``jax_reinit`` scenario this
``torch_reinit`` one replaces; the layout (``localhost:2`` +
``127.0.0.1:1``, the ``127.0.0.1`` worker dying at epoch 3), the output
keys and the aggregation are the same.
"""

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TORCH_WORKER = """
import os, sys, time
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import flight_recorder as fr
from horovod_tpu_torch.ops import fusion_buffer as fb
from horovod_tpu_torch.torch.elastic import TorchState, run

hvd.init()
state = TorchState(epoch=0)
STOP = os.environ["TEST_STOP_FILE"]
DOOMED = os.environ["HOROVOD_HOSTNAME"] == os.environ["TEST_DOOMED_HOST"]
CUDA = os.environ["TEST_DEVICE"] == "cuda"
launches0 = sum(fb.launches.values())
resumed = []


def device():
    if not CUDA:
        return torch.device("cpu")
    return torch.device("cuda", hvd.local_rank() % torch.cuda.device_count())


@run
def train(state):
    while True:
        # Stop collectively: a rank that returned alone would leave the
        # others inside a collective.
        stop = hvd.allreduce(torch.tensor([float(os.path.exists(STOP))]),
                             op=hvd.Sum, name="stopflag")
        if stop.item() > 0:
            return state.epoch
        if DOOMED and state.epoch >= 3:
            print(f"DYING t={time.time():.6f}", flush=True)
            fr.note("drill.fault", victim=hvd.rank())
            fr.dump("drill.fault")
            os._exit(1)
        t0 = time.perf_counter()
        val = hvd.allreduce(torch.ones(4, device=device()), op=hvd.Sum,
                            name=f"t{state.epoch}")
        assert val[0].item() == hvd.size(), (val, hvd.size())
        ms = (time.perf_counter() - t0) * 1e3
        if hvd.size() == 2 and hvd.rank() == 0 and not resumed:
            fr.note("drill.resumed")
            resumed.append(state.epoch)
        print(f"EPOCH {state.epoch} rank={hvd.rank()} "
              f"size={hvd.size()} ms={ms:.2f} t={time.time():.6f}",
              flush=True)
        state.epoch += 1
        state.commit()
        time.sleep(0.02)

train(state)
fr.dump("drill.end.rank%d" % hvd.rank())
print(f"DONE rank={hvd.rank()} "
      f"fusion={sum(fb.launches.values()) - launches0}", flush=True)
"""

TF_WORKER = """
import os, sys, time
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
import tensorflow as tf
import horovod_tpu_torch.tensorflow as hvd

hvd.init()
STOP = os.environ["TEST_STOP_FILE"]
DOOMED = os.environ["HOROVOD_HOSTNAME"] == os.environ["TEST_DOOMED_HOST"]


def build():
    m = tf.keras.Sequential(
        [tf.keras.layers.Dense(8, input_shape=(4,)),
         tf.keras.layers.Dense(1)])
    o = tf.keras.optimizers.SGD(0.01)

    @tf.function
    def step(x, y):
        with tf.GradientTape() as tape:
            loss = tf.reduce_mean((m(x) - y) ** 2)
        tape = hvd.DistributedGradientTape(tape)
        g = tape.gradient(loss, m.trainable_variables)
        o.apply_gradients(zip(g, m.trainable_variables))
        return loss
    return m, o, step


m, o, step = build()
x, y = tf.ones((2, 4)), tf.ones((2, 1))
step(x, y)
state = hvd.elastic.TensorFlowKerasState(m, o, epoch=0)


def on_reset():
    global m, o, step
    m, o, step = build()
    step(x, y)
    state.rebuild(m, o)


state.register_reset_callbacks([on_reset])


@hvd.elastic.run
def train(state):
    while not os.path.exists(STOP):
        if DOOMED and state.epoch >= 3:
            print(f"DYING t={time.time():.6f}", flush=True)
            os._exit(1)
        t0 = time.perf_counter()
        step(x, y)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"EPOCH {state.epoch} rank={hvd.rank()} "
              f"size={hvd.size()} ms={ms:.2f} t={time.time():.6f}",
              flush=True)
        state.epoch += 1
        state.commit()
        time.sleep(0.02)
    return state.epoch


train(state)
print(f"DONE rank={hvd.rank()}", flush=True)
"""


def _scan_logs(outdir):
    text = ""
    if not os.path.isdir(outdir):
        return text
    for root, _, files in os.walk(outdir):
        for f in files:
            with open(os.path.join(root, f), errors="replace") as fh:
                text += fh.read()
    return text


def run_scenario(worker_src, extra_env, tmp, label):
    """3 workers (localhost:2 + 127.0.0.1:1), the 127.0.0.1 one
    hard-dies at epoch 3; returns the latency decomposition dict."""
    from ..runner.elastic.discovery import HostDiscoveryScript
    from ..runner.elastic_run import launch_elastic

    hosts_file = os.path.join(tmp, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.write("localhost:2\n127.0.0.1:1\n")
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\ncat %s\n" % hosts_file)
    os.chmod(script, 0o755)
    stop_file = os.path.join(tmp, "stop")
    worker_py = os.path.join(tmp, "worker.py")
    with open(worker_py, "w") as f:
        f.write(worker_src)
    outdir = os.path.join(tmp, "out")

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    result = {}

    def run_launcher():
        try:
            result["codes"] = launch_elastic(
                [sys.executable, worker_py],
                discovery=HostDiscoveryScript(script, 1),
                np=3, min_np=2, max_np=3,
                elastic_timeout=90,
                output_filename=outdir,
                env=env,
                extra_worker_env=dict({
                    "TEST_STOP_FILE": stop_file,
                    "TEST_DOOMED_HOST": "127.0.0.1",
                    "HOROVOD_START_TIMEOUT": "120",
                }, **extra_env))
        except Exception as e:
            result["error"] = e

    t = threading.Thread(target=run_launcher, daemon=True)
    t.start()

    def wait_for(pattern, timeout=300):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if re.search(pattern, _scan_logs(outdir)):
                return
            if not t.is_alive():
                raise RuntimeError(
                    "launcher exited early (%s): %s\nlogs:\n%s"
                    % (label, result, _scan_logs(outdir)[-3000:]))
            time.sleep(0.2)
        raise RuntimeError("pattern %r never appeared (%s); logs:\n%s"
                           % (pattern, label,
                              _scan_logs(outdir)[-3000:]))

    wait_for(r"EPOCH \d+ rank=\d size=3")
    wait_for(r"DYING")
    wait_for(r"EPOCH \d+ rank=\d size=2")
    # Let survivors take a few steady-state post-resize steps.
    deadline = time.monotonic() + 60
    while (len(re.findall(r"size=2", _scan_logs(outdir))) < 8
           and time.monotonic() < deadline):
        time.sleep(0.2)
    with open(stop_file, "w"):
        pass
    t.join(timeout=180)
    logs = _scan_logs(outdir)

    death_t = max(float(m) for m in
                  re.findall(r"DYING t=([\d.]+)", logs))
    post = []   # (wallclock_at_step_end, step_ms)
    for ms, ts in re.findall(
            r"EPOCH \d+ rank=\d size=2 ms=([\d.]+) t=([\d.]+)", logs):
        post.append((float(ts), float(ms)))
    post.sort()
    if not post:
        raise RuntimeError("no post-resize steps in logs (%s)" % label)
    first_t, first_ms = post[0]
    steady = [ms for _, ms in post[2:]] or [first_ms]
    sample = {
        "death_to_first_post_resize_step_s":
            round(first_t - death_t, 2),
        "first_post_resize_step_ms": round(first_ms, 1),
        "steady_state_step_ms": round(statistics.median(steady), 2),
        "post_resize_size": 2,
    }
    done = re.findall(r"DONE rank=\d fusion=(\d+)", logs)
    if done:
        sample["fusion_launches"] = sum(int(n) for n in done)
    return sample


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--paths", nargs="+", default=["torch", "tf"],
                   choices=["torch", "tf"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the torch workers' tensors live "
                        "(default: the card)")
    args = p.parse_args(argv)
    if args.device == "cuda" and "torch" in args.paths:
        import torch
        if not torch.cuda.is_available():
            print("measure_elastic: no CUDA device is available "
                  "(--device cpu measures on the host)", file=sys.stderr)
            return 1

    scenarios = {
        "torch_reinit": (TORCH_WORKER, {"TEST_DEVICE": args.device}),
        "tf_context_reset": (TF_WORKER, {
            "HOROVOD_TF_ELASTIC_GRAPH": "1",
            "TF_CPP_MIN_LOG_LEVEL": "2",
        }),
    }
    wanted = {"torch": "torch_reinit", "tf": "tf_context_reset"}
    out = {"nproc": 3, "runs": args.runs, "device": args.device}
    for path in args.paths:
        name = wanted[path]
        src, extra = scenarios[name]
        samples = []
        for i in range(args.runs):
            with tempfile.TemporaryDirectory() as tmp:
                try:
                    samples.append(run_scenario(src, extra, tmp,
                                                "%s#%d" % (name, i)))
                except RuntimeError as e:
                    samples.append({"error": str(e)[:500]})
            print("# %s run %d: %s" % (name, i, samples[-1]),
                  file=sys.stderr, flush=True)
        good = [s for s in samples if "error" not in s]
        agg = {"samples": samples}
        if good:
            lat = [s["death_to_first_post_resize_step_s"]
                   for s in good]
            agg.update({
                "death_to_first_post_resize_step_s_median":
                    round(statistics.median(lat), 2),
                "death_to_first_post_resize_step_s_best":
                    round(min(lat), 2),
                "first_post_resize_step_ms_median": round(
                    statistics.median(
                        s["first_post_resize_step_ms"]
                        for s in good), 1),
                "steady_state_step_ms_median": round(
                    statistics.median(s["steady_state_step_ms"]
                                      for s in good), 2),
            })
        out[name] = agg
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
