"""Elastic TF2 ResNet-50 synthetic benchmark (a BASELINE config).

On horovod_tpu_torch (reference: examples/elastic/tensorflow2/
tensorflow2_synthetic_benchmark_elastic.py): DistributedGradientTape
training wrapped in ``hvd.elastic.run`` with a committed
TensorFlowKerasState, so workers can join/leave mid-run and training
resumes from the last commit with the learning rate rescaled to the
new world size.  Counterpart of the JAX package's
examples/elastic/tensorflow2/tensorflow2_resnet50_elastic.py; the
port's TensorFlow binding reduces on the CPU.

Run it statically:
    python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
        python tensorflow2_resnet50_elastic.py
or elastically:
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \
        --host-discovery-script ./discover.sh \
        python tensorflow2_resnet50_elastic.py
"""

import argparse
import timeit

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd

parser = argparse.ArgumentParser(
    description="Elastic TF2 ResNet-50 synthetic benchmark",
    formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--model", type=str, default="ResNet50",
                    help="keras.applications model, or 'simple' for a "
                         "tiny CNN (CI smoke)")
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--image-size", type=int, default=224)
parser.add_argument("--fp16-allreduce", action="store_true")
parser.add_argument("--num-warmup-batches", type=int, default=10)
parser.add_argument("--num-batches-per-iter", type=int, default=10)
parser.add_argument("--num-iters", type=int, default=10)
parser.add_argument("--num-batches-per-commit", type=int, default=1)
parser.add_argument("--in-graph", action="store_true",
                    help="keep collectives inside the traced graph "
                         "across resizes (sets "
                         "HOROVOD_TF_ELASTIC_GRAPH=1; the TF context "
                         "is reset on every resize and the model is "
                         "rebuilt in on_reset)")
args = parser.parse_args()

if args.in_graph:
    # The knob is read dynamically by the graph-collective layer, so
    # setting it after import (from this CLI flag) is fine.
    import os
    os.environ.setdefault("HOROVOD_TF_ELASTIC_GRAPH", "1")

hvd.init()
if args.in_graph:
    assert hvd.enable_graph_collectives(), \
        "graph collectives failed to enable (call before any TF op)"

lr = 0.01


def build_model():
    if args.model == "simple":
        return tf.keras.Sequential([
            tf.keras.layers.Input((args.image_size, args.image_size, 3)),
            tf.keras.layers.Conv2D(8, 3, activation="relu"),
            tf.keras.layers.GlobalAveragePooling2D(),
            tf.keras.layers.Dense(10),
        ])
    return getattr(tf.keras.applications, args.model)(
        weights=None, input_shape=(args.image_size, args.image_size, 3),
        classes=1000)


num_classes = 10 if args.model == "simple" else 1000
compression = (hvd.Compression.fp16 if args.fp16_allreduce
               else hvd.Compression.none)


def build_training():
    """Model + optimizer + traced step + data, rebuildable: with
    --in-graph, every elastic resize resets the TF context, so all of
    these are re-created in on_state_reset."""
    model = build_model()
    opt = tf.optimizers.SGD(lr * hvd.size())
    data = tf.random.uniform([args.batch_size, args.image_size,
                              args.image_size, 3])
    target = tf.random.uniform([args.batch_size, 1], minval=0,
                               maxval=num_classes, dtype=tf.int64)

    @tf.function
    def train_one_batch():
        with tf.GradientTape() as tape:
            logits = model(data, training=True)
            loss = tf.losses.sparse_categorical_crossentropy(
                target, logits, from_logits=True)
        tape = hvd.DistributedGradientTape(tape,
                                           compression=compression)
        gradients = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(gradients, model.trainable_variables))
    return model, opt, train_one_batch


model, opt, train_one_batch = build_training()


def collective_path():
    """Name the plane the traced step actually uses (for the log)."""
    try:
        cf = train_one_batch.get_concrete_function()
        ops = {op.type for op in cf.graph.get_operations()}
    except Exception:
        return "untraced"
    if any("PyFunc" in t for t in ops):
        return "py_function"
    if "CollectiveReduceV2" in ops:
        return "collective_v2"
    return "local"


def benchmark_step(state):
    train_one_batch()
    if state is not None:
        state.batch += 1
        if state.batch == args.num_batches_per_commit:
            state.batch = 0
            state.commit()


def log(s):
    if hvd.rank() == 0:
        print(s, flush=True)


log(f"Model: {args.model}  batch {args.batch_size}  "
    f"workers {hvd.size()}")

# One batch before sync so weights exist to broadcast.
train_one_batch()


@hvd.elastic.run
def run_benchmark(state):
    if not state.warm:
        log("Running warmup...")
        timeit.timeit(lambda: benchmark_step(state),
                      number=args.num_warmup_batches)
        state.warm = True
        state.commit()
    if state.iter == 0:
        log("Running benchmark...")
    for x in range(state.iter, args.num_iters):
        dt = timeit.timeit(lambda: benchmark_step(state),
                           number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / dt
        log(f"Iter #{x}: {img_sec:.1f} img/sec per worker "
            f"(size={hvd.size()}, path={collective_path()})")
        state.img_secs.append(img_sec)
        state.iter = x
        state.commit()


def on_state_reset():
    global model, opt, train_one_batch
    if args.in_graph:
        # The resize reset the TF context: rebuild everything and
        # re-point the state at the fresh objects (weights restore
        # from the last committed numpy snapshot).
        model, opt, train_one_batch = build_training()
        train_one_batch()
        state.rebuild(model, opt)
    # World size changed: rescale the learning rate (reference
    # example's on_state_reset).
    opt.learning_rate.assign(lr * hvd.size())
    log(f"reset: size={hvd.size()} path={collective_path()}")


state = hvd.elastic.TensorFlowKerasState(
    model, opt, img_secs=[], iter=0, batch=0, warm=False)
state.register_reset_callbacks([on_state_reset])
run_benchmark(state)

if hvd.rank() == 0 and state.img_secs:
    mean = np.mean(state.img_secs)
    log(f"Total img/sec on {hvd.size()} workers: "
        f"{mean * hvd.size():.1f} (per worker {mean:.1f})")
