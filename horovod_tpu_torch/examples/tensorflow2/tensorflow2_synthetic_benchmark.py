"""TF2 synthetic benchmark on horovod_tpu_torch (reference:
examples/tensorflow2/tensorflow2_synthetic_benchmark.py — ResNet-50,
img/sec = batch_size × num_batches_per_iter / time).  Counterpart of
the JAX package's examples/tensorflow2/tensorflow2_synthetic_benchmark.py.

The port's TensorFlow binding reduces on the CPU (TensorFlow tensors
cross ranks as CPU torch tensors over gloo).

Run:  python -m horovod_tpu_torch.runner.launch -np 2 \
          python tensorflow2_synthetic_benchmark.py --model ResNet50 --num-iters 3
"""

import argparse
import timeit

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="ResNet50")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=5)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--fp16-allreduce", action="store_true")
    args = parser.parse_args()

    hvd.init()

    model = getattr(tf.keras.applications, args.model)(weights=None)
    opt = tf.keras.optimizers.SGD(0.01 * hvd.size())
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)

    data = tf.random.uniform([args.batch_size, 224, 224, 3])
    target = tf.random.uniform([args.batch_size, 1], minval=0,
                               maxval=999, dtype=tf.int64)
    loss_obj = tf.keras.losses.SparseCategoricalCrossentropy()

    first = [True]

    def benchmark_step():
        with tf.GradientTape() as raw_tape:
            probs = model(data, training=True)
            loss = loss_obj(target, probs)
        tape = hvd.DistributedGradientTape(raw_tape,
                                           compression=compression)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if first[0]:
            hvd.broadcast_variables(model.variables, root_rank=0)
            hvd.broadcast_variables(opt.variables, root_rank=0)
            first[0] = False

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    log(f"Model: {args.model}, batch size {args.batch_size}, "
        f"{hvd.size()} workers")
    timeit.timeit(benchmark_step, number=args.num_warmup_batches)

    img_secs = []
    for x in range(args.num_iters):
        t = timeit.timeit(benchmark_step,
                          number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / t
        log(f"Iter #{x}: {img_sec:.1f} img/sec per worker")
        img_secs.append(img_sec)

    img_sec_mean = np.mean(img_secs)
    log(f"Img/sec per worker: {img_sec_mean:.1f} "
        f"+-{1.96 * np.std(img_secs):.1f}")
    log(f"Total img/sec on {hvd.size()} worker(s): "
        f"{hvd.size() * img_sec_mean:.1f}")


if __name__ == "__main__":
    main()
