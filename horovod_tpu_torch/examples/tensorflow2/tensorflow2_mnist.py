"""TF2 MNIST on horovod_tpu_torch (reference:
examples/tensorflow2/tensorflow2_mnist.py — the canonical
DistributedGradientTape loop: per-batch tape wrap, first-batch
broadcast of model and optimizer variables, rank-sharded data).
Counterpart of the JAX package's examples/tensorflow2/tensorflow2_mnist.py.

The port's TensorFlow binding reduces on the CPU (TensorFlow tensors
cross ranks as CPU torch tensors over gloo).

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python tensorflow2_mnist.py
"""

import argparse

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--data-size", type=int, default=4096)
    args = parser.parse_args()

    hvd.init()

    # Synthetic MNIST-shaped data (no network access in this image);
    # shard by rank like the reference's dataset.shard(size, rank).
    rng = np.random.RandomState(0)
    x = rng.rand(args.data_size, 28, 28, 1).astype("float32")
    y = rng.randint(0, 10, args.data_size).astype("int64")
    dataset = (tf.data.Dataset.from_tensor_slices((x, y))
               .shard(hvd.size(), hvd.rank())
               .repeat().shuffle(1024).batch(args.batch_size))

    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(32, [3, 3], activation="relu"),
        tf.keras.layers.Conv2D(64, [3, 3], activation="relu"),
        tf.keras.layers.MaxPooling2D(pool_size=(2, 2)),
        tf.keras.layers.Dropout(0.25),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dropout(0.5),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])
    loss_fn = tf.losses.SparseCategoricalCrossentropy()
    # Scale the learning rate by world size (linear scaling rule).
    opt = tf.optimizers.Adam(args.lr * hvd.size())

    @tf.function
    def training_step(images, labels, first_batch):
        with tf.GradientTape() as tape:
            probs = model(images, training=True)
            loss_value = loss_fn(labels, probs)
        # The tape wrap allreduces gradients at .gradient() time; in a
        # traced tf.function the collectives stay in-graph.
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss_value, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        # Broadcast initial state once AFTER the first apply_gradients
        # so all optimizer slots exist (reference's ordering note).
        if first_batch:
            hvd.broadcast_variables(model.variables, root_rank=0)
            # .variables is a method on legacy TF optimizers, a plain
            # list property on Keras 3 ones.
            opt_vars = opt.variables() if callable(opt.variables) \
                else opt.variables
            hvd.broadcast_variables(opt_vars, root_rank=0)
        return loss_value

    for batch, (images, labels) in enumerate(dataset.take(args.steps)):
        loss_value = training_step(images, labels, batch == 0)
        if batch % 10 == 0 and hvd.local_rank() == 0:
            print(f"Step #{batch}\tLoss: {float(loss_value):.6f}",
                  flush=True)


if __name__ == "__main__":
    main()
