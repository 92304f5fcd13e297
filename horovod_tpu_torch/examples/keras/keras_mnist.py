"""Keras MNIST on horovod_tpu_torch, Keras's torch backend (reference:
examples/keras/keras_mnist.py — the BASELINE.md CPU/Gloo baseline
config, adapted to Keras 3).  Counterpart of the JAX package's
examples/keras/keras_mnist.py.

``KERAS_BACKEND`` defaults to ``torch`` here (the port also serves
``tensorflow``).  The model trains on the rank's card, the one
``hvd.init()`` picks; ``--device cpu`` asks for the CPU.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python keras_mnist.py --epochs 1
"""

import argparse
import os

os.environ.setdefault("KERAS_BACKEND", "torch")

import keras  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch.keras as hvd  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--synthetic", action="store_true",
                        help="Use random data instead of downloading "
                             "MNIST.")
    parser.add_argument("--run-eagerly", action="store_true",
                        help="Per-op eager execution through the "
                             "negotiated data plane (slower; for "
                             "debugging).")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    args = parser.parse_args()

    hvd.init()
    # hvd.init() made the rank's card the current device.
    device = "cpu" if args.device == "cpu" else \
        f"cuda:{torch.cuda.current_device()}"

    if args.synthetic:
        x_train = np.random.rand(4096, 28, 28, 1).astype("float32")
        y_train = np.random.randint(0, 10, 4096)
    else:
        (x_train, y_train), _ = keras.datasets.mnist.load_data()
        x_train = (x_train / 255.0).astype("float32")[..., None]

    # Shard the dataset by rank (each worker sees 1/size of the data).
    x_train = x_train[hvd.rank()::hvd.size()]
    y_train = y_train[hvd.rank()::hvd.size()]

    with keras.device(device):
        model = keras.Sequential([
            keras.layers.Input(shape=(28, 28, 1)),
            keras.layers.Conv2D(32, 3, activation="relu"),
            keras.layers.MaxPooling2D(),
            keras.layers.Conv2D(64, 3, activation="relu"),
            keras.layers.MaxPooling2D(),
            keras.layers.Flatten(),
            keras.layers.Dense(128, activation="relu"),
            keras.layers.Dense(10, activation="softmax"),
        ])

        # Scale the learning rate by world size (Goyal et al. linear
        # scaling), wrap the optimizer, broadcast initial state.
        opt = hvd.DistributedOptimizer(
            keras.optimizers.Adam(args.lr * hvd.size()))
        # Under torch the step is eager either way; the gradients are
        # reduced on their device by the fused data plane.
        model.compile(optimizer=opt,
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"], run_eagerly=args.run_eagerly)

        callbacks = [
            hvd.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd.callbacks.MetricAverageCallback(),
            hvd.callbacks.LearningRateWarmupCallback(
                initial_lr=args.lr * hvd.size(), warmup_epochs=1,
                steps_per_epoch=len(x_train) // args.batch_size or 1),
        ]
        model.fit(x_train, y_train, batch_size=args.batch_size,
                  epochs=args.epochs, callbacks=callbacks,
                  verbose=1 if hvd.rank() == 0 else 0)
    if hvd.rank() == 0:
        model.save("mnist_model.keras")
        print("done")


if __name__ == "__main__":
    main()
