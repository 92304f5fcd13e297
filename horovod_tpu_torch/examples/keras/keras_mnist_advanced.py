"""Keras MNIST "advanced" on horovod_tpu_torch, Keras's torch backend
(reference: examples/keras/keras_mnist_advanced.py — epoch scaling by
world size, LR warmup then staged decay via
LearningRateScheduleCallback, metric averaging, rank-0-only
checkpointing).  Counterpart of the JAX package's
examples/keras/keras_mnist_advanced.py.

``KERAS_BACKEND`` defaults to ``torch`` here (the port also serves
``tensorflow``).  The model trains on the rank's card, the one
``hvd.init()`` picks; ``--device cpu`` asks for the CPU.  Rank 0's
checkpoint goes to the system's temporary directory.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python keras_mnist_advanced.py
"""

import argparse
import math
import os
import tempfile

os.environ.setdefault("KERAS_BACKEND", "torch")

import keras  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch.keras as hvd  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--warmup-epochs", type=int, default=2)
    parser.add_argument("--data-size", type=int, default=4096)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    args = parser.parse_args()

    hvd.init()
    # hvd.init() made the rank's card the current device.
    device = "cpu" if args.device == "cpu" else \
        f"cuda:{torch.cuda.current_device()}"

    rng = np.random.RandomState(0)
    x_train = rng.rand(args.data_size, 28, 28, 1).astype("float32")
    y_train = rng.randint(0, 10, args.data_size)
    x_test = rng.rand(args.data_size // 4, 28, 28, 1).astype("float32")
    y_test = rng.randint(0, 10, args.data_size // 4)

    # Unlike keras_mnist.py, the data is NOT rank-sharded: every worker
    # draws from the full (shuffled) dataset and the epoch count is
    # scaled DOWN by world size instead — the reference advanced
    # example's scheme, keeping total samples processed constant.
    with keras.device(device):
        model = keras.Sequential([
            keras.layers.Input(shape=(28, 28, 1)),
            keras.layers.Conv2D(32, 3, activation="relu"),
            keras.layers.Conv2D(64, 3, activation="relu"),
            keras.layers.MaxPooling2D(),
            keras.layers.Dropout(0.25),
            keras.layers.Flatten(),
            keras.layers.Dense(128, activation="relu"),
            keras.layers.Dropout(0.5),
            keras.layers.Dense(10, activation="softmax"),
        ])

        opt = hvd.DistributedOptimizer(
            keras.optimizers.Adam(args.lr * hvd.size()))
        model.compile(optimizer=opt,
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])

        steps_per_epoch = max(len(x_train) // args.batch_size, 1)
        callbacks = [
            hvd.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd.callbacks.MetricAverageCallback(),
            # Warmup to lr*size over the first epochs, then staged
            # decay — the reference's advanced-example schedule.
            hvd.callbacks.LearningRateWarmupCallback(
                initial_lr=args.lr * hvd.size(),
                warmup_epochs=args.warmup_epochs,
                steps_per_epoch=steps_per_epoch, verbose=1),
            hvd.callbacks.LearningRateScheduleCallback(
                initial_lr=args.lr * hvd.size(),
                start_epoch=args.warmup_epochs, end_epoch=None,
                steps_per_epoch=steps_per_epoch,
                multiplier=lambda epoch: math.pow(
                    0.5, (epoch - args.warmup_epochs) // 2)),
        ]
        # Checkpoint only on rank 0 to prevent corruption from
        # concurrent writers.
        if hvd.rank() == 0:
            callbacks.append(keras.callbacks.ModelCheckpoint(
                os.path.join(tempfile.gettempdir(),
                             "checkpoint-mnist-advanced.keras")))

        epochs = int(math.ceil(args.epochs / hvd.size()))
        model.fit(x_train, y_train, batch_size=args.batch_size,
                  epochs=epochs, callbacks=callbacks,
                  verbose=1 if hvd.rank() == 0 else 0)

        score = model.evaluate(x_test, y_test,
                               verbose=1 if hvd.rank() == 0 else 0)
    if hvd.rank() == 0:
        print(f"Test loss: {score[0]:.4f}  accuracy: {score[1]:.4f}")


if __name__ == "__main__":
    main()
