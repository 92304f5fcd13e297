"""TF2 MNIST on Ray on horovod_tpu_torch (reference: examples/ray/tensorflow2_mnist_ray.py
— ``RayExecutor`` places one worker actor per slot, builds the rank env
contract, and runs the training function on every worker).

Counterpart of the JAX package's examples/ray/tensorflow2_mnist_ray.py;
the port's TensorFlow binding reduces on the CPU.

Run:  python tensorflow2_mnist_ray.py --num-workers 2
"""

import argparse


def train(num_epochs):
    import numpy as np
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init()

    rng = np.random.RandomState(hvd.rank())
    x = rng.rand(1024, 28, 28, 1).astype("float32")
    y = rng.randint(0, 10, 1024).astype("int64")
    dataset = (tf.data.Dataset.from_tensor_slices((x, y))
               .repeat().shuffle(1024).batch(128))

    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(32, 3, activation="relu"),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])
    loss_fn = tf.losses.SparseCategoricalCrossentropy()
    # Scale the learning rate by world size.
    opt = tf.optimizers.Adam(0.001 * hvd.size())

    @tf.function
    def training_step(images, labels, first_batch):
        with tf.GradientTape() as tape:
            probs = model(images, training=True)
            loss_value = loss_fn(labels, probs)
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss_value, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if first_batch:
            hvd.broadcast_variables(model.variables, root_rank=0)
            opt_vars = opt.variables() if callable(opt.variables) \
                else opt.variables
            hvd.broadcast_variables(opt_vars, root_rank=0)
        return loss_value

    for batch, (images, labels) in enumerate(
            dataset.take(10 * num_epochs)):
        loss_value = training_step(images, labels, batch == 0)
        if batch % 10 == 0 and hvd.rank() == 0:
            print(f"Step #{batch}\tLoss: {float(loss_value):.6f}",
                  flush=True)
    return float(loss_value)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=1)
    args = parser.parse_args()

    import ray
    from horovod_tpu_torch.ray import RayExecutor

    ray.init()
    executor = RayExecutor(num_workers=args.num_workers)
    executor.start()
    losses = executor.run(train, args=[args.epochs])
    print("final per-worker losses:", losses)
    executor.shutdown()


if __name__ == "__main__":
    main()
