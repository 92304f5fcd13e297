"""Estimator API example on horovod_tpu_torch, Keras's torch backend
(``KERAS_BACKEND`` defaults to ``torch`` here): fit a Keras model to a DataFrame with
Store-backed checkpoints and resume (reference:
examples/spark/keras/keras_spark_rossmann_estimator.py pattern,
reduced to a runnable synthetic regression).

Counterpart of the JAX package's examples/spark/keras_estimator_example.py.
Each rank trains on its card; ``--device cpu`` asks for the CPU.

Runs WITHOUT a Spark cluster via the LocalBackend (pandas DataFrame);
swap in ``SparkBackend``/a pyspark DataFrame on a real cluster —
the estimator code is identical.

    python keras_estimator_example.py --epochs 6 --num-proc 2
"""

import argparse
import os
import tempfile

import numpy as np
import pandas as pd

os.environ.setdefault("KERAS_BACKEND", "torch")

import keras  # noqa: E402

from horovod_tpu_torch.spark import FilesystemStore, LocalBackend
from horovod_tpu_torch.spark.keras import KerasEstimator

parser = argparse.ArgumentParser()
parser.add_argument("--epochs", type=int, default=6)
parser.add_argument("--num-proc", type=int, default=2)
parser.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(),
                                         "hvd_estimator_example"))
parser.add_argument("--run-id", default=None,
                    help="defaults to a fresh id per invocation (pass one to demo resume across runs)")
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu to train on the CPU (default: each rank's "
                         "card)")
args = parser.parse_args()

# Synthetic regression: y = 3x1 - 2x2 + 1 (+ noise).
rng = np.random.RandomState(0)
x = rng.rand(512, 2).astype(np.float32)
df = pd.DataFrame({
    "features": list(x),
    "y": (3 * x[:, 0] - 2 * x[:, 1] + 1
          + 0.01 * rng.randn(512)).astype(np.float32),
})

import uuid

run_id = args.run_id or "run-" + uuid.uuid4().hex[:8]
store = FilesystemStore(args.work_dir)
model = keras.Sequential([
    keras.layers.Input(shape=(2,)),
    keras.layers.Dense(16, activation="relu"),
    keras.layers.Dense(1),
])

est = KerasEstimator(
    model=model, optimizer="adam", loss="mse",
    feature_cols=["features"], label_cols=["y"],
    store=store, backend=LocalBackend(args.num_proc, verbose=0),
    epochs=args.epochs, batch_size=32, run_id=run_id, verbose=0,
    device=None if args.device == "cuda" else "cpu")

fitted = est.fit(df)
print(f"trained epochs {fitted.start_epoch}..{args.epochs - 1}, "
      f"final loss {fitted.history['loss'][-1]:.4f}")

pred = fitted.transform(df.head(4))
for feat, y, out in zip(pred["features"], pred["y"], pred["y__output"]):
    print(f"  x={np.round(feat, 2)}  y={y:.3f}  pred={float(out):.3f}")

# Re-fitting with the same run_id resumes from the last checkpoint:
est2 = est.copy({"epochs": args.epochs + 2})
resumed = est2.fit_on_prepared_data()
print(f"resumed at epoch {resumed.start_epoch}, "
      f"final loss {resumed.history['loss'][-1]:.4f}")
