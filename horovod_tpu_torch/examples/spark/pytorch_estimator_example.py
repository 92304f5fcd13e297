"""Torch Estimator API example on horovod_tpu_torch: fit a torch model to a DataFrame with
Store-backed checkpoints and resume (reference:
examples/spark/pytorch/pytorch_spark_mnist.py pattern, reduced to a
runnable synthetic regression).

Counterpart of the JAX package's examples/spark/pytorch_estimator_example.py.
Each rank trains on its card; ``--device cpu`` asks for the CPU.

Runs WITHOUT a Spark cluster via the LocalBackend (pandas DataFrame);
swap in ``SparkBackend``/a pyspark DataFrame on a real cluster — the
estimator code is identical.

    python pytorch_estimator_example.py --epochs 6 --num-proc 2
"""

import argparse
import os
import tempfile
import uuid

import numpy as np
import pandas as pd
import torch

from horovod_tpu_torch.spark import FilesystemStore, LocalBackend
from horovod_tpu_torch.spark.torch import TorchEstimator

parser = argparse.ArgumentParser()
parser.add_argument("--epochs", type=int, default=6)
parser.add_argument("--num-proc", type=int, default=2)
parser.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(),
                                         "hvd_torch_estimator"))
parser.add_argument("--run-id", default=None,
                    help="defaults to a fresh id per invocation (pass "
                         "one to demo resume across runs)")
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

run_id = args.run_id or "run-" + uuid.uuid4().hex[:8]
store = FilesystemStore(args.work_dir)

model = torch.nn.Sequential(
    torch.nn.Linear(2, 16), torch.nn.ReLU(), torch.nn.Linear(16, 1))

est = TorchEstimator(
    model=model,
    optimizer=torch.optim.Adam(model.parameters(), lr=0.01),
    loss=torch.nn.MSELoss(),
    feature_cols=["features"], label_cols=["y"],
    store=store, backend=LocalBackend(args.num_proc, verbose=0),
    epochs=args.epochs, batch_size=32, run_id=run_id, verbose=0,
    device=None if args.device == "cuda" else "cpu")

fitted = est.fit(df)
print(f"trained epochs {fitted.start_epoch}..{args.epochs - 1}, "
      f"final loss {fitted.history[-1]:.4f}")

pred = fitted.transform(df.head(4))
for feat, y, out in zip(pred["features"], pred["y"], pred["y__output"]):
    print(f"  x={np.round(feat, 2)}  y={y:.3f}  pred={float(out):.3f}")

# Re-fitting with the same run_id resumes from the last checkpoint:
est2 = est.copy({"epochs": args.epochs + 2})
resumed = est2.fit_on_prepared_data()
print(f"resumed at epoch {resumed.start_epoch}, "
      f"final loss {resumed.history[-1]:.4f}")
