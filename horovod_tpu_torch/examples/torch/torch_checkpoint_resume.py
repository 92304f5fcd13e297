"""Checkpoint/resume of a data-parallel training state with
``horovod_tpu_torch.torch.checkpoint``: train a linear model with the
data split over the ranks, checkpointing every epoch; re-running the
script resumes from the newest checkpoint.  Counterpart of the JAX
package's examples/jax/jax_checkpoint_resume.py (there the data is
sharded over one process's devices; here over the ranks, whose
gradients ``hvd.allreduce`` averages).

Each rank trains on its card, the one ``hvd.init()`` picks; ``--device
cpu`` asks for the CPU.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python torch_checkpoint_resume.py --epochs 6 --dir ckpt_demo
(run it twice to see the resume path; --fresh wipes the directory).
"""

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

import horovod_tpu_torch.torch as hvd
import horovod_tpu_torch.torch.checkpoint as ckpt


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=6)
    parser.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                      "hvd_ckpt_demo"))
    parser.add_argument("--lr", type=float, default=0.3)
    parser.add_argument("--fresh", action="store_true",
                        help="delete existing checkpoints first")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    args = parser.parse_args()

    hvd.init()
    if args.fresh and hvd.rank() == 0:
        shutil.rmtree(args.dir, ignore_errors=True)
    hvd.barrier()
    # hvd.init() made the rank's card the current device.
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())

    # y = 2x; the data split over the ranks, the weight replicated.
    n = 64 * hvd.size()
    xs = np.linspace(-1, 1, n).astype(np.float32)
    part = slice(hvd.rank() * 64, (hvd.rank() + 1) * 64)
    xs = torch.from_numpy(xs[part]).to(device)
    ys = 2.0 * xs

    state = {"w": torch.zeros((), device=device),
             "epoch": torch.zeros((), dtype=torch.int32)}

    last = ckpt.latest_step(args.dir)
    if last is not None:
        state = ckpt.restore(args.dir, state)
        if hvd.rank() == 0:
            print(f"resumed from step {last}: w={float(state['w']):.4f}",
                  flush=True)

    def epoch_step(w):
        # d/dw of the mean squared error over the whole data set: the
        # mean of the ranks' equal-sized shards' gradients.
        g = torch.mean(2.0 * xs * (w * xs - ys))
        return w - args.lr * hvd.allreduce(g, name="grad")

    for epoch in range(int(state["epoch"]), args.epochs):
        for _ in range(20):
            state["w"] = epoch_step(state["w"])
        state["epoch"] = torch.tensor(epoch + 1, dtype=torch.int32)
        ckpt.save(args.dir, state, step=epoch + 1, keep=3)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: w={float(state['w']):.4f} "
                  f"(checkpointed step {epoch + 1})", flush=True)

    if hvd.rank() == 0:
        print(f"final w={float(state['w']):.4f} (target 2.0)", flush=True)


if __name__ == "__main__":
    main()
