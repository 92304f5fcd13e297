"""Sharded GPT causal-LM training on the port's mesh (dp x tp), the
decoder-family counterpart of the BERT pretraining path.  Counterpart of
the JAX package's examples/jax/gpt_sharded_train.py: there one process
drives every device of the mesh; here one process drives one device, so
launch dp x tp ranks:

    python -m horovod_tpu_torch.runner.launch -np 8 -H localhost:8 \
        python gpt_sharded_train.py --dp 4 --tp 2

Each rank trains on its card (``hvd.init()`` picks it); ``--device
cpu`` asks for the CPU (gloo).  Pass --fsdp to ZeRO-3-shard parameters
and optimizer state over the data axis (all-gather on use,
reduce-scatter of grads) instead of replicating them.
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import gpt_tiny_config
from horovod_tpu_torch.parallel.mesh import build_mesh
from horovod_tpu_torch.training import make_gpt_train_step

parser = argparse.ArgumentParser()
parser.add_argument("--dp", type=int, default=4)
parser.add_argument("--tp", type=int, default=2)
parser.add_argument("--batch-size", type=int, default=16)
parser.add_argument("--seq-len", type=int, default=64)
parser.add_argument("--steps", type=int, default=50)
parser.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3-shard params/opt state over the data "
                         "axis")
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu to train on the CPU (default: the rank's "
                         "card)")
args = parser.parse_args()

hvd.init()
cfg = gpt_tiny_config(max_position_embeddings=args.seq_len)
data_axis = "fsdp" if args.fsdp else "dp"
mesh = build_mesh({data_axis: args.dp, "tp": args.tp},
                  device_type=args.device)
# Parameters are placed by the tensor-parallel rules inside
# make_gpt_train_step; DTensor inserts the collectives (the GSPMD
# recipe: no hand-written allreduces).
init_fn, step_fn, batch_sharding = make_gpt_train_step(
    cfg, mesh, learning_rate=3e-3,
    fsdp="fsdp" if args.fsdp else None)

rng = np.random.RandomState(0)
ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                   (args.batch_size, args.seq_len)))
model, opt = init_fn(1, ids)

for step in range(args.steps):
    model, opt, loss = step_fn(model, opt, ids)
    if (step % 10 == 0 or step == args.steps - 1) and hvd.rank() == 0:
        print(f"step {step:3d}  loss {float(loss):.4f}", flush=True)
