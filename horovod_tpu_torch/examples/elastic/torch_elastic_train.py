"""Elastic PyTorch training on horovod_tpu_torch: a linear regression
whose state (weights, optimizer, epoch) is committed after every epoch,
so workers can join or leave mid-run and training resumes from the last
commit.  Counterpart of the JAX package's
examples/elastic/jax_elastic_train.py, with ``TorchState`` and
``hvd.elastic.run`` in place of ``JaxState`` and ``run``.

Each rank trains on its card, the one ``hvd.init()`` picks; ``--device
cpu`` asks for the CPU.  Run with a host-discovery script whose output
may change over time:

    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 2 \
        --max-np 4 --host-discovery-script ./discover.sh \
        python torch_elastic_train.py
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.torch.elastic import TorchState, run


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    args = parser.parse_args()

    hvd.init()
    # hvd.init() made the rank's card the current device.
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())

    true_w = np.array([2.0, -1.0, 0.5, 1.0], np.float32)
    rng = np.random.RandomState(hvd.rank())
    X = rng.randn(256, 4).astype(np.float32)
    Y = X @ true_w
    X, Y = torch.from_numpy(X).to(device), torch.from_numpy(Y).to(device)

    model = torch.nn.Linear(4, 1, bias=False).to(device)
    torch.nn.init.zeros_(model.weight)
    # The hooks average each gradient over the ranks.
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr),
        named_parameters=model.named_parameters())
    state = TorchState(model, opt, epoch=0)

    def lr_rescale():
        print(f"[rank {hvd.rank()}] world resized to {hvd.size()}")

    state.register_reset_callbacks([lr_rescale])

    def w():
        return model.weight.detach().cpu().numpy()[0].round(3)

    @run
    def train(state):
        while state.epoch < args.epochs:
            opt.zero_grad()
            loss = torch.mean((model(X)[:, 0] - Y) ** 2)
            loss.backward()
            opt.step()
            state.epoch += 1
            state.commit()
            if hvd.rank() == 0:
                print(f"epoch {state.epoch} size={hvd.size()} w={w()}")
        return w()

    final = train(state)
    if hvd.rank() == 0:
        print("final w:", final)


if __name__ == "__main__":
    main()
