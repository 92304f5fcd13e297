"""PyTorch MNIST on horovod_tpu_torch (reference:
examples/pytorch/pytorch_mnist.py — DistributedOptimizer with
named_parameters, DistributedSampler-style sharding, parameter and
optimizer-state broadcast, allreduced test metrics).  Counterpart of
the JAX package's examples/pytorch/pytorch_mnist.py.

Each rank trains on its card, the one ``hvd.init()`` picks; ``--device
cpu`` asks for the CPU.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python pytorch_mnist.py --epochs 1
"""

import argparse

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.data

import horovod_tpu_torch.torch as hvd


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.flatten(1)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def make_dataset(n, seed):
    """Synthetic MNIST-shaped data, a stand-in for
    torchvision.datasets.MNIST with deterministic random digits (same
    tensor contract: 1x28x28 float, int64 label)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 1, 28, 28, generator=g)
    y = torch.randint(0, 10, (n,), generator=g)
    return torch.utils.data.TensorDataset(x, y)


def metric_average(val, name):
    tensor = torch.tensor(val)
    avg = hvd.allreduce(tensor, name=name)
    return avg.item()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--test-batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--momentum", type=float, default=0.5)
    parser.add_argument("--fp16-allreduce", action="store_true")
    parser.add_argument("--use-adasum", action="store_true")
    parser.add_argument("--data-size", type=int, default=4096)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    args = parser.parse_args()

    hvd.init()
    torch.manual_seed(42)
    torch.set_num_threads(1)
    # hvd.init() made the rank's card the current device.
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())

    train_dataset = make_dataset(args.data_size, seed=1)
    test_dataset = make_dataset(args.data_size // 4, seed=2)

    # Partition by rank, the reference's DistributedSampler contract:
    # each worker sees a disjoint 1/size shard per epoch.
    train_sampler = torch.utils.data.distributed.DistributedSampler(
        train_dataset, num_replicas=hvd.size(), rank=hvd.rank())
    train_loader = torch.utils.data.DataLoader(
        train_dataset, batch_size=args.batch_size, sampler=train_sampler)
    test_sampler = torch.utils.data.distributed.DistributedSampler(
        test_dataset, num_replicas=hvd.size(), rank=hvd.rank())
    test_loader = torch.utils.data.DataLoader(
        test_dataset, batch_size=args.test_batch_size,
        sampler=test_sampler)

    model = Net().to(device)
    # Adasum doesn't need the LR scaled by world size; Average does
    # (Goyal et al. linear scaling).
    lr_scaler = 1 if args.use_adasum else hvd.size()
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=args.lr * lr_scaler,
                                momentum=args.momentum)

    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        op=hvd.Adasum if args.use_adasum else hvd.Average)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    for epoch in range(1, args.epochs + 1):
        model.train()
        train_sampler.set_epoch(epoch)
        for batch_idx, (data, target) in enumerate(train_loader):
            data, target = data.to(device), target.to(device)
            optimizer.zero_grad()
            loss = F.nll_loss(model(data), target)
            loss.backward()
            optimizer.step()
            if batch_idx % 10 == 0 and hvd.rank() == 0:
                print(f"Train Epoch: {epoch} "
                      f"[{batch_idx * len(data)}/{len(train_sampler)}]"
                      f"\tLoss: {loss.item():.6f}", flush=True)

        model.eval()
        test_loss, test_accuracy = 0.0, 0.0
        with torch.no_grad():
            for data, target in test_loader:
                data, target = data.to(device), target.to(device)
                output = model(data)
                test_loss += F.nll_loss(output, target,
                                        reduction="sum").item()
                pred = output.argmax(dim=1)
                test_accuracy += pred.eq(target).float().sum().item()
        test_loss /= len(test_sampler)
        test_accuracy /= len(test_sampler)

        # Average metric values across workers.
        test_loss = metric_average(test_loss, "avg_loss")
        test_accuracy = metric_average(test_accuracy, "avg_accuracy")
        if hvd.rank() == 0:
            print(f"Test set: Average loss: {test_loss:.4f}, "
                  f"Accuracy: {100.0 * test_accuracy:.2f}%", flush=True)


if __name__ == "__main__":
    main()
