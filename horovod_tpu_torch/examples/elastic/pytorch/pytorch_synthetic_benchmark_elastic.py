"""Elastic PyTorch synthetic benchmark on horovod_tpu_torch (reference:
examples/elastic/pytorch/pytorch_synthetic_benchmark_elastic.py —
training wrapped in ``hvd.elastic.run`` with a committed ``TorchState``
so workers can join/leave mid-run; batch counter and model/optimizer
state survive a membership change).  Counterpart of the JAX package's
examples/elastic/pytorch/pytorch_synthetic_benchmark_elastic.py.

Each rank trains on its card, the one ``hvd.init()`` picks; ``--device
cpu`` asks for the CPU.

Run it statically:
    python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
        python pytorch_synthetic_benchmark_elastic.py
or elastically:
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 \
        --max-np 4 --host-discovery-script ./discover.sh \
        python pytorch_synthetic_benchmark_elastic.py
"""

import argparse
import timeit

import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd

parser = argparse.ArgumentParser()
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--num-warmup-batches", type=int, default=2)
parser.add_argument("--num-batches-per-iter", type=int, default=5)
parser.add_argument("--num-iters", type=int, default=3)
parser.add_argument("--num-batches-per-commit", type=int, default=1,
                    help="commit state every N batches (commit cost vs "
                         "lost-work-on-failure tradeoff)")
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu to train on the CPU (default: the rank's "
                         "card)")
args = parser.parse_args()

hvd.init()
torch.manual_seed(42)
# hvd.init() made the rank's card the current device.
device = torch.device("cpu") if args.device == "cpu" else \
    torch.device("cuda", torch.cuda.current_device())

model = torch.nn.Sequential(
    torch.nn.Conv2d(3, 32, 7, stride=4), torch.nn.ReLU(),
    torch.nn.Conv2d(32, 64, 3, stride=2), torch.nn.ReLU(),
    torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
    torch.nn.Linear(64, 1000)).to(device)

optimizer = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size())
optimizer = hvd.DistributedOptimizer(
    optimizer, named_parameters=model.named_parameters())

data = torch.randn(args.batch_size, 3, 224, 224).to(device)
target = torch.randint(0, 1000, (args.batch_size,)).to(device)


def benchmark_step(state):
    optimizer.zero_grad()
    loss = F.cross_entropy(model(data), target)
    loss.backward()
    optimizer.step()
    state.batch += 1
    if state.batch % args.num_batches_per_commit == 0:
        # commit() snapshots model/optimizer/batch and is the point
        # where a HostsUpdatedInterrupt from the driver is raised.
        state.commit()


def log(s):
    if hvd.rank() == 0:
        print(s, flush=True)


@hvd.elastic.run
def run_benchmark(state):
    log(f"Running benchmark on {hvd.size()} worker(s), "
        f"resuming from batch {state.batch}")
    timeit.timeit(lambda: benchmark_step(state),
                  number=args.num_warmup_batches)
    for x in range(args.num_iters):
        t = timeit.timeit(lambda: benchmark_step(state),
                          number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / t
        log(f"Iter #{x}: {img_sec:.1f} img/sec per worker "
            f"({hvd.size()} workers)")


state = hvd.elastic.TorchState(model, optimizer, batch=0)
run_benchmark(state)
