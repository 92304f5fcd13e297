"""Elastic PyTorch training over Ray hosts on horovod_tpu_torch (reference:
examples/ray/pytorch_ray_elastic.py — ``ElasticRayExecutor`` discovers
slots from the Ray cluster/autoscaler and drives the elastic launcher,
so the worker script is plain elastic Horovod code).

The executor launches this same file's ``--worker`` mode on every
discovered slot; workers join/leave as the Ray cluster grows/shrinks.

Counterpart of the JAX package's examples/ray/pytorch_ray_elastic.py.
Each worker trains on its card; ``--device cpu`` asks for the CPU.

Run:  python pytorch_ray_elastic.py --min-np 1 --max-np 4
"""

import argparse
import sys


def worker(device_name):
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch.torch as hvd

    hvd.init()
    torch.manual_seed(42)
    # hvd.init() made the rank's card the current device.
    device = torch.device("cpu") if device_name == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())

    model = torch.nn.Sequential(
        torch.nn.Linear(32, 64), torch.nn.ReLU(),
        torch.nn.Linear(64, 10)).to(device)
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=0.01 * hvd.size())
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())

    data = torch.randn(64, 32).to(device)
    target = torch.randint(0, 10, (64,)).to(device)

    @hvd.elastic.run
    def train(state):
        while state.batch < 50:
            optimizer.zero_grad()
            loss = F.cross_entropy(model(data), target)
            loss.backward()
            optimizer.step()
            state.batch += 1
            if state.batch % 10 == 0:
                state.commit()
                if hvd.rank() == 0:
                    print(f"batch {state.batch} size {hvd.size()} "
                          f"loss {loss.item():.4f}", flush=True)

    state = hvd.elastic.TorchState(model, optimizer, batch=0)
    train(state)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", action="store_true",
                        help="internal: run as a training worker")
    parser.add_argument("--min-np", type=int, default=1)
    parser.add_argument("--max-np", type=int, default=4)
    parser.add_argument("--cpus-per-slot", type=int, default=1)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: each "
                             "worker's card)")
    args = parser.parse_args()

    if args.worker:
        worker(args.device)
        return

    import ray
    from horovod_tpu_torch.ray import ElasticRayExecutor

    ray.init()
    executor = ElasticRayExecutor(
        min_np=args.min_np, max_np=args.max_np,
        use_gpu=args.device == "cuda", cpus_per_slot=args.cpus_per_slot)
    executor.run_command(
        [sys.executable, __file__, "--worker", "--device", args.device])


if __name__ == "__main__":
    main()
