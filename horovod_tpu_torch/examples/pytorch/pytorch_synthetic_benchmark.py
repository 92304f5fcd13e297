"""PyTorch synthetic benchmark on horovod_tpu_torch (reference:
examples/pytorch/pytorch_synthetic_benchmark.py:106-118 — the img/sec
metric is batch_size × num_batches_per_iter / time per worker, total =
× size).  Counterpart of the JAX package's
examples/pytorch/pytorch_synthetic_benchmark.py.

Each rank trains on its card, the one ``hvd.init()`` picks; ``--device
cpu`` asks for the CPU.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python pytorch_synthetic_benchmark.py --model resnet50 --num-iters 3
"""

import argparse
import timeit

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="resnet50")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=5)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--use-adasum", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    args = parser.parse_args()

    hvd.init()
    torch.manual_seed(42)
    # hvd.init() made the rank's card the current device.
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())

    try:
        import torchvision.models as models
        model = getattr(models, args.model)()
    except ImportError:
        # No torchvision: a stand-in CNN with the same input/output
        # contract, so that the benchmark harness still runs.
        print("torchvision not installed; using a small built-in CNN")
        model = torch.nn.Sequential(
            torch.nn.Conv2d(3, 32, 7, stride=4), torch.nn.ReLU(),
            torch.nn.Conv2d(32, 64, 3, stride=2), torch.nn.ReLU(),
            torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
            torch.nn.Linear(64, 1000))
    model.to(device)

    lr_scaler = hvd.size() if not args.use_adasum else 1
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=0.01 * lr_scaler)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        op=hvd.Adasum if args.use_adasum else hvd.Average)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    data = torch.randn(args.batch_size, 3, 224, 224).to(device)
    target = torch.randint(0, 1000, (args.batch_size,)).to(device)

    def benchmark_step():
        optimizer.zero_grad()
        output = model(data)
        loss = F.cross_entropy(output, target)
        loss.backward()
        optimizer.step()
        if device.type == "cuda":
            torch.cuda.synchronize()

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    log(f"Model: {args.model}, batch size {args.batch_size}, "
        f"{hvd.size()} workers")
    timeit.timeit(benchmark_step, number=args.num_warmup_batches)

    img_secs = []
    for x in range(args.num_iters):
        t = timeit.timeit(benchmark_step,
                          number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / t
        log(f"Iter #{x}: {img_sec:.1f} img/sec per worker")
        img_secs.append(img_sec)

    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    log(f"Img/sec per worker: {img_sec_mean:.1f} +-{img_sec_conf:.1f}")
    log(f"Total img/sec on {hvd.size()} worker(s): "
        f"{hvd.size() * img_sec_mean:.1f} "
        f"+-{hvd.size() * img_sec_conf:.1f}")


if __name__ == "__main__":
    main()
