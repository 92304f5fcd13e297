"""ResNet-50 synthetic benchmark on the port's mesh: one data-parallel
axis over every rank, each rank training on its shard of the global
batch inside ``parallel.shard_map`` and averaging the gradients over the
axis with ``parallel.allreduce_mean``, where XLA inserts that allreduce
in the JAX step (reference metric:
examples/tensorflow2/tensorflow2_synthetic_benchmark img/sec =
batch_size × num_batches_per_iter / time).  Counterpart of the JAX
package's examples/jax/jax_synthetic_benchmark.py, which drives every
local chip from one process; here one process drives one card.

Each rank trains on its card, the one ``hvd.init()`` picks; ``--device
cpu`` asks for the CPU.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
          python resnet50_synthetic_benchmark.py --batch-size 64 --num-iters 3
"""

import argparse
import timeit

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.resnet import ResNet50
from horovod_tpu_torch.parallel import allreduce_mean, build_mesh, shard_map
from horovod_tpu_torch.parallel.mesh import PartitionSpec as P


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=64,
                        help="Global batch size.")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=5)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu to train on the CPU (default: the "
                             "rank's card)")
    args = parser.parse_args()

    hvd.init()
    # hvd.init() made the rank's card the current device.
    device = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    n_dev = hvd.size()
    if not dist.is_initialized():
        # hvd.init() makes no process group in a world of one; the mesh
        # needs one.
        dist.init_process_group(
            "gloo" if device.type == "cpu" else "cpu:gloo,cuda:nccl",
            store=dist.HashStore(), world_size=1, rank=0)
    mesh = build_mesh({"dp": n_dev}, device_type=device.type)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    model = ResNet50(num_classes=1000, dtype=dtype, device=device,
                     seed=0).train()
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=0.01, momentum=0.9)

    def local_step(x, y):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        # The gradients averaged over the data axis, in one buffer.
        grads = [p.grad for p in params]
        flat = allreduce_mean(torch.cat([g.reshape(-1) for g in grads]),
                              "dp")
        for p, g in zip(params, flat.split([g.numel() for g in grads])):
            p.grad = g.view_as(p)
        opt.step()
        return allreduce_mean(loss.detach(), "dp")

    # Each rank holds the whole (same) batch; shard_map hands it its
    # shard along the data axis.
    train_step = shard_map(local_step, mesh, in_specs=(P("dp"), P("dp")),
                           out_specs=P())
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.randn(
        args.batch_size, 3, args.image_size,
        args.image_size).astype(np.float32)).to(device, dtype)
    labels = torch.from_numpy(rng.randint(
        0, 1000, args.batch_size)).to(device)

    def benchmark_step():
        train_step(data, labels).item()

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    log(f"ResNet-50, global batch {args.batch_size}, {n_dev} chips, "
        f"dtype {str(dtype).split('.')[-1]}")
    timeit.timeit(benchmark_step, number=args.num_warmup_batches)

    img_secs = []
    for x in range(args.num_iters):
        t = timeit.timeit(benchmark_step,
                          number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / t
        log(f"Iter #{x}: {img_sec:.1f} img/sec")
        img_secs.append(img_sec)
    log(f"Img/sec: {np.mean(img_secs):.1f} +-{1.96 * np.std(img_secs):.1f}"
        f" ({np.mean(img_secs) / n_dev:.1f}/chip)")


if __name__ == "__main__":
    main()
