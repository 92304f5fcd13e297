"""A launched rank whose optimizer leaves the exchange out: each rank
steps on its own gradient, as if the allreduce never ran.  Only the
harness's fault test runs it."""

from horovod_tpu_torch.torch import optimizer

from hvdbench import worker

_synchronize = optimizer._DistributedOptimizer.synchronize


def _local_synchronize(self):
    local = {p: p.grad.detach().clone() for p in self._requires_update
             if p.grad is not None}
    _synchronize(self)
    for p, g in local.items():
        p.grad.copy_(g)


optimizer._DistributedOptimizer.synchronize = _local_synchronize

if __name__ == "__main__":
    worker.main()
