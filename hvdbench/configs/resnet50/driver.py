"""The port's ResNet-50 training step for the ``resnet50`` cells, as
upstream Horovod's synthetic benchmark builds it: ``horovod_tpu_torch``'s
``ResNet50`` (bf16 compute, fp32 BatchNorm), ``SGD(lr=0.01 x size)``
inside ``hvd.DistributedOptimizer``, cuDNN's autotuner on, the
benchmark's weights copied in."""

import torch
import torch.nn.functional as F

from horovod_tpu_torch.models import resnet


class Program:
    clip = None

    def __init__(self, cfg: dict, weights: dict, device, hvd, dtype=None):
        port = cfg["port"]
        torch.backends.cudnn.benchmark = port["cudnn_benchmark"]
        if cfg["block"] != "bottleneck":
            raise ValueError(f"resnet50 driver: block {cfg['block']!r}")
        # Built on the meta device, so the port draws no weights of its
        # own; the benchmark's are copied in.
        with torch.device("meta"):
            model = resnet.ResNet(
                cfg["stage_sizes"], resnet.BottleneckResNetBlock,
                num_classes=cfg["num_classes"],
                num_filters=cfg["num_filters"],
                dtype=dtype or getattr(torch, port["compute_dtype"]),
                in_channels=cfg["in_channels"], device="meta")
        model.to_empty(device=device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
            for name, b in model.named_buffers():
                b.fill_(1.0 if name.endswith("running_var") else 0.0)
        for m in model.modules():
            if isinstance(m, resnet.BatchNorm):
                m.momentum, m.eps = cfg["bn_momentum"], cfg["bn_epsilon"]
        self.model = model.train()
        inner = torch.optim.SGD(
            model.parameters(),
            lr=cfg["training"]["lr_per_rank"] * hvd.size(),
            momentum=cfg["training"]["momentum"],
            weight_decay=cfg["training"]["weight_decay"])
        self.opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters())
        self.params = dict(model.named_parameters())

    def loss(self, batch):
        images, labels = batch
        return F.cross_entropy(self.model(images), labels)


def build(cfg: dict, traffic: dict, weights: dict, device, hvd, **kw):
    return Program(cfg, weights, device, hvd, **kw)
