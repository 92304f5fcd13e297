"""Small MNIST models — the keras_mnist baseline workload.

Counterpart of :mod:`horovod_tpu.models.mnist` (reference:
examples/keras/keras_mnist.py uses a small convnet with
DistributedOptimizer).  Images are NCHW (``[B, 1, 28, 28]``) or
``[B, 28, 28]``; everything is fp32.
"""

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .gpt import _init_rng, _trunc_normal, resolve_device


def _init(model: nn.Module, seed: int, device):
    # flax's defaults: lecun_normal kernels, zero biases.
    rng = _init_rng(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _trunc_normal(m.weight, m.weight[0].numel(), rng)
            nn.init.zeros_(m.bias)
    model.to(resolve_device(device))


class MnistMLP(nn.Module):
    """Three Dense layers (flax's ``Dense_0..2`` as ``dense.0..2``).
    Weights are random from ``seed`` (flax's initializers), on
    ``device`` (``None``: the card)."""

    def __init__(self, hidden: int = 512, num_classes: int = 10,
                 in_features: int = 28 * 28, device=None, seed: int = 0):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(in_features, hidden),
                                    nn.Linear(hidden, hidden),
                                    nn.Linear(hidden, num_classes)])
        _init(self, seed, device)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        return self.dense[2](x)


class MnistCNN(nn.Module):
    """conv 32 → conv 64 (3x3, SAME at stride 1: padding 1) → 2x2 max-pool
    → Dense 128 → Dense (flax's ``Conv_0..1``/``Dense_0..1`` as
    ``conv.0..1``/``dense.0..1``).  The pooled map is flattened in
    (C, H, W) order; :func:`convert_flax_mnist_params` permutes the
    flax kernel's (H, W, C) rows to it."""

    def __init__(self, num_classes: int = 10, size: int = 28, device=None,
                 seed: int = 0):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(1, 32, 3, padding=1),
                                   nn.Conv2d(32, 64, 3, padding=1)])
        self.dense = nn.ModuleList([
            nn.Linear(64 * (size // 2) ** 2, 128),
            nn.Linear(128, num_classes)])
        _init(self, seed, device)

    def forward(self, x):
        if x.dim() == 3:
            x = x[:, None]
        x = F.relu(self.conv[0](x))
        x = F.relu(self.conv[1](x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.dense[0](x.flatten(1)))
        return self.dense[1](x)


def cross_entropy_loss(logits, labels):
    logp = torch.gather(F.log_softmax(logits, dim=-1), -1,
                        labels.long()[:, None])
    return -logp.mean()


def convert_flax_mnist_params(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MnistMLP`` or ``MnistCNN`` parameters (nested
    as flax returns them, a leading ``params`` level allowed) as this
    module's ``state_dict`` (fp32, CPU): conv kernels HWIO become OIHW,
    Dense kernels ``[in, out]`` become ``[out, in]``; the CNN's first
    Dense kernel has its rows permuted from the flattened NHWC order to
    NCHW."""
    params = params.get("params", params)
    channels = None
    if "Conv_1" in params:
        channels = np.asarray(params["Conv_1"]["kernel"]).shape[-1]
    sd = {}
    for mod, leaves in params.items():
        kind, _, num = mod.rpartition("_")
        prefix = {"Conv": "conv", "Dense": "dense"}[kind] + "." + num
        for leaf, value in leaves.items():
            arr = np.asarray(value, dtype=np.float32)
            if leaf == "bias":
                sd[f"{prefix}.bias"] = torch.tensor(arr)
                continue
            if kind == "Conv":
                arr = arr.transpose(3, 2, 0, 1)
            else:
                if mod == "Dense_0" and channels is not None:
                    side = int(round((arr.shape[0] // channels) ** 0.5))
                    arr = arr.reshape(side, side, channels, -1).transpose(
                        2, 0, 1, 3).reshape(arr.shape[0], -1)
                arr = arr.T
            sd[f"{prefix}.weight"] = torch.tensor(np.ascontiguousarray(arr))
    return sd
