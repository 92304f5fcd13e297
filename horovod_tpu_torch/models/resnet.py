"""ResNet v1.5 family, bfloat16 compute with fp32 parameters.

Counterpart of :mod:`horovod_tpu.models.resnet`, the benchmark
workhorse: the reference's headline numbers are ResNet synthetic-
benchmark images/sec (reference:
examples/pytorch/pytorch_synthetic_benchmark.py, metric defined at
:106-118).  Images are NCHW, as torch and the reference's benchmark
take them.  Convolutions are cuDNN's (the JAX package lowers them to
XLA convolutions, not to a kernel of its own).

What it keeps of the flax model, where torch's defaults differ:

* ``padding="SAME"``: a stride-2 3x3 convolution or max-pool on an even
  size pads (0, 1), not (1, 1) (:func:`same_padding`); the max-pool pads
  with -inf.
* :class:`BatchNorm` is flax's: statistics in fp32 from the bf16
  activations, ``E[x^2] - E[x]^2`` clipped at 0, running averages with
  momentum 0.9 of the *biased* batch variance, epsilon 1e-5.
* Each block's last norm starts with a zero scale.
* The head is a fp32 ``Linear`` on the bf16 spatial mean.
"""

from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.timeline import span
from ..ops.batch_norm import batch_norm
from .gpt import _init_rng, _trunc_normal, resolve_device


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial dim under XLA's ``SAME``: the
    output has ``ceil(size / stride)`` entries and the high side takes
    the odd one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    (top, bottom), (left, right) = (same_padding(s, kernel, stride)
                                    for s in x.shape[-2:])
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """flax ``max_pool(x, (k, k), strides=(s, s), padding="SAME")``."""
    return F.max_pool2d(_pad_same(x, kernel, stride, float("-inf")),
                        kernel, stride)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: fp32 ``weight`` [O, I, kh, kw],
    computed in ``dtype``; ``padding`` is ``"SAME"`` or explicit
    ``(ph, pw)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, padding="SAME", dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel,
                                               kernel))
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        if self.padding == "SAME":
            x, pad = _pad_same(x, self.kernel, self.stride), 0
        else:
            pad = self.padding
        return F.conv2d(x, self.weight.to(self.dtype), None, self.stride,
                        pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW
    channels: ``weight``/``bias`` (flax's scale/bias) and the running
    ``running_mean``/``running_var`` (flax's batch_stats mean/var), all
    fp32; output in ``dtype``.  The op is
    :func:`horovod_tpu_torch.ops.batch_norm.batch_norm`: the plain
    formula on the CPU, the hand-written kernels on the card."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(num_features) if zero_scale
            else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.momentum, self.eps, self.dtype = momentum, eps, dtype

    def forward(self, x, train: bool = True, residual=None,
                act: Optional[Callable] = None):
        """``act(norm(x) + residual)``; ``act`` (``None``: none) and the
        residual add run inside the op where ``act`` is ``F.relu``."""
        relu = act is F.relu
        y = batch_norm(x, self.weight, self.bias, self.running_mean,
                       self.running_var, train=train, momentum=self.momentum,
                       eps=self.eps, dtype=self.dtype, residual=residual,
                       relu=relu)
        return y if act is None or relu else act(y)


class ResNetBlock(nn.Module):
    """Two 3x3 convolutions (ResNet-18/34); ``convs``/``norms`` are
    flax's ``Conv_0..1``/``BatchNorm_0..1``; a projection
    (``conv_proj``, ``norm_proj``) where the shape changes."""
    expansion = 1

    def __init__(self, in_ch: int, filters: int, act: Callable,
                 strides: int = 1, dtype=torch.bfloat16):
        super().__init__()
        conv = partial(Conv, dtype=dtype)
        norm = partial(BatchNorm, dtype=dtype)
        self.convs = nn.ModuleList([conv(in_ch, filters, 3, strides),
                                    conv(filters, filters, 3)])
        self.norms = nn.ModuleList([norm(filters),
                                    norm(filters, zero_scale=True)])
        self.act = act
        if strides != 1 or in_ch != filters:
            self.conv_proj = conv(in_ch, filters, 1, strides)
            self.norm_proj = norm(filters)

    def forward(self, x, train: bool = True):
        residual = x
        y = self.norms[0](self.convs[0](x), train, act=self.act)
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(residual), train)
        return self.norms[1](self.convs[1](y), train, residual=residual,
                             act=self.act)


class BottleneckResNetBlock(nn.Module):
    """1x1 → 3x3 (the stride, v1.5) → 1x1 x4 (ResNet-50/101/152)."""
    expansion = 4

    def __init__(self, in_ch: int, filters: int, act: Callable,
                 strides: int = 1, dtype=torch.bfloat16):
        super().__init__()
        conv = partial(Conv, dtype=dtype)
        norm = partial(BatchNorm, dtype=dtype)
        self.convs = nn.ModuleList([conv(in_ch, filters, 1),
                                    conv(filters, filters, 3, strides),
                                    conv(filters, filters * 4, 1)])
        self.norms = nn.ModuleList([norm(filters), norm(filters),
                                    norm(filters * 4, zero_scale=True)])
        self.act = act
        if strides != 1 or in_ch != filters * 4:
            self.conv_proj = conv(in_ch, filters * 4, 1, strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x, train: bool = True):
        residual = x
        y = self.norms[0](self.convs[0](x), train, act=self.act)
        y = self.norms[1](self.convs[1](y), train, act=self.act)
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(residual), train)
        return self.norms[2](self.convs[2](y), train, residual=residual,
                             act=self.act)


class ResNet(nn.Module):
    """``forward(x, train=None)``: NCHW images (any float type) →
    fp32 logits; ``train`` (by default ``self.training``) normalizes
    with the batch's statistics and updates the running ones, else
    with the running ones.  Weights are random from ``seed`` (flax's
    initializers), on ``device`` (``None``: the card)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, act: Callable = F.relu,
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(in_channels, num_filters, 7, 2,
                              padding=(3, 3), dtype=dtype)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        self.act = act
        blocks, in_ch = [], num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(in_ch, filters, act, strides,
                                        dtype=dtype))
                in_ch = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes)
        rng = _init_rng(seed)
        for m in self.modules():
            if isinstance(m, Conv):
                _trunc_normal(m.weight, m.weight[0].numel(), rng)
        _trunc_normal(self.head.weight, in_ch, rng)
        with torch.no_grad():
            self.head.bias.zero_()
        self.to(resolve_device(device))

    def flax_path(self, name: str) -> str:
        """The flax path of this model's parameter or buffer ``name``
        (:func:`flax_path` with this model's block class)."""
        return flax_path(name, type(self.blocks[0]).__name__)

    def forward(self, x, train: Optional[bool] = None):
        with span("resnet.forward"):
            train = self.training if train is None else train
            with span("resnet.stem"):
                x = x.to(self.dtype)
                x = self.bn_init(self.conv_init(x), train, act=self.act)
                x = max_pool_same(x, 3, 2)
            for i, block in enumerate(self.blocks):
                with span("resnet.block", block=i):
                    x = block(x, train)
            with span("resnet.head"):
                x = x.mean(dim=(2, 3))
                return self.head(x.float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2],
                   block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckResNetBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckResNetBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckResNetBlock)


def _flat(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if not hasattr(tree, "items"):
        return {prefix: np.asarray(tree, dtype=np.float32)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# The port's names of the modules that flax names after their class
# (``{Class}_{index}``); every other module keeps flax's name.
_LISTS = {"ResNetBlock": "blocks", "BottleneckResNetBlock": "blocks",
          "Conv": "convs", "BatchNorm": "norms"}


def _module_path(parts) -> str:
    names = []
    for p in parts:
        head, _, num = p.rpartition("_")
        if head in _LISTS:
            names += [_LISTS[head], num]
        elif p == "Dense_0":
            names.append("head")
        else:
            names.append(p)
    return ".".join(names)


def flax_path(name: str, block: str) -> str:
    """The flax path of the parameter or buffer ``name`` of a ResNet
    whose blocks are ``block`` (a class name): the inverse of the
    converter's map, e.g. ``blocks.3.convs.1.weight`` is
    ``BottleneckResNetBlock_3/Conv_1/kernel``."""
    *mods, leaf = name.split(".")
    classes = {"blocks": block, "convs": "Conv", "norms": "BatchNorm"}
    path, i = [], 0
    while i < len(mods):
        if mods[i] in classes:
            path.append(f"{classes[mods[i]]}_{mods[i + 1]}")
            i += 2
        else:
            path.append("Dense_0" if mods[i] == "head" else mods[i])
            i += 1
    if leaf == "weight":
        leaf = ("kernel" if path[-1].startswith(("Conv", "conv", "Dense"))
                else "scale")
    else:
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf,
                                                                  leaf)
    return "/".join(path + [leaf])


def convert_flax_resnet_params(params, batch_stats
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNet variables (``params`` and
    ``batch_stats``, nested as flax returns them or flattened with
    ``/``) as this module's ``state_dict`` (fp32, CPU): conv kernels
    HWIO become OIHW weights, the Dense kernel ``[in, out]`` becomes the
    head's ``[out, in]``, BN ``scale``/``bias``/``mean``/``var`` become
    ``weight``/``bias``/``running_mean``/``running_var``."""
    leaf_names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}
    sd = {}
    for tree in (params, batch_stats):
        for key, arr in _flat(tree).items():
            parts = key.split("/")
            if parts[0] in ("params", "batch_stats"):
                parts = parts[1:]
            mod, leaf = parts[:-1], parts[-1]
            if leaf == "kernel":
                name = "weight"
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            elif leaf in leaf_names:
                name = leaf_names[leaf]
            else:
                raise KeyError(f"unexpected flax ResNet variable {key!r}")
            sd[f"{_module_path(mod)}.{name}"] = torch.tensor(
                np.ascontiguousarray(arr))
    return sd
