"""ResNet-50 v1.5 in plain PyTorch, float32, TF32 off: the reference that
decides ``correct`` for the ``resnet50`` cells.

He et al. 2016's bottleneck network with the stride on the 3x3
convolution (v1.5), as the flax ImageNet example writes it: ``SAME``
padding (a stride-2 3x3 convolution or max-pool on an even size pads
(0, 1)), BatchNorm on the batch's statistics (biased variance, epsilon
1e-5) after every convolution, a projection where the shape changes, a
global mean and a dense head.  Parameters carry the port's
``state_dict`` names.  Imports nothing of the port.
"""

import torch
import torch.nn.functional as F

from hvdbench import plain


def layout(cfg: dict):
    """(prefix, in, filters, stride, projection) of every bottleneck."""
    blocks, in_ch, i = [], cfg["num_filters"], 0
    for s, size in enumerate(cfg["stage_sizes"]):
        filters = cfg["num_filters"] * 2 ** s
        for j in range(size):
            stride = 2 if s > 0 and j == 0 else 1
            blocks.append((f"blocks.{i}.", in_ch, filters, stride,
                           stride != 1 or in_ch != 4 * filters))
            in_ch, i = 4 * filters, i + 1
    return blocks


def weight_specs(cfg: dict) -> list:
    def conv(name, cin, cout, k):
        return (name, (cout, cin, k, k), "normal", (2.0 / (cout * k * k)) ** 0.5)

    def norm(name, c):
        return [(name + ".weight", (c,), "ones", 0),
                (name + ".bias", (c,), "zeros", 0)]

    nf = cfg["num_filters"]
    specs = [conv("conv_init.weight", cfg["in_channels"], nf, 7)]
    specs += norm("bn_init", nf)
    for p, cin, f, _, proj in layout(cfg):
        for j, (a, b, k) in enumerate(((cin, f, 1), (f, f, 3), (f, 4 * f, 1))):
            specs.append(conv(f"{p}convs.{j}.weight", a, b, k))
            specs += norm(f"{p}norms.{j}", b)
        if proj:
            specs.append(conv(p + "conv_proj.weight", cin, 4 * f, 1))
            specs += norm(p + "norm_proj", 4 * f)
    width = 4 * nf * 2 ** (len(cfg["stage_sizes"]) - 1)
    specs += [("head.weight", (cfg["num_classes"], width), "normal", 0.01),
              ("head.bias", (cfg["num_classes"],), "zeros", 0)]
    return specs


def make_weights(cfg: dict, seed: int, device) -> dict:
    return plain.draw_weights(weight_specs(cfg), seed, device)


def make_rows(cfg: dict, traffic: dict, rows: int, gen, device):
    """``rows`` random normal images and uniform labels."""
    s = cfg["image_size"]
    images = torch.randn(rows, cfg["in_channels"], s, s, generator=gen,
                         device=device)
    labels = torch.randint(0, cfg["num_classes"], (rows,), generator=gen,
                           device=device)
    return images, labels


def rows_of(batch):
    return batch[0].shape[0]


def take_rows(batch, rows: int):
    return batch[0][:rows], batch[1][:rows]


def _same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad(x, k, stride, value=0.0):
    (t, b), (l, r) = (_same(s, k, stride) for s in x.shape[-2:])
    return F.pad(x, (l, r, t, b), value=value)


def loss_of(w: dict, batch, cfg: dict, prec=plain.FP32):
    """Mean cross-entropy of one rank's batch (its own BatchNorm
    statistics).  ``prec.value`` is applied wherever the configuration
    computes in its 16-bit type (``port.compute_dtype``): the images,
    every convolution's output, BatchNorm's output, the residual stream,
    the pooled features; ``prec.operand`` and ``prec.product`` on every
    convolution's operands and output; BatchNorm's statistics, the head
    and the loss stay fp32."""
    images, labels = batch
    eps = cfg["bn_epsilon"]
    rnd = prec.value

    def conv(x, name, stride, pad=None):
        weight = w[name]
        k = weight.shape[-1]
        if pad is None:
            x, pad = _pad(x, k, stride), 0
        return rnd(prec.product(F.conv2d(prec.operand(x),
                                         prec.operand(weight), None,
                                         stride, pad)))

    def bn(x, name):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        scale = w[name + ".weight"].view(1, -1, 1, 1)
        shift = w[name + ".bias"].view(1, -1, 1, 1)
        return rnd((x - mean) * torch.rsqrt(var + eps) * scale + shift)

    x = rnd(images)
    x = F.relu(bn(conv(x, "conv_init.weight", 2, pad=3), "bn_init"))
    x = F.max_pool2d(_pad(x, 3, 2, float("-inf")), 3, 2)
    for p, _, _, stride, proj in layout(cfg):
        y = F.relu(bn(conv(x, p + "convs.0.weight", 1), p + "norms.0"))
        y = F.relu(bn(conv(y, p + "convs.1.weight", stride), p + "norms.1"))
        y = bn(conv(y, p + "convs.2.weight", 1), p + "norms.2")
        if proj:
            x = bn(conv(x, p + "conv_proj.weight", stride), p + "norm_proj")
        x = F.relu(rnd(x + y))
    logits = rnd(x.mean(dim=(2, 3))) @ w["head.weight"].t() + w["head.bias"]
    return F.cross_entropy(logits, labels)


def grads_of(params: dict, batch, cfg: dict, prec=plain.FP32):
    w = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = loss_of(w, batch, cfg, prec)
    loss.backward()
    return float(loss.detach()), {n: w[n].grad for n in w}


def optimizer(params: dict, cfg: dict, ranks: int):
    return plain.SGD(params, cfg["training"]["lr_per_rank"] * ranks)


def train(cfg: dict, weights: dict, batches, prec=plain.FP32, **_) -> dict:
    """:func:`plain.train` of this model from ``weights`` (changed in
    place) on ``batches[step][rank]``; the whole of a rank's batch at
    once, since BatchNorm's statistics are the batch's."""
    with plain.full_fp32():
        return plain.train(weights, batches,
                           lambda p, b: grads_of(p, b, cfg, prec),
                           optimizer(weights, cfg, len(batches[0])))
