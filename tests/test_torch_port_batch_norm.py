"""The port's BatchNorm op (``horovod_tpu_torch.ops.batch_norm``) on the
CPU, where it is the plain formula:

* bit-equal to the ResNet module's formula before the residual add and
  the ReLU moved into the op (forward, input, scale, bias and residual
  gradients, running statistics), fp32 and bf16, ReLU and residual on
  and off, in training and in eval mode;
* the closed-form backward the CUDA kernels compute (two sums a
  channel, then ``dx = a (g - sum g / M - xhat sum g xhat / M)``, the
  last term left out where the clamp cut the variance off, both batch
  terms in eval mode) against autograd of the formula, a clamped channel
  included;
* the wrapper refuses what the kernels do not take, and the ResNet
  blocks give what they gave when they added and activated outside.
"""

import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.ops import batch_norm as bn

MOMENTUM, EPS = 0.9, 1e-5


def _reference(x, weight, bias, running_mean, running_var, train, dtype,
               residual, act):
    """The ResNet module's BatchNorm formula as it stood before the op,
    then ``act(residual + y)`` as the blocks wrote it."""
    xf = x.float()
    if train:
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dim=dims)
        var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        with torch.no_grad():
            running_mean.mul_(MOMENTUM).add_(mean.detach() * (1 - MOMENTUM))
            running_var.mul_(MOMENTUM).add_(var.detach() * (1 - MOMENTUM))
    else:
        mean, var = running_mean, running_var
    shape = [1, -1] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var + EPS) * weight
    y = (xf - mean.reshape(shape)) * mul.reshape(shape) + \
        bias.reshape(shape)
    y = y.to(dtype)
    if residual is not None:
        y = residual + y
    return act(y) if act is not None else y


def _inputs(dtype, residual: bool, shape=(4, 6, 5, 7), seed=0):
    g = torch.Generator().manual_seed(seed)
    C = shape[1]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    w = torch.randn(C, generator=g) * 0.5 + 1
    b = torch.randn(C, generator=g) * 0.5
    rm, rv = torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5
    r = torch.randn(shape, generator=g).to(dtype) if residual else None
    dy = torch.randn(shape, generator=g).to(dtype)
    return x, w, b, rm, rv, r, dy


def _run(fn, x, w, b, rm, rv, r, dy):
    """fn's output, its gradients of ``sum(out * dy)`` for x, w, b and the
    residual, and the running statistics it leaves."""
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    res = r.clone().requires_grad_() if r is not None else None
    rm, rv = rm.clone(), rv.clone()
    out = fn(*leaves, rm, rv, res)
    (out.float() * dy.float()).sum().backward()
    grads = [t.grad for t in leaves] + [res.grad if res is not None else None]
    return out.detach(), grads, (rm, rv)


def _assert_equal(a, b):
    ya, ga, sa = a
    yb, gb, sb = b
    assert ya.dtype == yb.dtype and torch.equal(ya, yb)
    for i, (p, q) in enumerate(zip(ga, gb)):
        assert (p is None) == (q is None), i
        if p is not None:
            assert torch.equal(p, q), i
    for p, q in zip(sa, sb):
        assert torch.equal(p, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["noact", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_plain_path_is_the_module_formula_bit_for_bit(dtype, relu, residual,
                                                      train):
    args = _inputs(dtype, residual)
    act = F.relu if relu else None
    got = _run(lambda x, w, b, rm, rv, r: bn.batch_norm(
        x, w, b, rm, rv, train=train, momentum=MOMENTUM, eps=EPS,
        dtype=dtype, residual=r, relu=relu), *args)
    want = _run(lambda x, w, b, rm, rv, r: _reference(
        x, w, b, rm, rv, train, dtype, r, act), *args)
    _assert_equal(got, want)
    if not train:   # eval leaves the running statistics alone
        assert torch.equal(got[2][0], args[3]) and \
            torch.equal(got[2][1], args[4])
    assert all(v == 0 for v in bn.launches_by_kernel.values())


def _closed_form(x, w, b, rm, rv, r, dy, train, relu):
    """What the four kernels compute, in fp32 torch: the statistics from
    the two sums, the output rounded once, the backward's two sums and
    its apply."""
    xf, M = x.float(), x.numel() // x.shape[1]
    shape = (1, -1, 1, 1)
    if train:
        mean = xf.sum((0, 2, 3)) / M
        raw = (xf * xf).sum((0, 2, 3)) / M - mean * mean
        keep = raw >= 0
        rstd = 1 / torch.sqrt(torch.clamp_min(raw, 0) + EPS)
    else:
        mean, rstd = rm, torch.rsqrt(rv + EPS)
        keep = torch.zeros_like(rm, dtype=torch.bool)
    a = rstd * w
    xc = xf - mean.reshape(shape)
    y = xc * a.reshape(shape) + b.reshape(shape)
    if r is not None:
        y = y + r.float()
    if relu:
        y = F.relu(y)
    g = dy.float() * (y > 0) if relu else dy.float()
    dbeta = g.sum((0, 2, 3))
    dgamma = (g * xc).sum((0, 2, 3)) * rstd
    c_g = a * dbeta / M if train else torch.zeros_like(a)
    c_x = torch.where(keep, a * rstd * dgamma / M, 0) if train else \
        torch.zeros_like(a)
    dx = a.reshape(shape) * g - c_g.reshape(shape) - \
        c_x.reshape(shape) * xc
    return y.to(x.dtype), [dx.to(x.dtype), dgamma, dbeta,
                           g.to(x.dtype) if r is not None else None]


def _clamped_inputs():
    """fp32 inputs whose channel 1 sits at 1000 with noise of 1e-3, where
    the formula's ``E[x^2] - mean^2`` comes out below zero (fp32's
    rounding at 1e6), so the clamp cuts it off while ``x - mean`` is
    still far from zero; channel 2 is constant."""
    x, w, b, rm, rv, r, dy = _inputs(torch.float32, True, (4, 3, 5, 5), 11)
    for seed in range(64):
        x[:, 1] = 1000 + 1e-3 * torch.randn(
            4, 5, 5, generator=torch.Generator().manual_seed(seed))
        x[:, 2] = 1 / 3
        mean = x.mean((0, 2, 3))
        raw = (x * x).mean((0, 2, 3)) - mean * mean
        if raw[1] < 0:
            return x, w, b, rm, rv, r, dy
    raise AssertionError("no seed puts the clamp on channel 1")


@pytest.mark.parametrize("case", ["random", "clamped"])
@pytest.mark.parametrize("relu", [False, True], ids=["noact", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["nores", "res"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_kernels_closed_form_backward_is_autograds(case, relu, residual,
                                                   train):
    if case == "random":
        args = _inputs(torch.float32, residual, seed=3)
    else:
        x, w, b, rm, rv, r, dy = _clamped_inputs()
        args = (x, w, b, rm, rv, r if residual else None, dy)
    y, grads, _ = _run(lambda x, w, b, rm, rv, r: bn.batch_norm(
        x, w, b, rm, rv, train=train, momentum=MOMENTUM, eps=EPS,
        residual=r, relu=relu), *args)
    x, w, b, rm, rv, r, dy = args
    want_y, want = _closed_form(x, w, b, rm, rv, r, dy, train, relu)
    scale = y.abs().max().item()
    assert (y - want_y).abs().max().item() <= 1e-5 * scale
    for i, (got, ref) in enumerate(zip(grads, want)):
        assert (got is None) == (ref is None), i
        if got is not None:
            tol = 1e-4 * ref.abs().max().item() + 1e-6
            assert (got - ref).abs().max().item() <= tol, (i, got, ref)
    assert torch.isfinite(grads[0]).all()


def test_clamped_channel_passes_no_variance_gradient():
    # With the variance term kept, channel 1's input gradient would move
    # by a * rstd * dgamma / M * (x - mean): far above the tolerance of
    # the closed-form test, so that test sees the clamp.
    x, w, b, rm, rv, r, dy = _clamped_inputs()
    _, grads, _ = _run(lambda x, w, b, rm, rv, r: bn.batch_norm(
        x, w, b, rm, rv, train=True, momentum=MOMENTUM, eps=EPS), x, w, b,
        rm, rv, None, dy)
    _, (dx, dgamma, dbeta, _) = _closed_form(x, w, b, rm, rv, None, dy,
                                             True, False)
    rstd = 1 / EPS ** 0.5
    xc = x[:, 1] - x[:, 1].mean()
    term = (w[1] * rstd * rstd * dgamma[1] / x[:, 1].numel()) * xc
    assert term.abs().max() > 1e3 * (grads[0][:, 1] - dx[:, 1]).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_eval_mode_reads_the_running_statistics(dtype):
    x, w, b, rm, rv, _, _ = _inputs(dtype, False)
    y = bn.batch_norm(x, w, b, rm, rv, train=False, momentum=MOMENTUM,
                      eps=EPS, dtype=dtype)
    want = ((x.float() - rm.reshape(1, -1, 1, 1))
            * (torch.rsqrt(rv + EPS) * w).reshape(1, -1, 1, 1)
            + b.reshape(1, -1, 1, 1)).to(dtype)
    assert torch.equal(y, want)


@pytest.mark.parametrize("make", [
    lambda x: x[:, :, :, ::2],
    lambda x: x.transpose(2, 3),
    lambda x: x.contiguous(memory_format=torch.channels_last),
    lambda x: x[0],
    lambda x: x.reshape(4, 6, 35),
], ids=["strided", "transposed", "channels_last", "3d", "nc_l"])
def test_wrapper_refuses_what_the_kernels_do_not_take(make):
    x, w, b, rm, rv, _, _ = _inputs(torch.float32, False)
    with pytest.raises(ValueError):
        bn.batch_norm(make(x), w, b, rm, rv, train=True, momentum=MOMENTUM,
                      eps=EPS)


def test_wrapper_refuses_a_residual_of_another_shape():
    x, w, b, rm, rv, r, _ = _inputs(torch.float32, True)
    with pytest.raises(ValueError):
        bn.batch_norm(x, w, b, rm, rv, train=True, momentum=MOMENTUM,
                      eps=EPS, residual=r[:, :3].contiguous())


def test_module_applies_another_activation_after_the_op():
    torch.manual_seed(0)
    norm = resnet.BatchNorm(6, dtype=torch.float32)
    x, _, _, _, _, r, _ = _inputs(torch.float32, True)
    got = norm(x, True, residual=r, act=torch.tanh)
    want = torch.tanh(bn.batch_norm_plain(
        x, norm.weight, norm.bias, torch.zeros(6), torch.ones(6), True,
        MOMENTUM, EPS, torch.float32, r))
    assert torch.equal(got, want)


def _old_block_forward(block, x, train):
    """The blocks' forward before the residual and the ReLU moved into
    the last norm: the projection after the last norm, add, then act."""
    def norm(module, t):
        return bn.batch_norm_plain(t, module.weight, module.bias,
                                   module.running_mean, module.running_var,
                                   train, module.momentum, module.eps,
                                   module.dtype)
    residual = x
    y = x
    last = len(block.convs) - 1
    for i, (conv, nm) in enumerate(zip(block.convs, block.norms)):
        y = norm(nm, conv(y))
        if i < last:
            y = block.act(y)
    if hasattr(block, "conv_proj"):
        residual = norm(block.norm_proj, block.conv_proj(residual))
    return block.act(residual + y)


@pytest.mark.parametrize("cls,in_ch,filters,strides", [
    (resnet.BottleneckResNetBlock, 16, 4, 1),
    (resnet.BottleneckResNetBlock, 8, 4, 2),
    (resnet.ResNetBlock, 8, 8, 1),
    (resnet.ResNetBlock, 4, 8, 2),
], ids=["bottleneck", "bottleneck_proj", "basic", "basic_proj"])
def test_blocks_give_what_they_gave_before_the_fusion(cls, in_ch, filters,
                                                      strides):
    torch.manual_seed(1)
    block = cls(in_ch, filters, F.relu, strides, dtype=torch.float32)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape) * 0.3 + (1 if p.dim() == 1 else 0))
    old = cls(in_ch, filters, F.relu, strides, dtype=torch.float32)
    old.load_state_dict(block.state_dict())
    x = torch.randn(2, in_ch, 8, 8)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = block(xa), _old_block_forward(old, xb, True)
    assert torch.equal(got, want)
    got.sum().backward()
    want.sum().backward()
    assert torch.equal(xa.grad, xb.grad)
    for (name, p), q in zip(block.named_parameters(), old.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, p), q in zip(block.named_buffers(), old.buffers()):
        assert torch.equal(p, q), name
