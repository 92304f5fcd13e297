"""Synchronized BatchNorm for PyTorch (reference:
torch/sync_batch_norm.py — batch statistics computed over the global
batch via cross-rank reduction, with a custom backward so gradients
include the d(mean)/dx and d(var)/dx terms).

Counterpart of :mod:`horovod_tpu.torch.sync_batch_norm`.  Forward:
count-weighted stacked moments [count, sum, sum_sq] in float64 are
allreduced (Sum) in one fused tensor; every rank normalizes with the
global mean/var.  Backward: the standard sync-BN gradient needs the
global sums of dy and dy·x̂, which are allreduced the same way.  The
moments are reduced by the port's own allreduce on the input's device:
nothing goes through the host.
"""

import math

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..common.basics import Sum, global_process_set
from .. import ops as _ops


def _allreduce_sum(t: torch.Tensor, name: str, process_set) -> torch.Tensor:
    return _ops.allreduce(t, op=Sum, name=name, process_set=process_set)


def _reduced_dims(x: torch.Tensor):
    return [0] + list(range(2, x.dim()))


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, eps, process_set, op_id):
        dims = _reduced_dims(input)
        count = float(math.prod(input.shape[d] for d in dims))
        local = torch.cat([
            torch.full((1,), count, dtype=torch.float64,
                       device=input.device),
            input.sum(dim=dims).double(),
            (input * input).sum(dim=dims).double()])
        reduced = _allreduce_sum(local.detach(), f"sync_bn_fwd/{op_id}",
                                 process_set)
        num_features = input.shape[1]
        total = float(reduced[0])
        mean = (reduced[1:1 + num_features] / total).to(input.dtype)
        sq_mean = (reduced[1 + num_features:] / total).to(input.dtype)
        var = (sq_mean - mean * mean).clamp_min_(0.0)
        invstd = torch.rsqrt(var + eps)

        shape = [1, num_features] + [1] * (input.dim() - 2)
        xhat = (input - mean.reshape(shape)) * invstd.reshape(shape)
        out = xhat
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.total = total
        ctx.process_set = process_set
        ctx.op_id = op_id
        return out, mean, var

    @staticmethod
    def backward(ctx, grad_output, _grad_mean, _grad_var):
        xhat, weight, invstd = ctx.saved_tensors
        total = ctx.total
        dims = _reduced_dims(grad_output)
        shape = [1, grad_output.shape[1]] + \
            [1] * (grad_output.dim() - 2)

        grad_xhat = grad_output
        if weight is not None:
            grad_xhat = grad_output * weight.reshape(shape)
        local = torch.cat([
            grad_xhat.sum(dim=dims).double(),
            (grad_xhat * xhat).sum(dim=dims).double()])
        reduced = _allreduce_sum(local.detach(), f"sync_bn_bwd/{ctx.op_id}",
                                 ctx.process_set)
        n = grad_output.shape[1]
        sum_dy = reduced[:n].to(grad_output.dtype)
        sum_dy_xhat = reduced[n:].to(grad_output.dtype)

        grad_input = invstd.reshape(shape) * (
            grad_xhat - sum_dy.reshape(shape) / total -
            xhat * sum_dy_xhat.reshape(shape) / total)
        grad_weight = (grad_output * xhat).sum(dim=dims) \
            if weight is not None else None
        grad_bias = grad_output.sum(dim=dims) \
            if weight is not None else None
        return grad_input, grad_weight, grad_bias, None, None, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in BatchNorm{1,2,3}d with cross-rank batch statistics.  At
    size 1 or in eval mode it is torch's ``_BatchNorm``; the running
    variance is torch's unbiased one."""

    _op_counter = 0

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True,
                 process_set=global_process_set):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self._process_set = process_set
        SyncBatchNorm._op_counter += 1
        self._op_id = SyncBatchNorm._op_counter

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input):
        self._check_input_dim(input)
        if not self.training or self._process_set.size() == 1:
            return super().forward(input)

        out, mean, var = _SyncBatchNormFn.apply(
            input, self.weight if self.affine else None,
            self.bias if self.affine else None, self.eps,
            self._process_set, self._op_id)

        if self.track_running_stats:
            with torch.no_grad():
                total = float(math.prod(
                    input.shape[d] for d in _reduced_dims(input))) \
                    * self._process_set.size()
                m = self.momentum if self.momentum is not None else 0.1
                unbiased = var * total / max(total - 1, 1)
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
                self.num_batches_tracked += 1
        return out
