"""flax's BatchNorm over NCHW channels, with the block's residual add and
ReLU fused in: the hand-written CUDA kernels of ``kernels/batch_norm.cu``
and their plain PyTorch version.

No TPU kernel precedes them: flax's ``nn.BatchNorm`` is left to XLA,
which fuses it with its neighbours.  In eager PyTorch the formula is
some twenty launches a layer forward and as many backward; here the
forward is two kernels (the statistics, then normalise, add and ReLU)
and so is the backward (the two sums, then the input's gradient).

The function (:func:`batch_norm`), for ``x`` ``[N, C, H, W]``:

    y = act((x - mean) * rsqrt(var + eps) * weight + bias [+ residual])

with, in training, ``mean`` and ``var = max(E[x^2] - mean^2, 0)`` over
``N, H, W`` in fp32 and the running statistics updated in place with
the momentum and that (biased) variance; otherwise the running
statistics.  ``act`` is ReLU or none.

On a CUDA tensor it launches the kernels or raises; on a CPU tensor it
is :func:`batch_norm_plain`.
"""

import ctypes

import torch
import torch.nn.functional as F

from .flash_attention import _launch_error

# The kernels, in launch order: forward, then backward.
KERNELS = ("hvd_batchnorm_stats", "hvd_batchnorm_apply",
           "hvd_batchnorm_bwd_stats", "hvd_batchnorm_bwd_apply")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # x, residual, y, dtype, n, c, hw, train, stats, running mean,
    # running var, momentum, 1 - momentum, eps, weight, bias, relu,
    # workspace, pairs, stream
    "hvd_bn_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _F, _F,
                       _F, _P, _P, _I, _P, _I, _P],
    # dy, y, x, dx, dresidual, dtype, n, c, hw, train, stats, weight,
    # dweight, dbias, workspace, pairs, stream
    "hvd_bn_backward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# Channels' partial sums a workspace holds: at least the card's blocks
# at once (132 SMs x 8 blocks) and every channel.
_MIN_PAIRS = 4096

# Kernel launches since the process started, by kernel; bumped by the
# CUDA path only.
launches_by_kernel = {name: 0 for name in KERNELS}

_lib = None
# (device index, stream) -> (fp32 workspace of 3 x pairs: the partial
# sums, then the tickets, which each kernel leaves at zero; pairs).
_workspaces = {}


def _library():
    global _lib
    from .. import kernels
    lib = kernels.load("batch_norm.cu")
    if _lib is not lib:
        for name, types in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = types, ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return lib


def _launch(entry: str, x, *args):
    """Calls the C ``entry`` on ``x``'s device with ``args`` (tensors as
    pointers, ``None`` as a null pointer), then the workspace and the
    current stream; raises on a failed launch.  Kept lean: a ResNet-50
    step makes 106 of these calls."""
    lib = _lib if _lib is not None else _library()
    device = x.device
    stream = torch.cuda.current_stream(device).cuda_stream
    ws = _workspaces.get((device.index, stream))
    if ws is None or ws[1] < x.shape[1]:
        pairs = max(x.shape[1], _MIN_PAIRS)
        ws = (torch.zeros(3 * pairs, dtype=torch.float32, device=device),
              pairs)
        _workspaces[(device.index, stream)] = ws
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args] + [ws[0].data_ptr(), ws[1], stream]
    fn = getattr(lib, entry)
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise _launch_error(lib, err, f"{entry} failed ({x.dtype}, "
                            f"{tuple(x.shape)})")


def batch_norm_plain(x, weight, bias, running_mean, running_var, train: bool,
                     momentum: float, eps: float, dtype, residual=None,
                     relu: bool = False):
    """The formula in PyTorch, fp32 from ``x.float()``, the output cast to
    ``dtype`` before the residual add and the ReLU."""
    xf = x.float()
    if train:
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dim=dims)
        var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean.detach() * (1 - momentum))
            running_var.mul_(momentum).add_(var.detach() * (1 - momentum))
    else:
        mean, var = running_mean, running_var
    shape = [1, -1] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean.reshape(shape)) * mul.reshape(shape) + \
        bias.reshape(shape)
    y = y.to(dtype)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


class _BatchNorm(torch.autograd.Function):
    """The CUDA path.  Saves ``x``, the output where ReLU was fused (the
    next convolution keeps the same storage) and the fp32 ``[3, C]``
    statistics: nothing the size of an activation in fp32."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                train, momentum, eps, relu):
        N, C, H, W = x.shape
        y = torch.empty_like(x)
        stats = (torch.empty(3, C, dtype=torch.float32, device=x.device)
                 if train else None)
        _launch("hvd_bn_forward", x, x, residual, y, _DTYPES[x.dtype], N, C,
                H * W, int(train), stats, running_mean, running_var,
                momentum, 1 - momentum, eps, weight, bias, int(relu))
        launches_by_kernel["hvd_batchnorm_stats"] += train
        launches_by_kernel["hvd_batchnorm_apply"] += 1
        if not train and any(ctx.needs_input_grad[:4]):
            # The statistics as the backward reads them: no batch terms.
            stats = torch.stack([running_mean, torch.rsqrt(running_var + eps),
                                 torch.zeros_like(running_var)])
        ctx.save_for_backward(x, y if relu else None, stats, weight)
        ctx.train, ctx.has_residual = train, residual is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, stats, weight = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        N, C, H, W = x.shape
        dweight = torch.empty(C, dtype=torch.float32, device=x.device)
        dbias = torch.empty_like(dweight)
        dx = torch.empty_like(x)
        dres = (torch.empty_like(x) if ctx.has_residual and y is not None
                else None)
        _launch("hvd_bn_backward", x, dy, y, x, dx, dres, _DTYPES[x.dtype],
                N, C, H * W, int(ctx.train), stats, weight, dweight, dbias)
        launches_by_kernel["hvd_batchnorm_bwd_stats"] += 1
        launches_by_kernel["hvd_batchnorm_bwd_apply"] += 1
        if ctx.has_residual and y is None:
            dres = dy
        return dx, dweight, dbias, dres, None, None, None, None, None, None


def _check(x, weight, bias, running_mean, running_var, residual, dtype):
    if x.dim() != 4:
        raise ValueError(f"batch_norm: x must be NCHW [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"batch_norm: x must be contiguous NCHW, got "
                         f"strides {x.stride()}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"batch_norm: the residual must be contiguous "
                         f"{tuple(x.shape)} on {x.device}, got "
                         f"{tuple(residual.shape)} on {residual.device}")
    if not x.is_cuda:
        return
    C = x.shape[1]
    if x.dtype not in _DTYPES or dtype != x.dtype:
        raise ValueError(f"batch_norm: the kernels take fp32, fp16 or bf16 "
                         f"in and out in one type, got {x.dtype} to {dtype}")
    if residual is not None and residual.dtype != x.dtype:
        raise ValueError(f"batch_norm: the residual is {residual.dtype}, x "
                         f"{x.dtype}")
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.dtype != torch.float32 or t.shape != (C,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"batch_norm: {name} must be contiguous fp32 "
                             f"[{C}] on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.numel() == 0:
        raise ValueError(f"batch_norm: no values to normalise in "
                         f"{tuple(x.shape)}")


def batch_norm(x, weight, bias, running_mean, running_var, *, train: bool,
               momentum: float, eps: float, dtype=None, residual=None,
               relu: bool = False):
    """flax's BatchNorm of contiguous NCHW ``x`` (fp32 ``weight``,
    ``bias`` and running statistics, the latter updated in place when
    ``train``), output in ``dtype`` (by default ``x``'s; on the card it
    must be ``x``'s), then ``+ residual`` and ReLU where asked."""
    dtype = x.dtype if dtype is None else dtype
    _check(x, weight, bias, running_mean, running_var, residual, dtype)
    if not x.is_cuda:
        return batch_norm_plain(x, weight, bias, running_mean, running_var,
                                train, momentum, eps, dtype, residual, relu)
    return _BatchNorm.apply(x, weight, bias, residual, running_mean,
                            running_var, bool(train), float(momentum),
                            float(eps), bool(relu))
