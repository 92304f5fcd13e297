"""Gradient compression algorithms on torch tensors.

Mirrors the reference compression API (reference:
tensorflow/compression.py:46-74, torch/compression.py — a Compressor
with compress/decompress returning (tensor, ctx), selected via
``Compression.none`` / ``Compression.fp16``).  Counterpart of
:mod:`horovod_tpu.ops.compression`, which also offers a bf16 wire
format (same 8-bit exponent as fp32, no range loss).
"""

import torch


class Compressor:
    """Interface: compress returns (compressed_tensor, ctx);
    decompress(tensor, ctx) restores the original dtype."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Cast floating tensors to fp16 for the wire; restore on receive."""

    @staticmethod
    def compress(tensor):
        if tensor.is_floating_point() and tensor.dtype != torch.float16:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class BF16Compressor(Compressor):
    """bfloat16 wire format (fp32 exponent range preserved)."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype in (torch.float32, torch.float64):
            return tensor.to(torch.bfloat16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class Compression:
    """Optional gradient compression algorithm used during allreduce."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
