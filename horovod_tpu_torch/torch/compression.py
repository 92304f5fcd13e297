"""Gradient compression for torch tensors (reference:
torch/compression.py — same Compressor interface as the TF variant)."""

from ..ops.compression import (BF16Compressor, Compression, Compressor,
                               FP16Compressor, NoneCompressor)

__all__ = ["Compression", "Compressor", "NoneCompressor",
           "FP16Compressor", "BF16Compressor"]
