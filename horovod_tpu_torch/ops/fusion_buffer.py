"""The fusion buffer: pack a fused response's tensors into one flat
buffer with a prescale, and unpack the flat result with a postscale.

Counterpart of the fused per-tensor XLA program
(:mod:`horovod_tpu.ops.xla_ops` ``_allreduce_fn``: scale, collective,
scale) and of the ring's persistent fusion buffer
(:mod:`horovod_tpu.ops.ring_ops` ``_fused``).  On CUDA tensors
:func:`pack` and :func:`unpack` launch the hand-written kernel in
``kernels/fusion_buffer.cu`` (the reference's ``batched_memcpy_k`` and
``scale_buffer_k``); on CPU tensors they run the plain version,
``torch.cat`` of flat views scaled by ``backend._scale`` and ``copy_``
back.  A CUDA tensor launches the kernel or raises: it never takes the
plain version.

Each tensor starts at an offset rounded up to 16 bytes
(``BATCHED_D2D_PADDING`` in the reference's controller), so the kernel
moves 16-byte vectors; the padding is zero after a pack and never
reaches an output.
"""

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..common.timeline import span
from .backend import _scale

ALIGN_BYTES = 16
_DTYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2,
                torch.int16: 3, torch.int32: 4, torch.int64: 5,
                torch.float16: 6, torch.float32: 7, torch.float64: 8,
                torch.bool: 9, torch.bfloat16: 10}
_ERRORS = {-1: "the kernel does not take this dtype",
           -2: "more entries than one launch takes"}
_NO_LAUNCH = -3

# Kernel launches since the last reset, and calls of the plain version
# (CPU tensors only); bumped where each runs and nowhere else.
launches = {"pack": 0, "unpack": 0}
plain_calls = {"pack": 0, "unpack": 0}

_entry = None


def layout(numels: Sequence[int], dtype: torch.dtype) -> Tuple[List[int], int]:
    """Element offsets of each tensor in the flat buffer, each rounded up
    to 16 bytes, and the buffer's length in elements."""
    per = ALIGN_BYTES // dtype.itemsize
    offsets, off = [], 0
    for n in numels:
        offsets.append(off)
        off += -(-n // per) * per
    return offsets, off


def factor_in(dtype: torch.dtype, factor: float) -> float:
    """``factor`` rounded to ``dtype`` as ``_scale`` rounds it: floats
    multiply by the factor in their own type, integers by the fp64
    factor."""
    if dtype.is_floating_point:
        return float(torch.tensor(factor, dtype=dtype))
    return float(factor)


class FusionBuffers:
    """Persistent flat buffers, one per (device, dtype), grown
    geometrically (the reference's fusion_buffer_manager.{h,cc}).  One
    caller at a time: the runtime dispatches one response at a time."""

    def __init__(self):
        self._bufs: Dict[tuple, torch.Tensor] = {}

    def get(self, device: torch.device, dtype: torch.dtype, n: int,
            pin: bool = False) -> torch.Tensor:
        """A flat view of ``n`` elements; ``pin`` asks for page-locked
        host memory (the staging buffer of a CUDA response over gloo)."""
        key = (str(device), dtype, pin)
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < n:
            cap = max(n, 2 * (buf.numel() if buf is not None else 0), 1 << 16)
            buf = torch.empty(cap, dtype=dtype, device=device, pin_memory=pin)
            self._bufs[key] = buf
        return buf[:n]

    def clear(self):
        """Drop every buffer (a data plane's teardown)."""
        self._bufs.clear()


def _check(tensors: Sequence[torch.Tensor], what: str):
    dtype, device = tensors[0].dtype, tensors[0].device
    for t in tensors:
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"fusion {what}: every tensor must share one "
                             f"dtype and device, got {t.dtype} on {t.device}"
                             f" beside {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"fusion {what}: tensors must be contiguous")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"fusion {what}: dtype {dtype} is not one of "
                         f"{tuple(_DTYPE_CODES)}")


def _flat_out(out, dtype, device, total, what):
    if out is None:
        return torch.empty(total, dtype=dtype, device=device)
    if out.dtype != dtype or out.device != device or out.dim() != 1 or \
            not out.is_contiguous() or out.numel() < total:
        raise ValueError(f"fusion {what}: the flat buffer must be a "
                         f"contiguous 1-D {dtype} tensor on {device} of at "
                         f"least {total} elements")
    return out[:total]


def pack(tensors: Sequence[torch.Tensor], prescale: float = 1.0,
         out: torch.Tensor = None) -> torch.Tensor:
    """``scale(t_i, prescale)`` at each tensor's offset of
    :func:`layout` in one flat buffer (``out`` when given, else fresh),
    zeros in the padding.  Returns the flat buffer."""
    with span("fusion.pack"):
        _check(tensors, "pack")
        dtype, device = tensors[0].dtype, tensors[0].device
        offsets, total = layout([t.numel() for t in tensors], dtype)
        flat = _flat_out(out, dtype, device, total, "pack")
        if flat.is_cuda:
            per = [(t.data_ptr(), flat.data_ptr() + o * flat.element_size(),
                    t.numel(), end - o)
                   for t, o, end in zip(tensors, offsets,
                                        offsets[1:] + [total])]
            _launch("pack", per, dtype, prescale, device)
            return flat
        plain_calls["pack"] += 1
        return pack_plain(tensors, prescale, flat)


def unpack(flat: torch.Tensor, outs: Sequence[torch.Tensor],
           postscale: float = 1.0):
    """Each ``outs[i]`` = ``scale(flat[o_i : o_i + n_i], postscale)``, the
    offsets of :func:`layout` over ``outs``."""
    with span("fusion.unpack"):
        _check([flat, *outs], "unpack")
        offsets, total = layout([t.numel() for t in outs], flat.dtype)
        if flat.dim() != 1 or flat.numel() < total:
            raise ValueError(f"fusion unpack: the flat buffer holds "
                             f"{flat.numel()} elements, the outputs need "
                             f"{total}")
        if flat.is_cuda:
            per = [(flat.data_ptr() + o * flat.element_size(),
                    t.data_ptr(), t.numel(), t.numel())
                   for t, o in zip(outs, offsets)]
            _launch("unpack", per, flat.dtype, postscale, flat.device)
            return
        plain_calls["unpack"] += 1
        unpack_plain(flat, outs, postscale)


def pack_plain(tensors: Sequence[torch.Tensor], prescale: float = 1.0,
               out: torch.Tensor = None) -> torch.Tensor:
    """The plain version of :func:`pack`, on any device."""
    dtype, device = tensors[0].dtype, tensors[0].device
    offsets, total = layout([t.numel() for t in tensors], dtype)
    flat = _flat_out(out, dtype, device, total, "pack")
    if total == 0:
        return flat
    pieces = []
    for t, o, end in zip(tensors, offsets, offsets[1:] + [total]):
        pieces.append(_scale(t.reshape(-1), prescale))
        if end - o > t.numel():
            pieces.append(torch.zeros(end - o - t.numel(), dtype=dtype,
                                      device=device))
    torch.cat(pieces, out=flat)
    return flat


def unpack_plain(flat: torch.Tensor, outs: Sequence[torch.Tensor],
                 postscale: float = 1.0):
    """The plain version of :func:`unpack`, on any device."""
    offsets, _ = layout([t.numel() for t in outs], flat.dtype)
    for t, o in zip(outs, offsets):
        t.copy_(_scale(flat[o:o + t.numel()], postscale).view(t.shape))


def _kernel_lib():
    global _entry
    from .. import kernels
    lib = kernels.load("fusion_buffer.cu")
    if _entry is None or _entry[0] is not lib:
        fn = lib.hvd_fusion_scaled_copy
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.hvd_fusion_max_entries.restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _entry = (lib, fn, lib.hvd_fusion_max_entries())
    return _entry


def _launch(kind: str, per: List[tuple], dtype: torch.dtype, factor: float,
            device: torch.device):
    """One kernel launch per ``max_entries`` rows of (source address,
    destination address, elements, elements written) on the current
    stream of ``device``; counts each launch."""
    lib, fn, max_entries = _kernel_lib()
    f = factor_in(dtype, factor)
    pure_copy = int(factor == 1.0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for i in range(0, len(per), max_entries):
            table = np.asarray(per[i:i + max_entries], dtype=np.int64)
            err = fn(table.ctypes.data, len(table), _DTYPE_CODES[dtype], f,
                     pure_copy, stream)
            if err == _NO_LAUNCH:
                continue
            if err != 0:
                msg = (lib.hvd_cuda_error_string(err).decode() if err > 0
                       else _ERRORS.get(err, f"error {err}"))
                raise RuntimeError(f"fusion {kind} kernel launch failed "
                                   f"({dtype}, {len(table)} tensors): {msg}")
            launches[kind] += 1
