"""Grouped products over the experts of a mixture-of-experts layer: the
hand-written CUDA kernels of ``kernels/moe_gemm.cu`` and their plain
PyTorch versions.

No TPU kernel precedes them: the JAX package's expert layer runs one
expert per rank as a dense product over a fixed-capacity bucket.  Here
one launch covers every expert a rank holds, each with as many rows as
routing gave it, and the per-expert offsets stay on the device.

The rows of the experts lie side by side, expert ``e``'s in rows
``offsets[e] .. offsets[e+1]``; each expert's rows start at a multiple
of :data:`ALIGN` (:func:`padded_offsets`), and the rows that pad an
expert to a whole tile are zero.  Two products cover a training step:

- :func:`grouped_rows`: ``c[r] = a[r] . b[e]^T`` for the rows ``r`` of
  expert ``e`` (the forward ``Y = X W^T``, and ``dX = dY W`` with the
  weights transposed);
- :func:`grouped_k`: ``c[e] = a[:, seg e] . b[:, seg e]^T``, the
  weight gradient ``dW = dY^T X`` over the expert's own rows (an expert
  with none gets zeros).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
is the plain per-expert loop, which reads the offsets on the host.
"""

import ctypes

import torch

from .flash_attention import _launch_error

# Rows of one output tile: each expert's rows start at a multiple of it.
ALIGN = 128
# The kernels, in the order of the C entry's mode argument.
KERNELS = ("moe_gemm_rows", "moe_gemm_k")

# Kernel launches since the process started, by kernel; bumped by the
# CUDA path only.
launches_by_kernel = {name: 0 for name in KERNELS}

_entry = None


def _kernel_fn():
    global _entry
    from .. import kernels
    lib = kernels.load("moe_gemm.cu")
    if _entry is None or _entry[0] is not lib:
        fn = lib.hvd_moe_gemm
        # a, b, c, offsets; mode, experts, a_rows, cols, m, n; stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _entry = (lib, fn)
    return _entry


def padded_offsets(counts: torch.Tensor) -> torch.Tensor:
    """``[E + 1]`` int32 row offsets, on ``counts``' device, of experts
    holding ``counts`` rows each, every expert padded to a multiple of
    :data:`ALIGN` rows."""
    padded = (counts + (ALIGN - 1)) // ALIGN * ALIGN
    return torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)]).int()


def _check(name, tensors, offsets, experts):
    device, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: operands must share dtype and "
                             f"device, got {t.dtype} on {t.device}")
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16, got {dtype}")
    if (offsets.dtype != torch.int32 or offsets.shape != (experts + 1,)
            or offsets.device != device):
        raise ValueError(f"{name}: offsets must be int32 [{experts + 1}] "
                         f"on {device}, got {offsets.dtype} "
                         f"{tuple(offsets.shape)} on {offsets.device}")


def _launch(name, a, b, c, offsets, experts, a_rows, cols, m, n):
    a, b = (t.contiguous() for t in (a, b))
    a, b = (t.clone() if t.data_ptr() % 16 else t for t in (a, b))
    lib, fn = _kernel_fn()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 offsets.contiguous().data_ptr(), KERNELS.index(name), experts,
                 a_rows, cols, m, n, stream)
    if err == 0:
        launches_by_kernel[name] += 1
    elif err != -3:
        raise _launch_error(lib, err, f"{name} launch failed (a "
                            f"{tuple(a.shape)}, b {tuple(b.shape)})")


def grouped_rows(a: torch.Tensor, b: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """``a [R, K]``, ``b [E, N, K]``, ``offsets [E + 1]``: ``c [R, N]``
    with ``c[r] = a[r] . b[e]^T`` for every row ``r`` of expert ``e``.
    Rows outside every expert's are left undefined on the card (zero on
    the CPU)."""
    E, N, K = b.shape
    R = a.shape[0]
    _check("grouped_rows", (a, b), offsets, E)
    if a.shape[1] != K:
        raise ValueError(f"grouped_rows: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ in K")
    if not a.is_cuda:
        c = a.new_zeros(R, N)
        bounds = offsets.tolist()
        for e in range(E):
            lo, hi = bounds[e], bounds[e + 1]
            c[lo:hi] = torch.matmul(a[lo:hi], b[e].t())
        return c
    c = torch.empty(R, N, dtype=a.dtype, device=a.device)
    _launch("moe_gemm_rows", a, b, c, offsets, E, R, K, 0, N)
    return c


def grouped_k(a: torch.Tensor, b: torch.Tensor,
              offsets: torch.Tensor) -> torch.Tensor:
    """``a [M, R]``, ``b [N, R]``, ``offsets [E + 1]``: ``c [E, M, N]``
    with ``c[e] = a[:, seg e] . b[:, seg e]^T`` over the columns of
    expert ``e`` (zeros for an expert with none)."""
    M, R = a.shape
    N = b.shape[0]
    E = offsets.shape[0] - 1
    _check("grouped_k", (a, b), offsets, E)
    if b.shape[1] != R:
        raise ValueError(f"grouped_k: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ in R")
    if not a.is_cuda:
        c = a.new_zeros(E, M, N)
        bounds = offsets.tolist()
        for e in range(E):
            lo, hi = bounds[e], bounds[e + 1]
            c[e] = torch.matmul(a[:, lo:hi], b[:, lo:hi].t())
        return c
    # With no column at all there is no K step and no launch: zeros.
    c = (torch.empty if R else torch.zeros)(E, M, N, dtype=a.dtype,
                                            device=a.device)
    _launch("moe_gemm_k", a, b, c, offsets, E, M, R, M, N)
    return c
