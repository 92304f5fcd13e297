"""Wire protocol: Request / Response and compact binary serialization.

Mirrors the reference's coordinator message schema (reference:
common/message.h:— Request{rank,type,dtype,name,root,device,shape,
pre/postscale} and Response{type,names[],dtype,error,devices[],sizes[]},
serialized with FlatBuffers via wire/message.fbs).  Here the codec is a
hand-rolled little-endian struct framing that the C++ core can read
without a schema compiler.
"""

import enum
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


class DataType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10


_NP_TO_DT = {
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.uint16): DataType.UINT16,
    np.dtype(np.int16): DataType.INT16,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.float16): DataType.FLOAT16,
    np.dtype(np.float32): DataType.FLOAT32,
    np.dtype(np.float64): DataType.FLOAT64,
    np.dtype(np.bool_): DataType.BOOL,
}

_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}

_DT_SIZE = {
    DataType.UINT8: 1, DataType.INT8: 1, DataType.UINT16: 2,
    DataType.INT16: 2, DataType.INT32: 4, DataType.INT64: 8,
    DataType.FLOAT16: 2, DataType.FLOAT32: 4, DataType.FLOAT64: 8,
    DataType.BOOL: 1, DataType.BFLOAT16: 2,
}


def _torch_dtype_map():
    import torch
    return {
        torch.uint8: DataType.UINT8, torch.int8: DataType.INT8,
        torch.uint16: DataType.UINT16, torch.int16: DataType.INT16,
        torch.int32: DataType.INT32, torch.int64: DataType.INT64,
        torch.float16: DataType.FLOAT16, torch.float32: DataType.FLOAT32,
        torch.float64: DataType.FLOAT64, torch.bool: DataType.BOOL,
        torch.bfloat16: DataType.BFLOAT16,
    }


def dtype_of(array) -> DataType:
    """Map a torch tensor's (or a numpy array's) dtype to the wire
    DataType.  ``np.dtype(str(torch.float32))`` raises, so torch dtypes
    go through their own table, bf16 included."""
    dt = array.dtype
    if not isinstance(dt, np.dtype):
        table = _torch_dtype_map()
        if dt in table:
            return table[dt]
    name = str(dt)
    if name == "bfloat16":
        return DataType.BFLOAT16
    return _NP_TO_DT[np.dtype(name)]


def dtype_size(dt: DataType) -> int:
    return _DT_SIZE[dt]


def np_dtype(dt: DataType):
    if dt == DataType.BFLOAT16:
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return _DT_TO_NP[dt]


def torch_dtype(dt: DataType):
    """The torch dtype of a wire DataType (inverse of ``dtype_of``)."""
    return {v: k for k, v in _torch_dtype_map().items()}[DataType(dt)]


class RequestType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    REDUCESCATTER = 6
    BARRIER = 7


class ResponseType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    REDUCESCATTER = 6
    BARRIER = 7
    ERROR = 8


@dataclass
class Request:
    request_rank: int
    request_type: RequestType
    tensor_name: str
    tensor_shape: Tuple[int, ...] = ()
    tensor_type: DataType = DataType.FLOAT32
    root_rank: int = -1
    device: int = 0
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    process_set_id: int = 0
    # Horovod reduce op requested ("Sum"/"Average"/"Adasum"/...)
    reduce_op: str = "Sum"
    # Member ranks of the process set (empty = global world).  Carried on
    # the wire so the coordinator knows the required count without a
    # separate registration protocol.
    process_set_ranks: Tuple[int, ...] = ()
    # Grouped-submission id (-1 = ungrouped).  Members of one group are
    # kept atomic by the fusion planner even past the fusion threshold
    # (reference: group_table.{h,cc}, controller.cc:199-223).
    group_id: int = -1
    # Alltoall send splits (dim-0 rows per destination, group order).
    # Carried on the wire so the coordinator can assemble every rank's
    # recv splits into the Response — saving the data plane a full
    # allgather round per uneven alltoall (reference:
    # AlltoallGetRecvSplits, mpi_controller.cc:212-223, which
    # piggybacks the split exchange on negotiation the same way).
    splits: Tuple[int, ...] = ()

    def nbytes(self) -> int:
        n = 1
        for d in self.tensor_shape:
            n *= d
        return n * dtype_size(self.tensor_type)

    def to_bytes(self) -> bytes:
        name_b = self.tensor_name.encode()
        op_b = self.reduce_op.encode()
        shape = self.tensor_shape
        psr = self.process_set_ranks
        spl = self.splits
        head = struct.pack(
            "<iiiiiddiiiHHHH", self.request_rank, int(self.request_type),
            int(self.tensor_type), self.root_rank, self.device,
            self.prescale_factor, self.postscale_factor,
            self.process_set_id, self.group_id, len(shape), len(name_b),
            len(op_b), len(psr), len(spl))
        return (head + struct.pack(f"<{len(shape)}q", *shape) + name_b +
                op_b + struct.pack(f"<{len(psr)}i", *psr) +
                struct.pack(f"<{len(spl)}q", *spl))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Request":
        head_fmt = "<iiiiiddiiiHHHH"
        head_size = struct.calcsize(head_fmt)
        (rank, rtype, dtype, root, device, pre, post, psid, group_id,
         ndim, name_len, op_len, n_psr,
         n_spl) = struct.unpack_from(head_fmt, data)
        off = head_size
        shape = struct.unpack_from(f"<{ndim}q", data, off)
        off += 8 * ndim
        name = data[off:off + name_len].decode()
        off += name_len
        op = data[off:off + op_len].decode()
        off += op_len
        psr = struct.unpack_from(f"<{n_psr}i", data, off)
        off += 4 * n_psr
        spl = struct.unpack_from(f"<{n_spl}q", data, off)
        return cls(request_rank=rank, request_type=RequestType(rtype),
                   tensor_name=name, tensor_shape=tuple(shape),
                   tensor_type=DataType(dtype), root_rank=root,
                   device=device, prescale_factor=pre, postscale_factor=post,
                   process_set_id=psid, reduce_op=op,
                   process_set_ranks=tuple(psr), group_id=group_id,
                   splits=tuple(spl))


@dataclass
class Response:
    response_type: ResponseType
    tensor_names: List[str] = field(default_factory=list)
    tensor_type: DataType = DataType.FLOAT32
    error_message: str = ""
    devices: List[int] = field(default_factory=list)
    # For allgather: per-rank first-dimension sizes; for alltoall: recv
    # splits (reference: message.h Response::tensor_sizes semantics).
    tensor_sizes: List[int] = field(default_factory=list)
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    process_set_id: int = 0
    root_rank: int = -1
    reduce_op: str = "Sum"
    last_joined_rank: int = -1
    # Per-tensor shapes aligned with tensor_names, so joined (departed)
    # ranks can substitute correctly-shaped zeros (JoinOp semantics,
    # reference collective_operations.h:259-276).
    tensor_shapes: List[Tuple[int, ...]] = field(default_factory=list)
    process_set_ranks: Tuple[int, ...] = ()
    # Coordinator-assigned response-cache bit per tensor (aligned with
    # tensor_names; -1 or empty = uncached).  The coordinator owns bit
    # assignment, so workers never have to agree on cache eviction order
    # (unlike the reference, where identical LRU caches are maintained by
    # symmetric bitvector sync — response_cache.h:107-169).
    cache_bits: List[int] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        err_b = self.error_message.encode()
        op_b = self.reduce_op.encode()
        names_b = [n.encode() for n in self.tensor_names]
        psr = self.process_set_ranks
        bits = self.cache_bits
        head = struct.pack(
            "<iiddiiiHIHHHHH", int(self.response_type),
            int(self.tensor_type),
            self.prescale_factor, self.postscale_factor,
            self.process_set_id, self.root_rank, self.last_joined_rank,
            len(names_b), len(self.tensor_sizes), len(err_b), len(op_b),
            len(self.tensor_shapes), len(psr), len(bits))
        parts = [head]
        for nb in names_b:
            parts.append(struct.pack("<H", len(nb)))
            parts.append(nb)
        parts.append(struct.pack(f"<{len(self.tensor_sizes)}q",
                                 *self.tensor_sizes))
        parts.append(err_b)
        parts.append(op_b)
        for shape in self.tensor_shapes:
            parts.append(struct.pack("<H", len(shape)))
            parts.append(struct.pack(f"<{len(shape)}q", *shape))
        parts.append(struct.pack(f"<{len(psr)}i", *psr))
        parts.append(struct.pack(f"<{len(bits)}i", *bits))
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Response":
        head_fmt = "<iiddiiiHIHHHHH"
        (rtype, dtype, pre, post, psid, root, last_joined, n_names,
         n_sizes, err_len, op_len, n_shapes, n_psr,
         n_bits) = struct.unpack_from(head_fmt, data)
        off = struct.calcsize(head_fmt)
        names = []
        for _ in range(n_names):
            (ln,) = struct.unpack_from("<H", data, off)
            off += 2
            names.append(data[off:off + ln].decode())
            off += ln
        sizes = list(struct.unpack_from(f"<{n_sizes}q", data, off))
        off += 8 * n_sizes
        err = data[off:off + err_len].decode()
        off += err_len
        op = data[off:off + op_len].decode()
        off += op_len
        shapes = []
        for _ in range(n_shapes):
            (nd,) = struct.unpack_from("<H", data, off)
            off += 2
            shapes.append(tuple(struct.unpack_from(f"<{nd}q", data, off)))
            off += 8 * nd
        psr = tuple(struct.unpack_from(f"<{n_psr}i", data, off))
        off += 4 * n_psr
        bits = list(struct.unpack_from(f"<{n_bits}i", data, off))
        return cls(response_type=ResponseType(rtype),
                   tensor_type=DataType(dtype), prescale_factor=pre,
                   postscale_factor=post, process_set_id=psid,
                   root_rank=root, last_joined_rank=last_joined,
                   tensor_names=names, tensor_sizes=sizes,
                   error_message=err, reduce_op=op, tensor_shapes=shapes,
                   process_set_ranks=psr, cache_bits=bits)


def pack_request_list(requests: List[Request],
                      shutdown: bool = False) -> bytes:
    parts = [struct.pack("<?I", shutdown, len(requests))]
    for r in requests:
        b = r.to_bytes()
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


def unpack_request_list(data: bytes) -> Tuple[List[Request], bool]:
    shutdown, n = struct.unpack_from("<?I", data)
    off = struct.calcsize("<?I")
    out = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", data, off)
        off += 4
        out.append(Request.from_bytes(data[off:off + ln]))
        off += ln
    return out, shutdown


def pack_response_list(responses: List[Response],
                       shutdown: bool = False) -> bytes:
    parts = [struct.pack("<?I", shutdown, len(responses))]
    for r in responses:
        b = r.to_bytes()
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


def unpack_response_list(data: bytes) -> Tuple[List[Response], bool]:
    shutdown, n = struct.unpack_from("<?I", data)
    off = struct.calcsize("<?I")
    out = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", data, off)
        off += 4
        out.append(Response.from_bytes(data[off:off + ln]))
        off += ln
    return out, shutdown


# ---------------------------------------------------------------------------
# Response-cache fast-path frames.  These replace full request/response
# lists in the steady state (the analog of the reference's bitvector
# cache sync, response_cache.cc:49-87 / controller.cc:81-236): a cache
# bit is 4 bytes on the wire vs ~100 for a full Request/Response.
# ---------------------------------------------------------------------------
def pack_bits(bits: List[int]) -> bytes:
    """CH (worker→coordinator cache hits) / EV (evictions) payload."""
    return struct.pack(f"<I{len(bits)}I", len(bits), *bits)


def unpack_bits(data: bytes) -> List[int]:
    (n,) = struct.unpack_from("<I", data)
    return list(struct.unpack_from(f"<{n}I", data, 4))


def pack_bit_batches(batches: List[List[int]]) -> bytes:
    """CB (coordinator→worker) payload: fused batches of cache bits, in
    execution order.  Each batch maps to ONE fused collective program."""
    parts = [struct.pack("<I", len(batches))]
    for batch in batches:
        parts.append(struct.pack(f"<I{len(batch)}I", len(batch), *batch))
    return b"".join(parts)


def unpack_bit_batches(data: bytes) -> List[List[int]]:
    (nb,) = struct.unpack_from("<I", data)
    off = 4
    out = []
    for _ in range(nb):
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        out.append(list(struct.unpack_from(f"<{n}I", data, off)))
        off += 4 * n
    return out
