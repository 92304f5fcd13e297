"""Shard files: self-checking atomic per-rank payloads.

Format (little-endian)::

    MAGIC (11 bytes) | body_len: u64 | body | sha256(body): 32 bytes

The body is a pickled ``{item_name: object}`` dict (numpy arrays
round-trip bit-exactly through pickle).  The file is written to
``<name>.tmp``, fsynced, and renamed into place, so a final-named
shard is either complete or detectably torn: truncation breaks the
length check, bit rot breaks the sha256 (verified against both the
trailer and the manifest's independent copy).

Counterpart of :mod:`horovod_tpu.checkpoint.shard_io`, copied: the same
bytes on disk, and each package reads the other's shards (see
``_Pickler``).  ``write_shard`` hashes the payload once and writes it
without first joining it to its header and trailer (the reference
hashes it twice and copies it once more), which shortens a final
commit under SIGTERM.
"""

import hashlib
import io
import logging
import os
import pickle
import struct
from typing import Dict, Tuple

from ..common import failpoints as _fp

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

MAGIC = b"HVTPUCKPT1\n"
_LEN = struct.Struct("<Q")

# The JAX package's module path and the port's.  A shard names the
# classes it pickles by module path; the port's shards name RowDelta by
# the JAX package's path, and the port reads a path of either package
# from its own modules.  So the shards of both packages hold the same
# bytes, each package reads the other's, and neither imports the other.
_REFERENCE = "horovod_tpu"
_PORT = "horovod_tpu_torch"
_ROW_DELTA_PATH = (_REFERENCE + ".checkpoint.delta", "RowDelta")


class _Pickler(pickle._Pickler):
    """Protocol-4 pickler that names the port's ``RowDelta`` by the JAX
    package's module path (the C pickler would refuse a path whose
    module it cannot import).  Used only for item dicts that hold a
    ``RowDelta``; its bytes equal the C pickler's for the same names."""

    def save_global(self, obj, name=None):
        from .delta import RowDelta
        if obj is not RowDelta:
            return super().save_global(obj, name)
        module, qualname = _ROW_DELTA_PATH
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads a class of the JAX package from the port's same module."""

    def find_class(self, module, name):
        if module == _REFERENCE or module.startswith(_REFERENCE + "."):
            module = _PORT + module[len(_REFERENCE):]
        return super().find_class(module, name)


class CheckpointCorruptError(RuntimeError):
    """A shard or manifest failed validation (torn write, bit rot,
    checksum mismatch).  Restore treats the whole step as invalid and
    falls back to the previous committed one."""


def serialize_items(items: Dict[str, object],
                    rank: int = None) -> bytes:
    """Pickle the shard's item dict.  Failpoint ``ckpt.serialize``
    models serialization stalls/failures (a leaf that stopped being
    picklable, host memory pressure).  ``rank`` is the checkpoint
    rank, passed explicitly because the save pipeline runs on a writer
    thread where ambient rank context may be absent (thread-per-rank
    harnesses)."""
    if _fp.ENABLED:
        _fp.maybe_fail("ckpt.serialize", rank=rank)
    from .delta import RowDelta
    buf = io.BytesIO()
    if any(isinstance(v, RowDelta) for v in items.values()):
        _Pickler(buf, protocol=4).dump(items)
    else:
        pickle.dump(items, buf, protocol=4)
    return buf.getvalue()


def write_shard(path: str, payload: bytes,
                rank: int = None) -> Tuple[str, int]:
    """Write one shard atomically; returns ``(sha256_hex, nbytes)``.

    Failpoint sites:

    * ``ckpt.shard_write`` — before anything hits disk: ``error()`` /
      ``crash()`` model a rank dying mid-checkpoint (the temp file, if
      any, never gets renamed; the commit arbiter never sees the
      prepare mark; the step stays uncommitted).
    * ``ckpt.shard_write.torn`` — ``drop()`` writes HALF the body to
      the FINAL name and reports success: a torn write on non-atomic
      storage (object-store multipart upload died, NFS close-to-open
      races).  The checksum machinery must catch it at restore.
    """
    # One sha256 pass and no concatenated copy of the payload: the bytes
    # on disk are the reference's, written piece by piece.
    sha = hashlib.sha256(payload)
    digest = sha.hexdigest()
    head, trailer = MAGIC + _LEN.pack(len(payload)), sha.digest()
    nbytes = len(head) + len(payload) + len(trailer)
    if _fp.ENABLED:
        _fp.maybe_fail("ckpt.shard_write", rank=rank)
        if _fp.maybe_fail("ckpt.shard_write.torn", rank=rank) == "drop":
            body = head + payload + trailer
            with open(path, "wb") as f:
                f.write(body[:max(len(body) // 2, len(MAGIC) + 8)])
                f.flush()
                os.fsync(f.fileno())
            logger.warning("failpoint ckpt.shard_write.torn: wrote "
                           "torn shard %s", path)
            return digest, nbytes
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for piece in (head, payload, trailer):
            f.write(piece)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return digest, nbytes


def read_shard(path: str, expect_sha256: str = None
               ) -> Dict[str, object]:
    """Read + validate one shard; raises
    :class:`CheckpointCorruptError` on any mismatch."""
    if _fp.ENABLED:
        _fp.maybe_fail("ckpt.restore")
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointCorruptError("shard %s unreadable: %s"
                                     % (path, e))
    if not blob.startswith(MAGIC):
        raise CheckpointCorruptError("shard %s: bad magic" % path)
    off = len(MAGIC)
    if len(blob) < off + _LEN.size:
        raise CheckpointCorruptError("shard %s: truncated header"
                                     % path)
    (body_len,) = _LEN.unpack_from(blob, off)
    off += _LEN.size
    if len(blob) < off + body_len + 32:
        raise CheckpointCorruptError(
            "shard %s: truncated (want %d body bytes, have %d)"
            % (path, body_len, len(blob) - off - 32))
    payload = blob[off:off + body_len]
    trailer = blob[off + body_len:off + body_len + 32]
    digest = hashlib.sha256(payload)
    if digest.digest() != trailer:
        raise CheckpointCorruptError("shard %s: sha256 trailer "
                                     "mismatch" % path)
    if expect_sha256 is not None and digest.hexdigest() != expect_sha256:
        raise CheckpointCorruptError(
            "shard %s: manifest checksum mismatch" % path)
    try:
        items = _Unpickler(io.BytesIO(payload)).load()
    except Exception as e:
        raise CheckpointCorruptError("shard %s: unpicklable payload: "
                                     "%r" % (path, e))
    if not isinstance(items, dict):
        raise CheckpointCorruptError("shard %s: payload is %s, not a "
                                     "dict" % (path, type(items)))
    return items
